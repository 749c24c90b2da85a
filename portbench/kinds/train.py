r"""
Driver of the ``train`` traffic kind: the program's train step
(``engine/trainer.py make_train_step``) over its model and optimizer
(``factories.PretrainingModelFactory``, ``OptimizerFactory``), driven back
to back on batches made on the device from the seed, as
``scripts/pretrain_virtex.py`` composes them: the dropout generator
reseeded every update, no checkpointing, no validation.

Set-up builds that one object, resumes its optimizer at the traffic's
``start_iteration`` through the optimizer's own ``load_state_dict``, and
drives it through its first three updates (which the reference follows,
``checks.py``) and two more; the window then takes the same object on.
``train_images_per_s``: the images of every update the window launched,
over the window's seconds, which end once the device has finished them.
With ``--trace 1`` a stretch of
``trace_units`` updates inside the window runs under the profiler, with
spans around the visual and textual forwards, the optimizer step and the
train-step call.
"""
from __future__ import annotations

import time

import torch

from portbench import checks, inputs, trace, yardstick
from portbench.kinds import common

WARMUP_STEPS = 2  # after the checked ones: cuDNN has tuned every shape


class Session:
    """The program's train step with its model, optimizer and batches."""

    def __init__(self, run):
        from virtex_tpu_torch.engine.trainer import make_train_step
        from virtex_tpu_torch.factories import OptimizerFactory
        self.run = run
        cfg = run.config
        self.device = torch.device(run.device)
        common.set_backend_flags(cfg)
        self.model = common.build_model(cfg, self.device)
        self.shapes = common.parameter_shapes(self.model)
        common.load_weights(self.model, inputs.draw_weights(
            self.shapes, run.seed, self.device))
        self.optimizer = OptimizerFactory.from_config(
            cfg, self.model.named_parameters())
        state = self.optimizer.state_dict()
        state["step_count"] = state["lookahead_count"] = int(
            run.traffic["start_iteration"])
        self.optimizer.load_state_dict(state)
        self.accum = int(cfg.OPTIM.GRAD_ACCUM_STEPS)
        self.generator = torch.Generator(device=self.device)
        self.step_fn = make_train_step(self.model, self.optimizer,
                                       self.accum, generator=self.generator)
        lengths = inputs.caption_lengths(
            run.traffic["caption_length_counts"])
        if len(lengths) != int(cfg.OPTIM.BATCH_SIZE):
            raise ValueError("the traffic's caption lengths must number "
                             "OPTIM.BATCH_SIZE")
        self.lengths = lengths
        self.pool = [self._shape(checks.train_batch(run, i, self.device))
                     for i in range(int(run.traffic["pool_batches"]))]
        self.k = 0
        d = checks.dims_of(run.config_file["config"])
        self.flops = yardstick.bicaptioning_train_flops(
            cfg.DATA.IMAGE_CROP_SIZE, lengths,
            (cfg.DATA.IMAGE_CROP_SIZE // 32) ** 2,
            int(cfg.MODEL.VISUAL.FEATURE_SIZE), d.hidden, d.feedforward,
            int(cfg.DATA.VOCAB_SIZE), d.layers)

    def _shape(self, batch):
        if self.accum == 1:
            return batch
        return {k: v.reshape((self.accum, v.shape[0] // self.accum)
                             + v.shape[1:]) for k, v in batch.items()}

    def unit(self):
        """One update of batch ``k`` of the pool, dropout from its seed."""
        self.generator.manual_seed(
            inputs.derive(self.run.seed, "dropout", self.k))
        out = self.step_fn(self.pool[self.k % len(self.pool)])
        self.k += 1
        return out

    def first_steps(self, n: int) -> dict:
        """The checked updates: each loss and global gradient norm; the
        momentum trace after the first and the parameters after the last,
        on the host."""
        opt = self.optimizer
        losses, norms, trace1 = [], [], {}
        for i in range(n):
            out = self.unit()
            losses.append(float(out["loss"]))
            norms.append(float(out["grad_norm"]))
            if i == 0:
                trace1 = {name: t.detach().to("cpu", copy=True)
                          for name, t in zip(opt.names, opt.trace)}
        params = {name: p.detach().to("cpu", copy=True)
                  for name, p in zip(opt.names, opt.params)}
        return {"losses": losses, "norms": norms, "trace1": trace1,
                "params": params}

    def traced(self, units: int) -> trace.Trace:
        from virtex_tpu_torch.modules.normalization import (
            SubsampledBatchNorm,
        )
        from virtex_tpu_torch.modules.transformer import MultiHeadAttention
        spans = trace.Spans()
        bn_inputs, attention = [], []
        handles = spans.hook(self.model.visual, "visual")
        handles += spans.hook(self.model.textual, "textual")
        handles += spans.hook(self.model.backward_textual,
                              "backward_textual")
        for m in self.model.modules():
            if isinstance(m, SubsampledBatchNorm):
                handles.append(m.register_forward_pre_hook(
                    lambda mod, a: bn_inputs.append(tuple(a[0].shape))))
            elif isinstance(m, MultiHeadAttention):
                handles.append(m.register_forward_pre_hook(
                    lambda mod, a: attention.append(_attention_call(mod, a))))
        optimizer = self.optimizer
        plain_step = optimizer.step

        def step():
            with spans.span("optimizer"):
                return plain_step()
        optimizer.step = step

        def run_units(n):
            for _ in range(n):
                with spans.span("train_step"):
                    self.unit()
        try:
            facts = {"bn_inputs": bn_inputs, "attention_calls": attention,
                     "model_flops": units * self.flops}
            return trace.profile("train", run_units, units,
                                 len(self.lengths), self.device, facts)
        finally:
            del optimizer.step
            for h in handles:
                h.remove()


def _attention_call(mha, args):
    """(B, Tq, Tk, N, D, mask elements) of one attention forward."""
    q_in, kv_in = args[0], args[1]
    mask = args[2] if len(args) > 2 else None
    N = mha.num_heads
    return (q_in.shape[0], q_in.shape[1], kv_in.shape[1], N,
            mha.hidden_size // N, 0 if mask is None else mask.numel())


def run(run) -> dict:
    t = run.traffic
    s = Session(run)
    prog = s.first_steps(checks.CHECKED_STEPS)
    for _ in range(WARMUP_STEPS):
        s.unit()
    common.sync(s.device)
    setup_s = time.time() - run.t_start
    print(f"set-up {setup_s:.3f} s, of it building kernels "
          f"{common.build_seconds():.3f} s", flush=True)

    _, n, window, traced = common.window(run, s, int(t["trace_units"]))
    device = common.device_info(s.device)
    print(f"window {window:.3f} s, {n} updates", flush=True)

    shapes, dev, images = s.shapes, s.device, len(s.lengths)
    del s
    common.free(dev)
    t_check = time.perf_counter()
    readings = check(run, shapes, prog, dev)
    print(f"check {time.perf_counter() - t_check:.3f} s", flush=True)
    return {"end_to_end": {"train_images_per_s": n * images / window,
                           "setup_s": setup_s},
            "trace": traced, "attempted": n, "failed": 0, "device": device,
            "checks": checks.compared(readings, run.limits)}


def check(run, shapes, prog: dict, device) -> dict:
    """The readings of the program's checked updates against the
    reference's; prints them, the global gradient norms beside the clip
    and the updates that landed Lookahead."""
    refr = checks.train_reference(run, shapes, device,
                                  steps=len(prog["losses"]))
    w0 = inputs.draw_weights(shapes, run.seed, device)
    first, change = checks.program_norms(run, w0, prog["trace1"],
                                         prog["params"])
    del w0
    readings = checks.train_readings(
        {"losses": prog["losses"], "first": first, "change": change}, refr)
    clip = run.config_file["config"]["OPTIM"]["CLIP_GRAD_NORM"]
    print(f"losses: program {prog['losses']}, reference {refr['losses']}; "
          f"gradient norms before the clip at {clip}: program "
          f"{prog['norms']}, reference {refr['norms']}; Lookahead landed "
          f"at updates {[i + 1 for i, s in enumerate(refr['syncs']) if s]}",
          flush=True)
    for k, v in readings.items():
        print(f"{k} {v[0]:.4e} ({v[1]})", flush=True)
    return readings
