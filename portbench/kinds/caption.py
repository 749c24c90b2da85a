r"""
Driver of the ``caption`` traffic kind: the program's caption call
(``engine/captioner.py make_caption_fn`` with the decoder of
``factories.CaptionDecoderFactory``) over its model
(``PretrainingModelFactory``) in eval mode, in a closed loop, one batch at
a time, as ``scripts/eval_captioning.py`` runs it.

The weights are drawn from the seed; the BatchNorm running statistics are
each layer's batch statistics over calibration images drawn from the seed
(``checks.calibration``), so that evaluation normalises as a trained
model's does. That calibration is the reference's work: its seconds are
left out of ``setup_s``. Set-up captions two batches. In the window
each batch is timed from the start of its caption call to its tokens on
the host: ``caption_images_per_s`` is the images captioned over the
window's seconds (the batches' median and 95th percentile are printed
beside it). After the window the reference checks a sample of the
served batches drawn from the seed (``checks.caption_gaps``).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import checks, inputs, trace
from portbench.kinds import common

WARMUP_BATCHES = 2  # cuDNN's autotuning of the eval shapes, the decode's
CHECK_BATCHES = 4   # served batches the reference reads


class Session:
    def __init__(self, run):
        from virtex_tpu_torch.config import ModelSpec
        from virtex_tpu_torch.engine.captioner import make_caption_fn
        from virtex_tpu_torch.factories import CaptionDecoderFactory
        self.run = run
        cfg = run.config
        spec = ModelSpec.from_config(cfg)
        self.device = torch.device(run.device)
        common.set_backend_flags(cfg)
        self.model = common.build_model(cfg, self.device)
        self.shapes = common.parameter_shapes(self.model)
        weights = inputs.draw_weights(self.shapes, run.seed, self.device)
        t_cal = time.perf_counter()
        weights.update(checks.calibration(weights, run, self.device))
        common.sync(self.device)
        self.calibration_s = time.perf_counter() - t_cal
        common.load_weights(self.model, weights)
        del weights
        self.model.eval()
        self.caption_fn = make_caption_fn(
            self.model, CaptionDecoderFactory.from_spec(spec),
            spec.sos_index, spec.prefix_mode)
        t = run.traffic
        self.batch = int(t["batch"])
        self.pool = [pool_images(run, i, self.device)
                     for i in range(int(t["pool_batches"]))]
        self.k = 0
        self.served = {}  # pool index → its last captions, on the host

    def unit(self):
        """One batch of the pool captioned; its tokens on the host."""
        index = self.k % len(self.pool)
        self.k += 1
        self.served[index] = self.caption_fn(self.pool[index]).cpu()
        return self.served[index]

    def traced(self, units: int) -> trace.Trace:
        spans = trace.Spans()
        handles = spans.hook(self.model.visual, "visual")

        def run_units(n):
            for _ in range(n):
                with spans.span("caption"):
                    self.unit()
        try:
            return trace.profile("caption", run_units, units, self.batch,
                                 self.device, {})
        finally:
            for h in handles:
                h.remove()


def pool_images(run, index: int, device) -> torch.Tensor:
    cfg = run.config_file["config"]
    return inputs.images(run.seed, index, int(run.traffic["batch"]),
                         cfg["DATA"]["IMAGE_CROP_SIZE"], device)


def run(run) -> dict:
    t = run.traffic
    s = Session(run)
    for _ in range(WARMUP_BATCHES):
        s.unit()
    common.sync(s.device)
    setup_s = time.time() - run.t_start - s.calibration_s
    print(f"set-up {setup_s:.3f} s, of it building kernels "
          f"{common.build_seconds():.3f} s; the reference's calibration "
          f"{s.calibration_s:.3f} s left out", flush=True)

    times, n, window, traced = common.window(run, s, int(t["trace_units"]))
    device = common.device_info(s.device)
    timed = np.array(times)
    served = s.served
    eos = run.config_file["config"]["DATA"]["EOS_INDEX"]
    ended = sum(int((c == eos).any(dim=1).sum()) for c in served.values())
    print(f"window {window:.3f} s, {n} batches, batch ms median "
          f"{np.median(timed) * 1e3:.3f}, 95th percentile "
          f"{np.percentile(timed, 95) * 1e3:.3f}; of the last captions of "
          f"each pool batch, {ended} of {len(served) * s.batch} hold EOS",
          flush=True)

    shapes, dev = s.shapes, s.device
    del s
    common.free(dev)
    t_check = time.perf_counter()
    gap = check(run, served, shapes, dev)
    print(f"check {time.perf_counter() - t_check:.3f} s", flush=True)
    return {"end_to_end": {
                "caption_images_per_s": n * int(t["batch"]) / window,
                "setup_s": setup_s},
            "trace": traced, "attempted": n * int(t["batch"]), "failed": 0,
            "device": device,
            "checks": [("caption_gap", gap, run.limits["caption_gap"])]}


def check(run, served: dict, shapes, device) -> float:
    """The widest caption gap over a sample of the served batches (the
    pool indices the window served, ``CHECK_BATCHES`` of them drawn from
    the seed)."""
    w = inputs.draw_weights(shapes, run.seed, device)
    w.update(checks.calibration(w, run, device))
    gen = inputs.generator(run.seed, "sample", 0, "cpu")
    indices = sorted(served)
    pick = torch.randperm(len(indices), generator=gen)[
        :CHECK_BATCHES].tolist()
    worst = 0.0
    for i in sorted(indices[j] for j in pick):
        gaps = checks.caption_gaps(run, w, pool_images(run, i, device),
                                   served[i], device)
        worst = max(worst, float(gaps.max()))
        print(f"caption gap, batch {i}: widest {float(gaps.max()):.4f} "
              f"nats; {int((gaps > 0).sum())} of {gaps.numel()} captions "
              "hold a token outside the bound", flush=True)
    return worst

