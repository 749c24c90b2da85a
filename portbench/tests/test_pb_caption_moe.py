r"""
The ``caption_moe`` kind on the CPU at a tiny size, end to end through the
harness (ResNet-50 at 64², the program's ``tiny`` latent-attention,
routed-expert preset at 3 layers, a vocabulary of 64, 2 images a batch,
beam 3, 6 steps), and the three readers of its cell on hand-made traces:
``prefill_ms.caption_moe`` from the program's spans,
``expert_ms.caption_moe`` and ``expert_roofline.caption_moe`` from the
kernels' names and the program's ``moe_experts`` notes.
"""
from __future__ import annotations

import copy
import json
import os
import shutil
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import harness, moe_yardstick as my, trace, yardstick as y
from portbench.tests.test_pb_harness import REPO, SEED
from virtex_tpu_torch.utils import tracing

PKG = os.path.join(REPO, "portbench")
CELL = "caption.kimivl_a3b.beam"
METRICS = ("prefill_ms.caption_moe", "expert_ms.caption_moe",
           "expert_roofline.caption_moe")
KERNEL = ("void cutlass::device_kernel<at::cuda::detail::enable_3x_kernel_"
          "for_sm90_or_later<cutlass::gemm::kernel::GemmUniversal<cutlass::"
          "gemm::GroupProblemShape<cute::tuple<int, int, int> >>>>(...)")
# the program's "tiny" preset, under the model's config.json keys
TINY = {"hidden_size": 32, "num_hidden_layers": 3, "num_attention_heads": 2,
        "kv_lora_rank": 16, "qk_nope_head_dim": 8, "qk_rope_head_dim": 8,
        "v_head_dim": 8, "rope_theta": 10000.0, "intermediate_size": 48,
        "moe_intermediate_size": 16, "n_routed_experts": 8,
        "num_experts_per_tok": 3, "n_shared_experts": 2,
        "first_k_dense_replace": 1, "routed_scaling_factor": 2.446,
        "rms_norm_eps": 1e-5, "vocab_size": 64}


def _load(*parts):
    with open(os.path.join(PKG, *parts), encoding="utf-8") as f:
        return json.load(f)


def _dump(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=1)


def write_root(root: str, limit: float = 0.5) -> str:
    bench = _load("..", "BENCHMARK.json")
    (entry,) = [c for c in bench["configs"]
                if c["name"] == "captioning_R_50_KimiVL_A3B_L9"]
    cfg = copy.deepcopy(_load("..", entry["file"]))
    cfg.update(TINY)
    c = cfg["config"]
    c["DATA"].update(IMAGE_CROP_SIZE=64, VOCAB_SIZE=64, MAX_CAPTION_LENGTH=6)
    c["MODEL"]["TEXTUAL"]["NAME"] = "moe_mla::tiny_L3"
    c["MODEL"]["DECODER"].update(BEAM_SIZE=3, MAX_DECODING_STEPS=6)
    bench["configs"] = [{**entry, "file": "portbench/configs/tiny_moe.json"}]
    (cell,) = [w for w in bench["workloads"] if w["name"] == CELL]
    bench["workloads"] = [{**cell, "traffic": "tiny_caption_moe"}]
    bench["end_to_end"] = [m for m in bench["end_to_end"]
                           if CELL in m.get("workloads", [CELL])]
    bench["per_layer"] = [m for m in bench["per_layer"]
                          if CELL in m["workloads"]]
    _dump(os.path.join(root, "BENCHMARK.json"), bench)
    _dump(os.path.join(root, "portbench", "configs", "tiny_moe.json"), cfg)
    traffic = _load("traffic", "caption_moe_beam_b256.json")
    traffic.update(batch=2, pool_batches=2, trace_units=1, check_batches=1)
    _dump(os.path.join(root, "portbench", "traffic", "tiny_caption_moe.json"),
          traffic)
    _dump(os.path.join(root, "portbench", "limits", f"{CELL}.json"),
          {"caption_gap": limit})
    shutil.copytree(os.path.join(PKG, "metrics"),
                    os.path.join(root, "portbench", "metrics"),
                    ignore=shutil.ignore_patterns("__pycache__"),
                    dirs_exist_ok=True)
    return root


def test_the_cell_and_its_metrics_are_entries_of_the_benchmark():
    bench = _load("..", "BENCHMARK.json")
    (cell,) = [w for w in bench["workloads"] if w["name"] == CELL]
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    (e2e,) = [m for m in bench["end_to_end"]
              if m["name"] == "caption_images_per_s"]
    assert e2e["workloads"] == ["caption.r50h2048.beam", CELL]
    for name in METRICS:
        (m,) = [m for m in bench["per_layer"] if m["name"] == name]
        assert m["workloads"] == [CELL]
        assert m["moves"] == "caption_images_per_s"
    cfg = _load("..", "portbench", "configs",
                "captioning_R_50_KimiVL_A3B_L9.json")
    assert cfg["num_hidden_layers"] == 9 and cfg["hidden_size"] == 2048
    assert cfg["config"]["MODEL"]["TEXTUAL"]["NAME"] == \
        "moe_mla::kimi_vl_a3b_L9"


@pytest.mark.parametrize("traced", [0, 1])
def test_a_tiny_run_end_to_end(tmp_path, traced):
    root = write_root(str(tmp_path))
    out = harness.run(["--workload", CELL, "--seed", str(SEED), "--seconds",
                       "0.5", "--trace", str(traced)], device="cpu",
                      root=root)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"caption_gap"}
    assert 0.0 <= out["checks"]["caption_gap"]["value"] <= 0.5
    if traced:
        # device time is the card's: on the CPU no reader finds any
        assert not set(out["metrics"]) & set(METRICS)
    else:
        assert out["metrics"]["caption_images_per_s"]["value"] > 0
        assert out["metrics"]["setup_s"]["value"] > 0


def test_a_limit_below_the_reading_fails(tmp_path):
    root = write_root(str(tmp_path), limit=-1.0)
    out = harness.run(["--workload", CELL, "--seed", str(SEED), "--seconds",
                       "0.2", "--trace", "0"], device="cpu", root=root)
    assert not out["correct"]


def test_the_bound_by_hand():
    # 10 tokens, 2 experts each, of 4 experts 8 wide at H 16, bf16
    t, by = my.expert_bound(10, 2, 4, 16, 8, "gate_up")
    assert by == "bytes"
    assert t == pytest.approx((4 * 16 * 8 * 2 + 20 * 16 + 20 * 16) * 2
                              / y.HBM_BYTES_PER_S)
    t, _ = my.expert_bound(10, 2, 4, 16, 8, "down")
    assert t == pytest.approx((4 * 16 * 8 + 20 * 8 + 20 * 16) * 2
                              / y.HBM_BYTES_PER_S)
    # the cell's decode launch: the weights dominate
    gu = my.expert_bound(1280, 6, 64, 2048, 1408, "gate_up")
    assert gu[1] == "bytes" and gu[0] == pytest.approx(
        (64 * 2048 * 2816 + 7680 * 2048 + 7680 * 2816) * 2
        / y.HBM_BYTES_PER_S)
    # the prefill's: 12,544 tokens, bound by operations
    assert my.expert_bound(12544, 6, 64, 2048, 1408, "gate_up")[1] == \
        "operations"
    with pytest.raises(ValueError):
        my.expert_bound(1, 1, 1, 1, 1, "up")


def _noted(*shapes, spans=()):
    with tracing.span("between sessions"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("caption"):
            for name in spans:
                with tracing.span(name):
                    pass
            for s in shapes:
                tracing.note("moe_experts", s)


def _stretch(launches=2, name=KERNEL, kind="caption", dur=4.0):
    events = [{"cat": "kernel", "name": name, "ts": 10.0 * i, "dur": dur,
               "args": {}} for i in range(launches)]
    events.append({"cat": "kernel", "name": "other", "ts": 0.0, "dur": 5.0,
                   "args": {}})
    return trace.Trace(kind, 1, 2, 1.0, events, {})


def _read(name, t):
    return harness.read_metric(name, t, REPO)


def test_the_expert_readers():
    shape = (1280, 6, 64, 2048, 1408, "gate_up")
    _noted(shape, shape)
    t = _stretch(dur=5000.0)
    assert _read("expert_ms.caption_moe", t) == pytest.approx(10.0)
    want = 100.0 * 2 * my.expert_bound(*shape)[0] / 0.01
    assert _read("expert_roofline.caption_moe", t) == pytest.approx(want)
    assert 0 < want < 100


def test_the_expert_readers_read_nothing_where_they_should(monkeypatch):
    shape = (8, 6, 64, 2048, 1408, "down")
    _noted(shape)
    assert _read("expert_roofline.caption_moe", _stretch(2)) is None
    assert _read("expert_ms.caption_moe", _stretch(0)) is None
    assert _read("expert_ms.caption_moe", _stretch(kind="train")) is None
    _noted()
    assert _read("expert_roofline.caption_moe", _stretch(1)) is None
    _noted(shape)
    monkeypatch.setitem(sys.modules, "virtex_tpu_torch.utils.tracing", None)
    assert _read("expert_roofline.caption_moe", _stretch(1)) is None


def test_the_prefill_reader_needs_the_programs_spans():
    _noted(spans=("prefill",))
    t = _stretch()
    # the store's spans hold no CUDA events on the CPU: no device time
    assert _read("prefill_ms.caption_moe", t) is None
    assert _read("prefill_ms.caption_moe", _stretch(kind="train")) is None


def test_the_reference_takes_a_given_choice_only_at_a_near_tie():
    from portbench.reference import latent_moe as ref
    biased = torch.tensor([[0.50, 0.40, 0.399, 0.10],
                           [0.50, 0.40, 0.30, 0.10],
                           [0.50, 0.40, 0.30, 0.10],
                           [0.50, 0.40, 0.30, 0.10]])
    own = biased.topk(2).indices
    given = torch.tensor([[0, 2], [0, 2], [1, 0], [-1, -1]])
    choice, cost = ref.near_ties(biased, own, given, tie=0.01)
    # row 0 swaps expert 1 for 2 at a cost of 0.001: taken; row 1 at 0.1:
    # refused; row 2 the same set; row 3 gives none
    assert choice[0].tolist() == [0, 2]
    assert sorted(choice[1].tolist()) == [0, 1]
    assert sorted(choice[2].tolist()) == [0, 1]
    assert sorted(choice[3].tolist()) == [0, 1]
    assert cost[0].item() == pytest.approx(0.001, abs=1e-6)
    assert cost[1].item() == pytest.approx(0.1, abs=1e-6)
    assert cost[2].item() == float("-inf") and cost[3].isnan()


def test_the_replay_hands_over_the_routing_of_the_served_captions(tmp_path):
    from portbench.kinds import caption_moe
    root = write_root(str(tmp_path))
    run = harness.resolve(harness.parse(["--workload", CELL, "--seed",
                                         str(SEED), "--seconds", "1"]),
                          root, "cpu", 0.0)
    s = caption_moe.Session(run)
    images = s.pool[0]
    captions = s.caption_fn(images).cpu()
    routing, own = caption_moe.program_routing(s, images, captions)
    assert own == 0.0
    d = s.model.textual.dims
    assert routing[0] is None                      # the dense layer
    P, steps = 4, captions.shape[1]                # a 2×2 grid at 64²
    for r in routing[1:]:
        assert r.shape == (2, P + steps, d.num_experts_per_tok)
        assert (r[:, P:] >= 0).all()
    assert (routing[-1][:, :P] == -1).all()        # no FFN in the prefill
    assert (routing[1][:, :P] >= 0).all()
    # the reference given the program's choice reads the same gaps as
    # with none where the two agree (fp32 at this size)
    w = caption_moe.reference_weights(run, s.shapes, "cpu")
    given = caption_moe.token_gaps(run, w, images, captions, "cpu", routing)
    alone = caption_moe.token_gaps(run, w, images, captions, "cpu")
    assert torch.equal(given, alone)
