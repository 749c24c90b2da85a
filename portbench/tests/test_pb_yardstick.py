r"""
The yardstick's frozen arithmetic against counts worked by hand at small
shapes, and the trace reader on a hand-made trace.
"""
from __future__ import annotations

import pytest
import torch

from portbench import trace, yardstick as y


def test_attention_bound_by_hand():
    # B 2, Tq 3, Tk 4, one head of 8, bf16: q 96 bytes, k and v 128 each,
    # a (2, 1, 3, 4) bool mask 24 bytes.
    t, by = y.attention_bound(2, 3, 4, 1, 8, 24, backward=False)
    assert by == "bytes" and t == pytest.approx(
        (96 + 2 * 128 + 96 + 24) / y.HBM_BYTES_PER_S)
    t, by = y.attention_bound(2, 3, 4, 1, 8, 24, backward=True)
    assert t == pytest.approx((2 * 96 + 4 * 128 + 96 + 24) / y.HBM_BYTES_PER_S)
    # operations: 2 (5) products of 2·B·N·Tq·Tk·D = 384 FLOPs
    big = y.attention_bound(1, 128, 128, 1, 128, 0, backward=False)
    assert big == (pytest.approx(max(
        (4 * 128 * 128 * 2) / y.HBM_BYTES_PER_S,
        2 * 2 * 128 * 128 * 128 / y.BF16_FLOPS)), big[1])


def test_k4_bound_by_hand():
    # One BatchNorm input (B 2, C 8, 2×2): M 8. Stage 1 reads dy and x in
    # bf16 (2 · 8 · 8 · 2 = 256 bytes), mean and rstd (64) and writes the
    # (2, 8) fp32 sums (64); stage 2 reads dy and x, writes dx (384) and
    # reads mean, rstd, weight and the sums (160). Both are bound by bytes.
    assert y.k4_sums_bound(8, 8) == (pytest.approx(384 / y.HBM_BYTES_PER_S),
                                     "bytes")
    assert y.k4_dx_bound(8, 8) == (pytest.approx(544 / y.HBM_BYTES_PER_S),
                                   "bytes")
    assert y.k4_bound_s([(2, 8, 2, 2)]) == pytest.approx(
        928 / y.HBM_BYTES_PER_S)


def test_decoder_flops_by_hand():
    # L 2 tokens, 1 visual token of 4 channels, H 2, F 3, vocabulary 5, one
    # layer: projection 8 MACs; per layer q/k/v 24, scores and context 12,
    # self out 8, cross q 8, cross k/v 8, cross scores and context 8, cross
    # out 8, FFN 24; logits 20. 128 MACs.
    assert y.decoder_forward_flops(2, 1, 4, 2, 3, 5, 1) == 256


def test_resnet50_flops_against_the_programs_convolutions():
    """Every convolution of the program's ResNet-50 at 64², counted by
    hooks, and the published 4.09 GMACs at 224² (torchvision's count,
    whose classifier adds 2 M)."""
    from virtex_tpu_torch.modules.resnet import make_resnet
    net = make_resnet("resnet50", dtype=torch.float32)
    macs = []

    def hook(mod, args, out):
        k = mod.weight.shape
        macs.append(out[0].numel() * k[1] * k[2] * k[3])
    for m in net.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(hook)
    with torch.no_grad():
        net.eval()(torch.zeros(1, 64, 64, 3))
    assert y.resnet50_forward_flops(64) == 2 * sum(macs)
    assert y.resnet50_forward_flops(224) / 2 == pytest.approx(4.09e9,
                                                              rel=0.01)


def test_train_flops_are_three_forwards():
    one = y.resnet50_forward_flops(224) + 2 * y.decoder_forward_flops(
        13, 49, 2048, 1024, 4096, 10000, 1)
    assert y.bicaptioning_train_flops(224, [13], 49, 2048, 1024, 4096,
                                      10000, 1) == 3 * one


def _event(cat, name, ts, dur=0.0, tid=1, corr=None):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_trace_attributes_kernels_to_spans():
    events = [
        _event("user_annotation", "pb::train_step", 0, 300),
        _event("user_annotation", "pb::visual", 0, 100),
        _event("cuda_runtime", "cudaLaunchKernel", 50, 2, corr=7),
        _event("kernel", "bn_sums_vec", 60, 30, tid=9, corr=7),
        _event("cuda_runtime", "cudaLaunchKernel", 150, 2, corr=8),
        _event("kernel", "gemm", 200, 10, tid=9, corr=8),
        _event("cuda_runtime", "cudaLaunchKernel", 150, 2, tid=2, corr=9),
        _event("kernel", "other", 205, 10, tid=9, corr=9),
    ]
    t = trace.Trace("train", 1, 256, 300e-6, events, {})
    assert t.device_s("visual") == pytest.approx(30e-6)
    assert t.device_s("train_step") == pytest.approx(40e-6)  # tid 1 only
    assert t.device_s(names=("bn_sums",)) == pytest.approx(30e-6)
    assert t.busy_s == pytest.approx(45e-6)
    assert t.idle_share() == pytest.approx(100 * (1 - 45 / 300))
    assert t.span_s("visual") == pytest.approx(100e-6)
    gaps = t.breakdown()["idle_gaps"]
    assert gaps[0] == ["train_step", pytest.approx(110e-6)]
    empty = trace.Trace("train", 1, 256, 1.0, [], {})
    assert empty.device_s() is None and empty.idle_share() is None


def test_busy_union():
    events = [_event("kernel", "k", a, b - a, corr=i)
              for i, (a, b) in enumerate([(0, 10), (5, 15), (20, 25)])]
    assert trace.Trace("train", 1, 1, 1.0, events, {}).busy_s == \
        pytest.approx(20e-6)
