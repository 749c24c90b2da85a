"""The port's launch seam (``virtex_tpu_torch/ops/_launch.py``): one count
by (kernel, variant) and one reset, the capture scope a CUDA graph's
capturer opens, and the replays that count and note what it recorded.

On the CPU the seam launches a stand-in C function that returns 0 (or the
error code it is passed). The ``cuda`` case launches K1, K2 and the decode
attention in one process at shapes that need more than 48 KB of shared
memory, each opted in by the shared helper of ``csrc/launch_common.cuh``;
it skips elsewhere. Run it on the card with ``python -m pytest
tests/test_torch_launch.py -m cuda --noconftest``.
"""
import ctypes
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from virtex_tpu_torch.ops import _build
from virtex_tpu_torch.ops import _launch as L
from virtex_tpu_torch.ops import attention as A
from virtex_tpu_torch.ops import decode_attention as DA
from virtex_tpu_torch.utils import tracing

SHAPE = (1280, 256, 30, 32, 64)  # a decode attention's note


@pytest.fixture
def stand_in(monkeypatch):
    """The library as one C function, ``virtex_stand_in(int) -> int``,
    that returns the error code it is given and keeps the arguments and
    the stream it was called with; the stream is 7 on the CPU."""
    calls = []

    @ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
    def stand_in_fn(err, stream):
        calls.append((err, stream))
        return err

    lib = types.SimpleNamespace(
        virtex_stand_in=stand_in_fn,
        virtex_cuda_error_string=lambda err: b"stand-in error")
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 7, raising=False)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    L.reset()
    yield calls
    L.reset()


def _launch(key, note=None):
    L.launch(key, "virtex_stand_in", torch.zeros(1), 0, note=note)


def _profiled(fn):
    with tracing.span("between sessions"):  # a store of its own
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        fn()


def test_launches_are_counted_by_kernel_and_variant(stand_in):
    _launch(("k1", "mma"))
    _launch(("k1", "mma"))
    _launch(("k1", "scalar"))
    _launch(("k4_sums", "vector"))
    L.count(("k4_dy", "copy"))
    assert stand_in == [(0, 7)] * 4
    snap = L.snapshot()
    assert snap == {("k1", "mma"): 2, ("k1", "scalar"): 1,
                    ("k4_sums", "vector"): 1, ("k4_dy", "copy"): 1}
    _launch(("k1", "mma"))
    assert L.snapshot() - snap == {("k1", "mma"): 1}
    assert snap[("k1", "mma")] == 2  # a snapshot does not move
    L.reset()
    assert L.snapshot() == {} and L.snapshot()[("k1", "mma")] == 0


def test_a_failed_launch_raises_with_the_kernel_and_is_not_counted(
        stand_in):
    with pytest.raises(RuntimeError, match=r"k2 launch \(virtex_stand_in\)"
                       r": CUDA error 3 \(stand-in error\)"):
        L.launch(("k2", "mma"), "virtex_stand_in", torch.zeros(1), 3)
    assert L.snapshot() == {}


def test_a_launch_inside_a_capture_is_recorded_not_counted_or_noted(
        stand_in):
    def capture():
        with L.capturing() as launches:
            _launch(DA.KEY, note=SHAPE)
            _launch(("k1", "mma"))
        return launches

    launches = []
    _profiled(lambda: launches.extend(capture()))
    assert len(stand_in) == 2  # captured launches still call the library
    assert launches == [(DA.KEY, SHAPE), (("k1", "mma"), None)]
    assert L.snapshot() == {}
    assert tracing.notes("decode_attention") == []
    _launch(("k1", "mma"))  # the scope has closed
    assert L.snapshot() == {("k1", "mma"): 1}


def test_replays_count_each_time_and_note_only_under_a_profiler(stand_in):
    with L.capturing() as launches:
        _launch(DA.KEY, note=SHAPE)
        _launch(("k1", "scalar"))
    L.replayed(launches)
    L.replayed(launches)
    assert L.snapshot() == {DA.KEY: 2, ("k1", "scalar"): 2}
    assert len(stand_in) == 2  # a replay calls no C function
    _profiled(lambda: L.replayed(launches))
    assert L.snapshot() == {DA.KEY: 3, ("k1", "scalar"): 3}
    assert tracing.notes("decode_attention") == [SHAPE]
    assert tracing.notes("k1") == []


def test_eager_launches_note_their_shape_under_a_profiler(stand_in):
    _launch(DA.KEY, note=SHAPE)
    _profiled(lambda: _launch(DA.KEY, note=SHAPE))
    assert tracing.notes("decode_attention") == [SHAPE]
    assert L.snapshot() == {DA.KEY: 2}


# -- on the card --------------------------------------------------------------
@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def _draw(shape, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(dtype)


@pytest.mark.cuda
def test_kernels_above_48_kb_of_shared_memory_in_one_process_on_card(cuda):
    """K1 and K2 in both variants and the decode attention, one after the
    other in this process, each at a shape that needs more than 48 KB of
    shared memory (the library's own sizes, checked), each against its
    plain version, each launch counted once under its key. Per element
    |a − b| / (|ref| + 1): bf16 outputs are rounded to 8 bits on each
    side; fp32 sums up to 128 products in other orders."""
    lib = _build.library()
    b, tq, tk, n, d = 2, 30, 128, 4, 64
    assert lib.virtex_attention_fwd_smem_bytes(tk, d) > 48 * 1024
    assert lib.virtex_attention_bwd_smem_bytes(tq, tk, d) > 48 * 1024
    assert lib.virtex_attention_bwd_mma_smem_bytes(tq, tk, d) > 48 * 1024
    L.reset()
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        q, g = (_draw((b, tq, n, d), dtype, cuda, s) for s in (1, 2))
        k, v = (_draw((b, tk, n, d), dtype, cuda, s).requires_grad_()
                for s in (3, 4))
        q.requires_grad_()
        out = A.fused_attention(q, k, v)
        grad = torch.autograd.grad(out, (q, k, v), g)
        q, k, v = q.detach(), k.detach(), v.detach()
        ref = A.attention_reference(q, k, v)
        grads = A.attention_backward_reference(q, k, v, None, g)
        for got, want in zip((out.detach(), *grad), (ref, *grads)):
            err = ((got.float() - want.float()).abs()
                   / (want.float().abs() + 1.0)).max()
            assert float(err) <= tol
    rows, beams, n_valid = 16, 5, 1000
    assert lib.virtex_decode_attention_smem_bytes(beams, n_valid) \
        > 48 * 1024
    q = _draw((rows * beams, 1, 32, 64), torch.bfloat16, cuda, 5)
    k, v = (_draw((rows, n_valid, 32, 64), torch.bfloat16, cuda, s)
            for s in (6, 7))
    out = DA.decode_attention(q, k, v, n_valid, beams)
    want = DA.decode_attention_reference(q, k, v, n_valid, beams)
    torch.cuda.synchronize()
    err = ((out.float() - want.float()).abs() / (want.float().abs() + 1.0))
    assert float(err.max()) <= 2e-2
    assert L.snapshot() == {("k1", "mma"): 1, ("k1", "scalar"): 1,
                            ("k2", "mma"): 1, ("k2", "scalar"): 1,
                            DA.KEY: 1}
