"""The decode step's attention (``virtex_tpu_torch.ops.decode_attention``)
and the caption loop's per-image cross K/V.

On the CPU: the op takes the plain path, and that path equals, bit for
bit, the einsum attention the decode step ran before the op existed (a
local copy below), for the self cache under its mask and for cross K/V
repeated to the beams; ``MultiHeadAttention``'s decode methods likewise;
beam captioning with the cross K/V kept once per image gives the tokens of
a local copy of the caption loop that tiled them to the beams; the op's
argument checks.

Cases marked ``cuda`` hold the kernel against the plain path on the card:
the caption cell's shapes (1280 query rows, 32 heads of 64; cross 256 K/V
rows of 49 positions, 5 rows each; self n_valid 1..30 of a 30-position
cache), H1024's 16 heads, and odd sizes (one row, one position, query
rows of 9 and 3 per K/V row, every head size it is built for, q a strided
view of the packed projection, unaligned views), with one launch each,
equal bits twice, and positions past n_valid never read. Run there with
``python -m pytest tests/test_torch_decode_attention.py -m cuda
--noconftest``; they skip elsewhere (a CUDA kernel has no CPU mode).
"""
import math

import numpy as np
import pytest
import torch

from virtex_tpu_torch.config import Config, ModelSpec
from virtex_tpu_torch.engine.captioner import make_caption_fn
from virtex_tpu_torch.factories import (
    CaptionDecoderFactory,
    PretrainingModelFactory,
)
from virtex_tpu_torch.modules.transformer import MultiHeadAttention
from virtex_tpu_torch.ops import _launch as L
from virtex_tpu_torch.ops import decode_attention as DA
from virtex_tpu_torch.utils.beam_search import AutoRegressiveBeamSearch

NEG_INF = -1e9


# -- the decode step's einsum attention as it was, for the comparisons ------
def old_attention_weights(q, k, mask, dtype):
    logits = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
    logits = logits / math.sqrt(q.shape[-1])
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    return torch.softmax(logits, dim=-1).to(dtype)


def old_context(probs, v, dtype):
    return torch.einsum("bnqk,bknd->bqnd", probs.float(), v.float()).to(dtype)


def old_self(q, k_cache, v_cache, position, dtype):
    valid = torch.arange(k_cache.shape[1]) <= position
    probs = old_attention_weights(q, k_cache, valid[None, None, None, :],
                                  dtype)
    return old_context(probs, v_cache, dtype)


def old_cross(q, k, v, dtype):
    return old_context(old_attention_weights(q, k, None, dtype), v, dtype)


def draw(shape, dtype, seed, device="cpu"):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        device, dtype)


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("position", [0, 3, 7])
def test_plain_self_path_is_the_old_einsum_bit_for_bit(dtype, position):
    q = draw((6, 1, 4, 16), dtype, 0)
    k, v = draw((6, 8, 4, 16), dtype, 1), draw((6, 8, 4, 16), dtype, 2)
    got = DA.decode_attention(q, k, v, position + 1)
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, old_self(q, k, v, position, dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows_per_kv", [1, 3])
def test_plain_cross_path_is_the_old_einsum_on_repeated_rows(dtype,
                                                             rows_per_kv):
    q = draw((2 * rows_per_kv, 1, 4, 16), dtype, 3)
    k, v = draw((2, 5, 4, 16), dtype, 4), draw((2, 5, 4, 16), dtype, 5)
    got = DA.decode_attention(q, k, v, 5, rows_per_kv)
    want = old_cross(q, k.repeat_interleave(rows_per_kv, 0),
                     v.repeat_interleave(rows_per_kv, 0), dtype)
    assert torch.equal(got, want)


def test_query_rows_attend_their_own_kv_row():
    q = draw((6, 1, 2, 8), torch.float32, 6)
    k, v = draw((2, 4, 2, 8), torch.float32, 7), draw((2, 4, 2, 8),
                                                       torch.float32, 8)
    got = DA.decode_attention(q, k, v, 3, rows_per_kv=3)
    for r in range(6):
        one = DA.decode_attention(q[r:r + 1], k[r // 3:r // 3 + 1],
                                  v[r // 3:r // 3 + 1], 3)
        assert torch.equal(got[r:r + 1], one)


@pytest.mark.parametrize("dtype", DTYPES)
def test_module_decode_methods_are_the_old_path(dtype):
    torch.manual_seed(0)
    mha = MultiHeadAttention(32, 4, dropout=0.0, dtype=dtype).eval()
    x = draw((6, 1, 32), dtype, 9)
    k_cache = torch.zeros(6, 5, 4, 8, dtype=dtype)
    v_cache = torch.zeros_like(k_cache)
    kv = draw((2, 7, 32), dtype, 10)
    with torch.no_grad():
        for position in range(5):
            out, k_cache, v_cache = mha.decode_self(x, k_cache, v_cache,
                                                    position)
            q, _, _ = mha._qkv(x, x)
            want = mha._out(old_self(q, k_cache, v_cache, position, dtype))
            assert torch.equal(out, want)
        ck, cv = mha.project_kv(kv)
        (q,) = mha._split(mha._project(x, slice(0, 32)), 1)
        want = mha._out(old_cross(q, ck.repeat_interleave(3, 0),
                                  cv.repeat_interleave(3, 0), dtype))
        assert torch.equal(mha.attend_kv(x, ck, cv), want)


def _tiny_model(dtype: str):
    cfg = Config(None, [
        "MODEL.VISUAL.NAME", "torchvision::resnet18",
        "MODEL.VISUAL.FEATURE_SIZE", 512,
        "MODEL.TEXTUAL.NAME", "transdec_postnorm::L2_H32_A2_F64",
        "MODEL.TEXTUAL.DROPOUT", 0.0,
        "MODEL.DECODER.NAME", "beam_search", "MODEL.DECODER.BEAM_SIZE", 3,
        "DATA.VOCAB_SIZE", 60, "DATA.MAX_CAPTION_LENGTH", 8,
        "DATA.IMAGE_CROP_SIZE", 64, "DTYPE", dtype])
    torch.manual_seed(0)
    model = PretrainingModelFactory.from_config(cfg, "cpu").eval()
    with torch.no_grad():  # a peaked output: the search ranks clear gaps
        model.textual.output.bias.copy_(torch.randn(60) * 2.0)
        model.textual.output.bias[2] = -1e4  # EOS never wins
    return model, ModelSpec.from_config(cfg)


def old_caption_fn(model, decoder, sos_index):
    """The caption loop as it was: each image's cross K/V tiled to its
    beams (the "reference" prefix mode)."""
    K = decoder.beam_size

    @torch.inference_mode()
    def caption_fn(images):
        grid = model.encode_visual(images)
        B = images.shape[0]
        caches = model.init_decode(grid, decoder.max_steps)
        cross = [{"ck": c["ck"].repeat_interleave(K, dim=0),
                  "cv": c["cv"].repeat_interleave(K, dim=0)}
                 for c in caches]
        self_caches = [{"k": c["k"].repeat_interleave(K, dim=0),
                        "v": c["v"].repeat_interleave(K, dim=0)}
                       for c in caches]

        def step_fn(tokens, position, state):
            position = max(position - 1, 0)
            full = [{**sc, **cx} for sc, cx in zip(state, cross)]
            logits, full = model.decode_step(tokens, position, full)
            state = [{"k": c["k"], "v": c["v"]} for c in full]
            return torch.log_softmax(logits.float(), dim=-1), state

        start = torch.full((B,), sos_index, dtype=torch.long)
        return decoder.search(start, step_fn, self_caches,
                              only_return_best=False)

    return caption_fn


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_beam_captions_with_per_image_cross_kv_equal_the_tiled_ones(
        dtype, monkeypatch):
    model, spec = _tiny_model(dtype)
    decoder = CaptionDecoderFactory.from_spec(spec)
    assert isinstance(decoder, AutoRegressiveBeamSearch)
    images = torch.rand(3, 64, 64, 3, generator=torch.Generator()
                        .manual_seed(1))
    old_preds, old_scores = old_caption_fn(model, decoder,
                                           spec.sos_index)(images)

    # The new loop's beams and scores, and what its decode attention saw.
    seen = []
    plain = DA.decode_attention

    def spy(q, k, v, n_valid, rows_per_kv=1):
        seen.append((q.shape[0], k.shape[0], rows_per_kv))
        return plain(q, k, v, n_valid, rows_per_kv)

    for m in model.modules():
        if isinstance(m, MultiHeadAttention):
            m.decode_attention_fn = spy
    search, result = decoder.search, {}

    def every_beam(*args):
        result["beams"] = search(*args, only_return_best=False)
        return result["beams"]

    monkeypatch.setattr(decoder, "search", every_beam)
    make_caption_fn(model, decoder, spec.sos_index, spec.prefix_mode)(images)
    preds, scores = result["beams"]
    assert torch.equal(preds, old_preds)
    assert torch.equal(scores, old_scores)
    K = spec.beam_size
    assert (9, 3, K) in seen and (9, 9, 1) in seen  # cross, self
    assert {s for s in seen} == {(9, 3, K), (9, 9, 1)}


def test_checks_refuse_mismatched_operands():
    q = torch.zeros(6, 1, 2, 8)
    k = torch.zeros(2, 4, 2, 8)
    with pytest.raises(ValueError, match="per K/V row"):
        DA.decode_attention(q, k, k, 4, rows_per_kv=2)
    with pytest.raises(ValueError, match="n_valid"):
        DA.decode_attention(q, k, k, 5, rows_per_kv=3)
    with pytest.raises(ValueError, match="n_valid"):
        DA.decode_attention(q, k, k, 0, rows_per_kv=3)
    with pytest.raises(ValueError, match="want q"):
        DA.decode_attention(torch.zeros(6, 2, 2, 8), k, k, 4, 3)
    with pytest.raises(ValueError, match="disagree"):
        DA.decode_attention(torch.zeros(6, 1, 2, 4), k, k, 4, 3)
    with pytest.raises(TypeError, match="one dtype"):
        DA.decode_attention(q.bfloat16(), k, k, 4, 3)


def test_build_table_matches_the_kernels_c_entry_points():
    """ctypes passes every argument as the table says: one argtype per C
    parameter of ``csrc/decode_attention.cu``'s entry points."""
    import ctypes
    import re

    from virtex_tpu_torch.ops import _build
    source = (_build.CSRC / "decode_attention.cu").read_text()
    for name in ("virtex_decode_attention",
                 "virtex_decode_attention_smem_bytes"):
        params = re.search(rf"{name}\(([^)]*)\)", source).group(1)
        restype, argtypes = _build.SIGNATURES[name]
        assert len(argtypes) == params.count(",") + 1, name
        pointers = params.count("*")
        assert argtypes.count(ctypes.c_void_p) == pointers, name
    assert _build.SIGNATURES["virtex_decode_attention"][0] is ctypes.c_int


# -- the kernel on the card -------------------------------------------------
# Kernel against the plain path, per element |a − b| / (|ref| + ATOL): q, k,
# v ~ N(0, 1), so outputs are O(1) and ATOL = 1 is their scale. Both read
# the bf16 operands exactly and sum in fp32 in other orders, so their fp32
# logits, probabilities and sums differ in the last bits; a probability or
# an output whose bf16 rounding falls the other way moves by one bf16 step,
# 2^-8 of it, which TOL allows more than twice over.
ATOL = 1.0
TOL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decode attention is a CUDA "
                    "kernel with no CPU mode")
    return torch.device("cuda")


def rel_err(a, ref):
    a, ref = a.double(), ref.double()
    return float(((a - ref).abs() / (ref.abs() + ATOL)).max())


def _kernel(q, k, v, n_valid, rows_per_kv=1):
    """The op on the card, checked to launch the kernel once and to give
    equal bits twice."""
    before = L.snapshot()
    out = DA.decode_attention(q, k, v, n_valid, rows_per_kv)
    again = DA.decode_attention(q, k, v, n_valid, rows_per_kv)
    torch.cuda.synchronize()
    assert L.snapshot() - before == {DA.KEY: 2}
    assert out.shape == q.shape and out.dtype == q.dtype
    assert out.is_contiguous() and torch.equal(out, again)
    return out


def _check(q, k, v, n_valid, rows_per_kv=1):
    got = _kernel(q, k, v, n_valid, rows_per_kv)
    want = DA.decode_attention_reference(q, k, v, n_valid, rows_per_kv)
    assert torch.isfinite(got.float()).all()
    assert rel_err(got, want) <= TOL
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [32, 16])
def test_cross_at_the_caption_cells_shape_on_card(cuda, heads):
    # 256 images' 49 visual tokens, 5 beams each; H2048 (32 heads) and
    # H1024 (16 heads), 64 dims a head.
    q = draw((1280, 1, heads, 64), torch.bfloat16, 20, cuda)
    k = draw((256, 49, heads, 64), torch.bfloat16, 21, cuda)
    v = draw((256, 49, heads, 64), torch.bfloat16, 22, cuda)
    _check(q, k, v, 49, rows_per_kv=5)


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [32, 16])
def test_self_at_every_position_of_the_caption_cell_on_card(cuda, heads):
    q = draw((1280, 1, heads, 64), torch.bfloat16, 23, cuda)
    k = draw((1280, 30, heads, 64), torch.bfloat16, 24, cuda)
    v = draw((1280, 30, heads, 64), torch.bfloat16, 25, cuda)
    for n_valid in range(1, 31):
        _check(q, k, v, n_valid)


@pytest.mark.cuda
def test_positions_past_n_valid_are_never_read_on_card(cuda):
    q = draw((40, 1, 8, 64), torch.bfloat16, 26, cuda)
    k = draw((40, 30, 8, 64), torch.bfloat16, 27, cuda)
    v = draw((40, 30, 8, 64), torch.bfloat16, 28, cuda)
    for n_valid in (1, 13, 29):
        clean = _check(q, k, v, n_valid)
        kn, vn = k.clone(), v.clone()
        kn[:, n_valid:], vn[:, n_valid:] = float("nan"), float("nan")
        assert torch.equal(_kernel(q, kn, vn, n_valid), clean)


@pytest.mark.cuda
@pytest.mark.parametrize("R,rows,Tk,n_valid,N,D", [
    (1, 1, 1, 1, 1, 64),         # one row, one position
    (1, 1, 30, 17, 32, 64),
    (5, 1, 49, 49, 2, 64),       # one image's beams
    (27, 3, 49, 49, 4, 64),      # 9 rows per K/V row: two passes of 8 + 1
    (9, 3, 33, 20, 3, 64),       # 3 rows per K/V row, odd heads
    (7, 7, 10, 10, 4, 8),        # every head size the kernel is built for
    (12, 4, 50, 50, 4, 16),
    (12, 4, 30, 30, 4, 32),
    (12, 4, 49, 49, 4, 128),
    (12, 12, 30, 30, 2, 256),
    (16, 2, 400, 400, 2, 64),    # logits past 48 KB of shared memory
])
def test_odd_sizes_on_card(cuda, R, rows, Tk, n_valid, N, D):
    q = draw((R, 1, N, D), torch.bfloat16, 29, cuda)
    k = draw((rows, Tk, N, D), torch.bfloat16, 30, cuda)
    v = draw((rows, Tk, N, D), torch.bfloat16, 31, cuda)
    _check(q, k, v, n_valid, R // rows)


@pytest.mark.cuda
def test_strided_and_unaligned_views_on_card(cuda):
    # q a (row, head)-strided view of a packed (R, 1, 3·H) projection, as
    # decode_self passes it; k and v views one element into their buffers
    # (copied before the launch).
    N, D = 4, 64
    packed = draw((10, 1, 3 * N * D), torch.bfloat16, 32, cuda)
    q = packed[..., :N * D].view(10, 1, N, D)
    assert not q.is_contiguous()
    flat = draw((2 * 6 * N * D + 1,), torch.bfloat16, 33, cuda)
    k = flat[1:2 * 6 * N * D + 1].view(2, 6, N, D)
    v = draw((2, 6, N, D), torch.bfloat16, 34, cuda)
    _check(q, k, v, 6, rows_per_kv=5)
    _check(q, v, k, 4, rows_per_kv=5)


@pytest.mark.cuda
def test_fp32_on_card_takes_the_plain_path(cuda):
    q = draw((6, 1, 2, 64), torch.float32, 35, cuda)
    k = draw((2, 5, 2, 64), torch.float32, 36, cuda)
    before = L.snapshot()
    out = DA.decode_attention(q, k, k, 5, rows_per_kv=3)
    assert L.snapshot() == before
    assert torch.equal(out, DA.decode_attention_reference(q, k, k, 5, 3))
