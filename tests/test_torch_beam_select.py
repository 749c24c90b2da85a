"""Beam search's selection (``virtex_tpu_torch.ops.beam_select``).

On the CPU the op takes its plain version, which is the search's sort path
as it was before the op existed (a local copy below): one parametrised
test holds it to that copy bit for bit, and to an oracle written with
Python's ``sorted`` on (value, index), on ties broken toward the lowest
index, −0.0 beside +0.0, rows of −inf and of −1e18, finished beams (EOS
first, then index 0), the penalty landing on a row's top token, step 0's
mode, and V < K (step 0 padded as the search pads it). Then the op's
argument checks.

Cases marked ``cuda`` hold the kernel to the plain version on the CPU,
bit for bit in the scores, the tokens and the source rows: the caption
cell's shape (1280 rows of 10,000) on drawn log-probs, adversarial rows
(constant, many equal maxima, ±0, −inf, finished), small and odd V, every
K and P up to 16, unaligned and strided rows; one launch a call, noted
(rows, V, kept a row) while a profiler records; refusals past 16. A whole
beam search on a table of quarters (many exact ties, beams ending at
different steps) equals the CPU's; captioning under ``DecodeGraphs``
(eager, capture, replay) gives the tokens of the plain selection in one
process, with 30 launches a batch. Run there with ``python -m pytest
tests/test_torch_beam_select.py -m cuda --noconftest``; they skip
elsewhere (a CUDA kernel has no CPU mode).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from virtex_tpu_torch.ops import _launch as L
from virtex_tpu_torch.ops import beam_select as BS
from virtex_tpu_torch.utils import beam_search
from virtex_tpu_torch.utils.beam_search import AutoRegressiveBeamSearch

NEG_INF, PENALTY = -1e18, -10000.0


# -- the search's selection as it was, for the comparisons -------------------
def old_topk(x, k):
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def old_select(logprobs, last_flat, scores, eos, P):
    B, K = scores.shape
    V = logprobs.shape[-1]
    after_end = torch.full((V,), NEG_INF)
    after_end[eos] = 0.0
    rows = torch.arange(B * K)
    base = (torch.arange(B) * K)[:, None]
    logprobs = logprobs.float().clone()
    logprobs[rows, last_flat] += PENALTY
    finished = (last_flat == eos)[:, None]
    logprobs = torch.where(finished, after_end, logprobs)
    node_lp, node_ix = old_topk(logprobs, P)
    cand = (scores.reshape(B * K)[:, None] + node_lp).reshape(B, K * P)
    scores, flat_ix = old_topk(cand, K)
    src = (base + torch.div(flat_ix, P, rounding_mode="floor"))
    src = src.reshape(B * K)
    last = node_ix.reshape(B, K * P).gather(1, flat_ix)
    return scores, last, src


def old_first(logprobs0, K, k0):
    B, V = logprobs0.shape[0] // K, logprobs0.shape[-1]
    return old_topk(logprobs0.reshape(B, K, V)[:, 0, :].float(), k0)


# -- an oracle: Python's sorted on (−value, index) ---------------------------
def _order(values):
    """Indices of ``values`` (fp32) largest first, ties (−0.0 == +0.0) to
    the lowest index."""
    return sorted(range(len(values)), key=lambda j: (-float(values[j]), j))


def oracle_select(logprobs, last_flat, scores, eos, P):
    x, last = logprobs.numpy(), last_flat.numpy()
    sc = scores.numpy()
    B, K = sc.shape
    out_s, out_l, out_src = [], [], []
    for b in range(B):
        cands = []
        for k in range(K):
            r = b * K + k
            if last[r] == eos:
                v = np.full(x.shape[1], np.float32(NEG_INF), np.float32)
                v[eos] = 0.0
            else:
                v = x[r].copy()
                v[last[r]] = v[last[r]] + np.float32(PENALTY)
            for p, j in enumerate(_order(v)[:P]):
                cands.append((sc[b, k] + v[j], j, b * K + k))
        for f in _order([c[0] for c in cands])[:K]:
            out_s.append(cands[f][0])
            out_l.append(cands[f][1])
            out_src.append(cands[f][2])
    return (torch.from_numpy(np.array(out_s, np.float32).reshape(B, K)),
            torch.tensor(out_l, dtype=torch.int64).reshape(B, K),
            torch.tensor(out_src, dtype=torch.int64))


def oracle_first(logprobs0, K, k0):
    x = logprobs0.numpy()[::K]
    idx = [_order(row)[:k0] for row in x]
    vals = [[row[j] for j in ix] for row, ix in zip(x, idx)]
    return (torch.from_numpy(np.array(vals, np.float32)),
            torch.tensor(idx, dtype=torch.int64))


def same(got, want):
    """Equal shapes, dtypes and bits (a float's sign of zero too)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (g, w)
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g.cpu(), w.cpu()), (g, w)


# -- the cases ----------------------------------------------------------------
EOS = 3


def _step(x, last, scores, eos=EOS, P=2):
    """The op on the CPU against the old path and the oracle."""
    x = torch.as_tensor(np.asarray(x, np.float32))
    last = torch.as_tensor(np.asarray(last, np.int64))
    scores = torch.as_tensor(np.asarray(scores, np.float32))
    got = BS.beam_select(x, last, scores, eos, P)
    same(got, old_select(x, last, scores, eos, P))
    same(got, oracle_select(x, last, scores, eos, P))
    return got


def _first(x, K, k0):
    x = torch.as_tensor(np.asarray(x, np.float32))
    got = BS.beam_select_first(x, K, k0)
    same(got, old_first(x, K, k0))
    same(got, oracle_first(x, K, k0))
    return got


def case_ties():
    # beams 0 and 1 equal, every row's maximum at 2, 5 and 9
    x = np.full((6, 12), -2.0, np.float32)
    x[:, [2, 5, 9]] = -0.5
    x[2, [0, 11]] = -0.5
    scores = [[-1.0, -1.0, -1.0], [-0.5, -1.0, -0.5]]
    s, last, src = _step(x, [0] * 6, scores)
    assert last[0].tolist() == [2, 5, 2] and src[:3].tolist() == [0, 0, 1]
    assert last[1].tolist() == [2, 5, 2] and src[3:].tolist() == [3, 3, 5]


def case_signed_zeros():
    x = np.full((4, 8), -3.0, np.float32)
    x[0, 1], x[0, 2] = -0.0, 0.0    # −0.0 first: it stays first
    x[1, 1], x[1, 2] = 0.0, -0.0
    x[2, 4], x[2, 6] = -0.0, -0.0
    x[3, 0], x[3, 7] = 0.0, -0.0
    scores = [[-0.0, 0.0], [-1.0, -0.0]]
    s, last, src = _step(x, [5] * 4, scores)
    assert last.tolist() == [[1, 2], [0, 7]] and src.tolist() == [0, 0, 3, 3]
    bits = s.view(torch.int32) < 0
    assert bits.tolist() == [[True, False], [False, True]]


def case_neg_inf_rows():
    x = np.full((6, 10), -np.inf, np.float32)
    x[1, 7] = -4.0
    x[4] = -1.0
    s, last, src = _step(x, [0, 1, 2, 4, 5, 6], [[0.0, -1.0, -2.0]] * 2)
    assert last[0].tolist() == [7, 0, 1] and src[:3].tolist() == [1, 0, 0]
    assert s[0, 1] == -np.inf


def case_neg_1e18_rows():
    x = np.full((4, 9), np.float32(NEG_INF), np.float32)
    x[2, 8] = -7.0
    s, last, src = _step(x, [0, EOS, 1, 2], [[-1.0, -1.0], [-3.0, 0.0]])
    assert last[0].tolist() == [EOS, 0]    # the finished beam wins
    assert last[1].tolist() == [8, 0]


def _finished(eos):
    # image 1's beams both finished, the second at a score of −1e18: its
    # EOS candidate ties with the first beam's second, which goes first
    x = np.random.RandomState(3).randn(4, 7).astype(np.float32)
    s, last, src = _step(x, [eos, 1, eos, eos],
                         [[-1.0, -9.0], [-2.0, NEG_INF]], eos=eos)
    after = 0 if eos else 1  # EOS first, then the lowest other index
    assert last[1].tolist() == [eos, after] and src[2:].tolist() == [2, 2]


def case_finished():
    _finished(EOS)


def case_finished_at_token_0():
    _finished(0)


def case_penalty_on_the_top_token():
    rng = np.random.RandomState(5)
    x = rng.randn(6, 11).astype(np.float32)
    x[:, 10] -= 50.0  # EOS, never a row's top
    top = x.argmax(axis=1)
    s, last, src = _step(x, top, [[-1.0, -2.0, -3.0], [0.0, 0.0, 0.0]],
                         eos=10, P=3)
    kept = {(int(r), int(t)) for r, t in zip(src, last.reshape(-1))}
    assert all((r, int(top[r])) not in kept for r in range(6))


def case_step_0():
    x = np.full((8, 12), -5.0, np.float32)
    x[0, [4, 9]], x[0, 2] = -1.0, -0.0
    x[4, 3], x[4, 1] = 0.0, -0.0
    x[1] = 10.0  # beams other than each image's first are never read
    values, tokens = _first(x, 4, 4)
    assert tokens.tolist() == [[2, 4, 9, 0], [1, 3, 0, 2]]


def case_v_below_k():
    # K 5 over V 3: step 0 keeps 3, padded as the search pads it
    rng = np.random.RandomState(7)
    B, K, V = 2, 5, 3
    x0 = np.round(rng.randn(B * K, V) * 4).astype(np.float32) / 4
    scores, last = _first(x0, K, V)
    scores = torch.cat([scores, scores.new_full((B, K - V), NEG_INF)], 1)
    last = torch.cat([last, last[:, -1:].expand(B, K - V)], dim=1)
    for _ in range(3):
        x = np.round(rng.randn(B * K, V) * 4).astype(np.float32) / 4
        scores, last, src = _step(x, last.reshape(-1), scores, eos=1)


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_selection_is_the_sort_path(case):
    CASES[case]()


def test_search_loop_selects_through_the_op(monkeypatch):
    """Every selection of the search goes through the op: one step-0 call
    and one call a loop step."""
    calls = []
    for name in ("beam_select", "beam_select_first"):
        fn = getattr(beam_search, name)
        monkeypatch.setattr(beam_search, name,
                            lambda *a, _n=name, _f=fn: calls.append(_n)
                            or _f(*a))
    table = torch.from_numpy(np.random.RandomState(2).randn(6, 9, 9)
                             .astype(np.float32))
    search = AutoRegressiveBeamSearch(EOS, max_steps=6, beam_size=3)
    search.search(torch.tensor([1, 4]),
                  lambda last, t, s: (table[t][last], s), {})
    assert calls == ["beam_select_first"] + ["beam_select"] * 5


@pytest.mark.parametrize("bad", ["keep more than V", "rows not beams",
                                 "scores disagree", "eos outside V",
                                 "devices differ", "no device"])
def test_op_refuses_what_it_cannot_select(bad):
    x, last = torch.zeros(6, 4), torch.zeros(6, dtype=torch.int64)
    scores = torch.zeros(2, 3)
    with pytest.raises(ValueError):
        if bad == "keep more than V":
            BS.beam_select(x, last, scores, 1, 5)
        elif bad == "rows not beams":
            BS.beam_select_first(x, 4, 2)
        elif bad == "scores disagree":
            BS.beam_select(x, last, torch.zeros(3, 3), 1, 2)
        elif bad == "eos outside V":
            BS.beam_select(x, last, scores, 4, 2)
        elif bad == "devices differ":
            BS.beam_select(x, last.to("meta"), scores, 1, 2)
        else:
            BS.beam_select(x.to("meta"), last.to("meta"), scores.to("meta"),
                           1, 2)


# -- on the card --------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: beam select is a CUDA kernel with "
                    "no CPU mode")
    return torch.device("cuda")


def _kernel(x, last, scores, eos, P):
    """The op on the card, one launch, held to the plain version on the
    CPU bit for bit."""
    before = L.snapshot()
    got = BS.beam_select(x, last, scores, eos, P)
    torch.cuda.synchronize()
    assert L.snapshot() - before == {BS.KEY: 1}
    same(got, BS.beam_select(x.cpu(), last.cpu(), scores.cpu(), eos, P))
    return got


def _kernel_first(x, K, k):
    before = L.snapshot()
    got = BS.beam_select_first(x, K, k)
    torch.cuda.synchronize()
    assert L.snapshot() - before == {BS.KEY: 1}
    same(got, BS.beam_select_first(x.cpu(), K, k))
    return got


def _drawn(B, K, V, seed, device, finished=0.2, eos=EOS):
    g = torch.Generator().manual_seed(seed)
    x = torch.log_softmax(torch.randn(B * K, V, generator=g) * 3, dim=-1)
    last = torch.randint(0, V, (B * K,), generator=g)
    last[torch.rand(B * K, generator=g) < finished] = eos
    scores = -torch.rand(B, K, generator=g) * 20
    return x.to(device), last.to(device), scores.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [1, 2**31 + 11])
def test_at_the_caption_cells_shape_on_card(cuda, seed):
    x, last, scores = _drawn(256, 5, 10000, seed % 2**31, cuda)
    _kernel(x, last, scores, EOS, 2)
    _kernel_first(x, 5, 5)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ["constant", "equal maxima", "signed zeros",
                                  "-inf", "-1e18", "finished"])
def test_adversarial_rows_on_card(cuda, rows):
    B, K, V = 64, 5, 10000
    g = torch.Generator().manual_seed(9)
    x = torch.log_softmax(torch.randn(B * K, V, generator=g), dim=-1)
    last = torch.randint(0, V, (B * K,), generator=g)
    scores = torch.round(-torch.rand(B, K, generator=g) * 8) / 4
    if rows == "constant":
        x[:] = -9.25
        scores[:] = -1.0
    elif rows == "equal maxima":
        x = torch.round(x * 2) / 2
        x[:, ::97] = 0.5
    elif rows == "signed zeros":
        x[:, ::13] = -0.0
        x[:, 5::29] = 0.0
        scores[:, ::2] = -0.0
        scores[:, 1::2] = 0.0
    elif rows == "-inf":
        x[::2] = -float("inf")
        x[1::4, 1::3] = -float("inf")
    elif rows == "-1e18":
        x[::3] = NEG_INF
        last[::7] = EOS
    else:
        last[: B * K // 2] = EOS
        x[:, EOS] = 0.0
    _kernel(x.to(cuda), last.to(cuda), scores.to(cuda), EOS, 2)
    _kernel_first(x.to(cuda), K, K)


@pytest.mark.cuda
@pytest.mark.parametrize("V", [2, 3, 4, 5, 7, 16, 33, 127, 1023, 10001])
@pytest.mark.parametrize("K,P", [(1, 1), (3, 2), (5, 2), (5, 5), (16, 16),
                                 (16, 1), (2, 16)])
def test_small_and_odd_sizes_on_card(cuda, V, K, P):
    if P > V:
        pytest.skip("P exceeds V: the search never asks it")
    x, last, scores = _drawn(7, K, V, V * 31 + K * 7 + P, cuda,
                             eos=min(EOS, V - 1))
    x = torch.round(x * 4) / 4  # exact ties in the rows and the candidates
    _kernel(x, last, scores, min(EOS, V - 1), P)
    _kernel_first(x, K, min(K, V))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_unaligned_and_strided_rows_on_card(cuda, offset):
    x, last, scores = _drawn(16, 5, 1000 + offset, 4, cuda)
    view = x[:, offset:]              # rows start off a 16-byte boundary
    last = last.clamp(max=999)
    _kernel(view, last, scores, EOS, 2)
    _kernel_first(view, 5, 5)


@pytest.mark.cuda
def test_launches_are_noted_under_a_profiler_on_card(cuda):
    from torch.profiler import ProfilerActivity, profile

    from virtex_tpu_torch.utils import tracing
    x, last, scores = _drawn(256, 5, 10000, 6, cuda)
    with tracing.span("between sessions"):  # a store of its own
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        BS.beam_select_first(x, 5, 5)
        BS.beam_select(x, last, scores, EOS, 2)
    torch.cuda.synchronize()
    assert tracing.notes("beam_select") == [(256, 10000, 5),
                                            (1280, 10000, 2)]


@pytest.mark.cuda
def test_refuses_beyond_its_limits_on_card(cuda):
    x, last, scores = _drawn(2, 17, 50, 5, cuda)
    with pytest.raises(ValueError):
        BS.beam_select(x, last, scores, EOS, 2)
    with pytest.raises(ValueError):
        BS.beam_select_first(x, 1, 17)


@pytest.mark.cuda
@pytest.mark.parametrize("ends", ["some beams", "every beam"])
def test_search_on_quarters_equals_the_cpu_on_card(cuda, ends):
    """A whole beam search over a table of quarters: exact ties in rows and
    sums, beams ending at different steps (or all of them early)."""
    B, K, V, steps = 24, 5, 300, 12
    rng = np.random.RandomState(13)
    table = (np.round(rng.randn(steps, V, V) * 4) / 4 - 2.0).astype(
        np.float32)
    table[4:, :, EOS] += 2.0 if ends == "some beams" else 30.0
    start = torch.from_numpy(rng.randint(0, V, B))
    out = []
    for device in ("cpu", cuda):
        t = torch.from_numpy(table).to(device)
        search = AutoRegressiveBeamSearch(EOS, max_steps=steps, beam_size=K)
        before = L.snapshot()
        out.append(search.search(start.to(device),
                                 lambda last, p, s: (t[p][last], s), {},
                                 only_return_best=False)
                   + (L.snapshot() - before,))
    (cpu_p, cpu_s, cpu_n), (p, s, n) = out
    same((p, s), (cpu_p, cpu_s))
    assert cpu_n == {} and 0 < n[BS.KEY] <= steps
    assert (n[BS.KEY] < steps) == (ends == "every beam")


H2048 = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs",
                     "width_ablations", "bicaptioning_R_50_L1_H2048.yaml")


@pytest.mark.cuda
def test_graphed_captions_with_the_kernel_equal_the_plain_ones_on_card(
        cuda, monkeypatch):
    """The caption cell's search (H2048, B 256, beam 5, 30 steps) under
    DecodeGraphs, eager then capturing then replaying, gives the tokens and
    scores of the plain selection in the same process; 30 launches a
    batch."""
    from virtex_tpu_torch.config import Config, ModelSpec
    from virtex_tpu_torch.engine.captioner import make_caption_fn
    from virtex_tpu_torch.factories import (
        CaptionDecoderFactory,
        PretrainingModelFactory,
    )
    torch.manual_seed(0)
    cfg = Config(H2048)
    model = PretrainingModelFactory.from_config(cfg, "cuda").eval()
    spec = ModelSpec.from_config(cfg)
    g = torch.Generator(device="cuda").manual_seed(3)
    images = torch.rand(256, 224, 224, 3, generator=g, device="cuda")

    def captions():
        dec = CaptionDecoderFactory.from_spec(
            dataclasses.replace(spec, decoder_name="beam_search"))
        search, kept = dec.search, {}

        def every_beam(*args):
            kept["beams"] = search(*args, only_return_best=False)
            return kept["beams"]
        dec.search = every_beam
        fn = make_caption_fn(model, dec, spec.sos_index, spec.prefix_mode)
        out = []
        for _ in range(3):  # eager, capture, replay
            before = L.snapshot()
            fn(images)
            torch.cuda.synchronize()
            out.append((kept["beams"], (L.snapshot() - before)[BS.KEY]))
        return out

    got = captions()
    with monkeypatch.context() as m:
        m.setattr(beam_search, "beam_select", BS.beam_select_reference)
        m.setattr(beam_search, "beam_select_first",
                  BS.beam_select_first_reference)
        want = captions()
    steps = spec.max_decoding_steps
    for (beams, launches), (plain, plain_launches) in zip(got, want):
        same(beams, plain)
        assert launches == steps and plain_launches == 0
