"""The port's spans (virtex_tpu_torch.utils.tracing) on the CPU: free and
silent with no profiler; under ``torch.profiler`` one record per layer
boundary of a train update and of a caption batch, nested as they ran, on
the exported trace's clock; one store per profiler session, which holds
the notes (a kernel's launch shapes) beside the records.

A tiny bicaptioning model (resnet18 at 64², L1_H32_A2_F64, a vocabulary
of 50, captions of 8 tokens), fp32, one torch thread.
"""
import json
import logging
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from virtex_tpu_torch.config import Config, ModelSpec
from virtex_tpu_torch.engine.captioner import make_caption_fn
from virtex_tpu_torch.engine.trainer import make_train_step
from virtex_tpu_torch.factories import (
    CaptionDecoderFactory,
    OptimizerFactory,
    PretrainingModelFactory,
)
from virtex_tpu_torch.modules.normalization import SubsampledBatchNorm
from virtex_tpu_torch.utils import tracing

B, IMAGE, T, VOCAB, EOS = 2, 64, 8, 50, 2


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(decoder: str = "beam_search") -> Config:
    return Config(None, [
        "MODEL.VISUAL.NAME", "torchvision::resnet18",
        "MODEL.VISUAL.FEATURE_SIZE", 512,
        "MODEL.TEXTUAL.NAME", "transdec_postnorm::L1_H32_A2_F64",
        "MODEL.TEXTUAL.DROPOUT", 0.0,
        "MODEL.DECODER.NAME", decoder, "MODEL.DECODER.BEAM_SIZE", 2,
        "DATA.VOCAB_SIZE", VOCAB, "DATA.MAX_CAPTION_LENGTH", T,
        "DATA.IMAGE_CROP_SIZE", IMAGE, "DTYPE", "float32"])


@pytest.fixture(scope="module")
def parts():
    torch.manual_seed(0)
    cfg = _config()
    model = PretrainingModelFactory.from_config(cfg, "cpu")
    with torch.no_grad():  # EOS never wins: every search runs its steps
        model.textual.output.bias[EOS] = -1e4
    optimizer = OptimizerFactory.from_config(cfg, model.named_parameters())
    return cfg, model, optimizer


def _batch(seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(4, VOCAB, (B, T), generator=g)
    tokens[:, 0], tokens[:, -1] = 1, EOS
    return {"image": torch.rand(B, IMAGE, IMAGE, 3, generator=g),
            "caption_tokens": tokens, "noitpac_tokens": tokens.flip(1),
            "caption_lengths": torch.full((B,), T)}


def _step(parts, accum: int = 1):
    _, model, optimizer = parts
    step = make_train_step(model, optimizer, accum,
                           generator=torch.Generator())
    batch = _batch()
    if accum > 1:
        batch = {k: torch.stack([v] * accum) for k, v in batch.items()}
    return lambda: step(batch)


def _caption(parts, decoder: str = "beam_search"):
    cfg, model, _ = parts
    spec = ModelSpec.from_config(_config(decoder))
    fn = make_caption_fn(model, CaptionDecoderFactory.from_spec(spec),
                         spec.sos_index, spec.prefix_mode)
    images = _batch(1)["image"]
    return lambda: fn(images, torch.Generator().manual_seed(0))


def _profiled(fn, path=None):
    """``fn()`` under the profiler, in a session of its own: a span runs
    with the profiler off first, so the store starts afresh."""
    with tracing.span("between sessions"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    if path is not None:
        prof.export_chrome_trace(str(path))
    return out


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def test_off_opens_nothing_and_returns_one_shared_object(parts, monkeypatch):
    step = _step(parts)
    _profiled(step)
    before = tracing.records()  # off, the session's records stay as they are
    assert before

    def refuse(*args, **kwargs):
        raise AssertionError("called with the profiler off")
    monkeypatch.setattr(time, "time_ns", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    x = torch.zeros(1)
    assert tracing.span("a") is tracing.span("b", x) is tracing.span("c")
    with tracing.span("a", x) as inside:
        assert inside is None
    step()
    assert tracing.records() == before


@pytest.mark.parametrize("accum", [1, 2])
def test_a_train_update_records_each_layer_under_its_parent(parts, accum):
    _profiled(_step(parts, accum))
    spans = _by_name(tracing.records())
    bn_layers = sum(isinstance(m, SubsampledBatchNorm)
                    for m in parts[1].modules())
    counts = {name: len(rs) for name, rs in spans.items()}
    assert counts == {"train_step": 1, "backward": accum, "optimizer": 1,
                      "visual": accum, "textual": accum,
                      "backward_textual": accum,
                      "bn_fwd": bn_layers * accum}
    (update,) = spans["train_step"]
    assert update.parent is None and update.unit is update
    for name in ("backward", "optimizer", "visual", "textual",
                 "backward_textual"):
        assert all(r.parent is update for r in spans[name]), name
    visual = set(map(id, spans["visual"]))
    assert all(id(r.parent) in visual for r in spans["bn_fwd"])
    assert all(r.unit is update for r in tracing.records())
    table = tracing.summary()
    assert all(s["device_s"] is None for s in table.values())  # no card
    children = sum(table[n]["host_s"] for n in (
        "backward", "optimizer", "visual", "textual", "backward_textual"))
    assert table["train_step"]["self_host_s"] == pytest.approx(
        table["train_step"]["host_s"] - children)
    assert 0 < table["train_step"]["self_host_s"] < table["train_step"][
        "host_s"]


@pytest.mark.parametrize("decoder", ["beam_search", "nucleus_sampling"])
def test_a_caption_batch_records_the_search_loop(parts, decoder):
    preds = _profiled(_caption(parts, decoder))
    assert not (preds == EOS).any()
    spans = _by_name(tracing.records())
    counts = {name: len(rs) for name, rs in spans.items()}
    bn_layers = sum(isinstance(m, SubsampledBatchNorm)
                    for m in parts[1].modules())
    loop = {"host_sync": T - 1}
    if decoder == "beam_search":
        loop.update(beam_select=T - 1, beam_reorder=T - 1)
    assert counts == {"caption": 1, "visual": 1, "bn_fwd": bn_layers,
                      "prefill": 1, "decode_step": T, **loop}
    (batch,) = spans["caption"]
    for name in ("visual", "prefill", "decode_step", *loop):
        assert all(r.parent is batch for r in spans[name]), name
    assert all(r.unit is batch for r in tracing.records())
    assert tracing.summary()["host_sync"]["count"] == T - 1


def test_the_chrome_trace_holds_the_spans_on_the_records_clock(parts,
                                                               tmp_path):
    path = tmp_path / "trace.json"
    _profiled(_step(parts), path)
    trace = json.loads(path.read_text())
    base_us = int(trace["baseTimeNanoseconds"]) / 1e3
    ranges = sorted(
        (e for e in trace["traceEvents"]
         if e.get("cat") == "user_annotation"
         and e["name"].startswith(tracing.PREFIX)),
        key=lambda e: (e["ts"], -e["dur"]))
    records = tracing.records()
    assert [e["name"] for e in ranges] == [tracing.PREFIX + r.name
                                           for r in records]
    event = dict(zip(map(id, records), ranges))
    for r in records:
        e = event[id(r)]
        assert abs(r.start_ns / 1e3 - (e["ts"] + base_us)) < 5e3, r.name
        if r.parent is not None:
            p = event[id(r.parent)]
            assert p["ts"] <= e["ts"]
            assert e["ts"] + e["dur"] <= p["ts"] + p["dur"]


def test_each_profiler_session_is_a_store_of_its_own(parts):
    step, caption = _step(parts), _caption(parts)
    _profiled(step)
    assert "train_step" in tracing.summary()
    step()  # between the sessions, with the profiler off
    _profiled(caption)
    table = tracing.summary()
    assert set(table) == {"caption", "visual", "bn_fwd", "prefill",
                          "decode_step", "host_sync", "beam_select",
                          "beam_reorder"}
    assert table["caption"]["count"] == 1
    caption()  # off: the session's store is still there to read
    assert tracing.summary() == table


def test_the_pretraining_cli_logs_each_span_per_iteration(parts, caplog):
    from virtex_tpu_torch.scripts.pretrain_virtex import stop_profiler
    step = _step(parts)
    with tracing.span("between sessions"):
        pass
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    for _ in range(2):
        with tracing.span("data_wait", "cpu"):
            pass
        step()
    with caplog.at_level(logging.INFO, logger="virtex_tpu_torch"):
        stop_profiler(prof)
    (line,) = [r.getMessage() for r in caplog.records
               if r.getMessage().startswith("spans")]
    assert line.startswith("spans, ms per train_step (host/device) over 2: "
                           "train_step ")
    for name in ("data_wait", "visual", "bn_fwd", "textual",
                 "backward_textual", "backward", "optimizer"):
        assert f" {name} " in line
    assert line.endswith("/-")  # no card: no device ms


def test_notes_keep_values_of_a_session_and_reset_with_it(parts):
    shape = (1280, 256, 49, 32, 64)
    tracing.note("decode_attention", shape)  # off: kept nowhere
    assert tracing.notes("decode_attention") == []

    def launches():
        with tracing.span("caption"):
            tracing.note("decode_attention", shape)
            tracing.note("decode_attention", (1280, 1280, 1, 32, 64))
    _profiled(launches)
    assert tracing.notes("decode_attention") == [shape,
                                                 (1280, 1280, 1, 32, 64)]
    assert tracing.notes("other") == []
    assert tracing.summary()["caption"]["count"] == 1
    tracing.note("decode_attention", shape)  # off: the session stays
    assert len(tracing.notes("decode_attention")) == 2
    _profiled(_caption(parts))  # a new session: no note in it on the CPU
    assert tracing.notes("decode_attention") == []
    assert tracing.summary()["caption"]["count"] == 1


def test_a_note_starts_a_session_afresh_as_a_span_does():
    with tracing.span("between sessions"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.note("decode_attention", (1, 1, 1, 1, 8))
        with tracing.span("caption"):
            pass
    assert tracing.notes("decode_attention") == [(1, 1, 1, 1, 8)]
    assert [r.name for r in tracing.records()] == ["caption"]
    tracing.note("decode_attention", (2, 2, 2, 2, 8))  # off: marks it stale
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.note("decode_attention", (3, 3, 3, 3, 8))
    assert tracing.notes("decode_attention") == [(3, 3, 3, 3, 8)]
    assert tracing.records() == []
