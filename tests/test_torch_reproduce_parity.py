"""The port's closure rehearsal (``virtex_tpu_torch/scripts/
reproduce_parity.py``) on the CPU: the synthetic mode end to end at a
tiny model (fixtures written with the port's own JPEG encoder and
tokenizer trainer, the tokenizer self-checks, 4 pretraining iterations,
the checkpoint through ``model_zoo.get``, the feature bit-check written
and held, eval_captioning, clf_voc07 and clf_linear), a corrupted
tokenizer golden that must stop it with exit 1, and the real mode's
refusals."""
import json

import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from virtex_tpu_torch.scripts import reproduce_parity, tokenizer_selfcheck


def test_synthetic_rehearsal_runs_green(tmp_path, capsys):
    summary = reproduce_parity.rehearse(
        ["--device", "cpu", "--workdir", str(tmp_path / "parity")])
    out = capsys.readouterr().out
    assert "rehearsal complete" in out
    assert out.count("tokenizer_selfcheck: PASS") == 2
    assert "feature_bitcheck: PASS — virtex on cpu" in out
    assert "entries loaded through model_zoo.get" in out
    assert set(summary["seconds"]) == {
        "fixtures", "tokenizer_selfcheck", "sp_model", "pretrain", "load",
        "bitcheck", "eval_captioning", "clf_voc07", "clf_linear"}
    assert summary["pretrain"]["iteration"] == reproduce_parity.SYNTH_ITERATIONS
    assert set(summary["eval_captioning"]["metrics"]) == {"CIDEr", "SPICE"}
    assert 0.0 <= summary["clf_voc07"]["mAP"] <= 100.0
    assert 0.0 <= summary["clf_linear"]["value"] <= 100.0


def test_a_corrupted_tokenizer_golden_fails(tmp_path, monkeypatch, capsys):
    plain = tokenizer_selfcheck.write_golden

    def corrupted(path, model, encodings):
        encodings = [list(e) for e in encodings]
        encodings[3][1] += 1
        plain(path, model, encodings)

    monkeypatch.setattr(tokenizer_selfcheck, "write_golden", corrupted)
    rc = reproduce_parity.main(["--device", "cpu", "--workdir",
                                str(tmp_path / "parity")])
    out = capsys.readouterr().out
    assert rc == 1
    assert "MISMATCH caption[3]" in out
    assert "reproduce_parity: FAIL — tokenizer_selfcheck exited 1" in out
    assert "short pretrain" not in out
    with open(tmp_path / "parity" / "tok_golden.json") as f:
        assert len(json.load(f)["encodings"]) == len(
            tokenizer_selfcheck.PINNED_CAPTIONS)


@pytest.mark.parametrize("missing", ["--coco-root", "--zoo-dir"])
def test_real_mode_without_its_roots_exits_2(missing, tmp_path, capsys,
                                             monkeypatch):
    monkeypatch.delenv("VIRTEX_TPU_ZOO_DIR", raising=False)
    argv = ["--mode", "real", "--device", "cpu",
            "--workdir", str(tmp_path)]
    for flag in ("--coco-root", "--zoo-dir"):
        if flag != missing:
            argv += [flag, str(tmp_path)]
    with pytest.raises(SystemExit) as e:
        reproduce_parity.main(argv)
    assert e.value.code == 2
    assert "--mode real needs --coco-root and --zoo-dir" in \
        capsys.readouterr().out


def test_an_unknown_flag_exits_2():
    with pytest.raises(SystemExit) as e:
        reproduce_parity.main(["--mode", "real", "--coco"])
    assert e.value.code == 2


def test_no_card_raises_for_a_cuda_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        reproduce_parity.main(["--workdir", str(tmp_path)])
