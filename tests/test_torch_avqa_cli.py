"""The port's AVQA command line, `avmoe_tpu_torch.cli.train_avqa`, end to end
on the CPU at the tiny and mini sizes: stage A (`--stage grounding`) for an
epoch, stage B (`--stage avst`) for two with the stage-A heads grafted in
through `--grounding_ckpt`, then resumed for the epoch after the latest
checkpoint's; the mini config through the on-disk MUSIC-AVQA reader with
its shipped vocab files; the flags against the JAX CLI's.

No JAX computation: the JAX CLI's flow is what these runs follow, its parts
are held against the JAX package in tests/test_torch_avqa*.py and
tests/test_torch_task_data.py.
"""

from __future__ import annotations

import importlib.util
import json
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

from avmoe_tpu_torch.checkpoint.manager import CheckpointManager
from avmoe_tpu_torch.cli import train_avqa

ROOT = pathlib.Path(__file__).resolve().parent.parent
torch.set_num_threads(2)

TINY = ["--tiny", "--synthetic", "--device", "cpu", "--no-bf16", "--batch_size", "1",
        "--accum_itr", "2", "--num_workers", "2"]
HEADS = ("fc_a1", "fc_a2", "fc_gl", "fc1", "fc2", "fc3", "fc4")


def _steps(directory) -> list:
    return sorted(int(d) for d in os.listdir(directory) if d.isdigit())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Stage A for one epoch, then stage B for two from its checkpoint
    directory; the fusion model's heads are read when its train state is
    made, before the first step."""
    grd = str(tmp_path_factory.mktemp("avqa_grounding"))
    avst = str(tmp_path_factory.mktemp("avqa_avst"))
    grd_best = train_avqa.main(TINY + ["--stage", "grounding", "--epochs", "1",
                                       "--model_save_dir", grd])
    seen = {}
    make_state = train_avqa.create_train_state

    def spy(model, *a, **k):
        seen.update({n: t.detach().clone() for n, t in model.state_dict().items()
                     if n.split(".")[0] in HEADS + ("fc_ans",)})
        return make_state(model, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_avqa, "create_train_state", spy)
        avst_best = train_avqa.main(TINY + ["--epochs", "2", "--grounding_ckpt", grd,
                                            "--model_save_dir", avst])
    return dict(grd=grd, avst=avst, grd_best=grd_best, avst_best=avst_best, heads=seen)


def test_grounding_stage_trains_the_heads_only(runs):
    grd = runs["grd"]
    with open(os.path.join(grd, "best.json")) as f:
        best = json.load(f)
    assert best == {"step": 8, "metric": runs["grd_best"]}        # 8 clips at batch 1
    assert runs["grd_best"] < 0 and np.isfinite(runs["grd_best"])  # the negated loss
    payload = CheckpointManager(grd).load()
    assert [n.split(".")[0] for n, _ in payload["trainable"]] == [
        h for h in HEADS for _ in ("weight", "bias")]
    assert not [n for n in os.listdir(grd) if n.startswith("expert_stats_")]


def test_avst_starts_from_the_grafted_heads(runs):
    """Before the first step the seven grounding heads equal the stage-A
    checkpoint's bit for bit; fc_ans (not grafted) keeps its own init."""
    donor = CheckpointManager(runs["grd"]).load()["model"]
    heads = runs["heads"]
    assert {n.split(".")[0] for n in heads} == set(HEADS) | {"fc_ans"}
    for name, t in heads.items():
        if name.startswith("fc_ans"):
            assert name not in donor
        else:
            assert torch.equal(t, donor[name]), name


def test_avst_writes_checkpoints_and_telemetry(runs):
    avst = runs["avst"]
    with open(os.path.join(avst, "best.json")) as f:
        best = json.load(f)
    assert best["metric"] == runs["avst_best"] and 0.0 <= best["metric"] <= 100.0
    assert best["step"] == max(_steps(avst)) and set(_steps(avst)) <= {8, 16}
    stats = {n for n in os.listdir(avst) if n.startswith("expert_stats_")}
    assert len(stats) == 12
    probs = np.load(os.path.join(avst, "expert_stats_audio_p1_mean_gating_probs.npy"))
    assert probs.shape == (12, 3)                # sites, the three experts
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)


def test_resume_runs_the_next_epoch(runs, capsys):
    avst = runs["avst"]
    latest = max(_steps(avst))
    epoch = latest // 8 + 1           # the one after the latest checkpoint's
    capsys.readouterr()
    train_avqa.main(TINY + ["--resume", "--epochs", str(epoch), "--model_save_dir", avst])
    text = capsys.readouterr().err     # main's logging.basicConfig writes to stderr
    assert f"resumed from step {latest}" in text
    assert [e for e in (1, 2, 3) if f"epoch {e}: loss" in text] == [epoch]
    assert "per-type" in text and "[' Audio', ' Counting']" in text


def test_mini_config_through_the_on_disk_reader(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "make_mini_datasets", ROOT / "tools" / "make_mini_datasets.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    data = tmp_path / "avqa"
    mod.make_avqa(str(data), n=4, img=48)
    ck = str(tmp_path / "ck")
    best = train_avqa.main(["--mini", "--data_root", str(data), "--label_train",
                            "avqa-train.json", "--label_val", "avqa-val.json", "--device", "cpu",
                            "--no-bf16", "--batch_size", "2", "--accum_itr", "1", "--epochs",
                            "1", "--num_workers", "1", "--model_save_dir", ck])
    assert 0.0 <= best <= 100.0
    with open(os.path.join(ck, "best.json")) as f:
        assert json.load(f) == {"step": 1, "metric": best}


def test_without_a_card_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        train_avqa.main(["--tiny", "--synthetic", "--model_save_dir", str(tmp_path)])


def test_flags_and_defaults_match_jax(monkeypatch):
    """The port's flags are the JAX CLI's, with the same defaults, plus
    --bf16 / --no-bf16 and --device."""
    jax_cli = pytest.importorskip("avmoe_tpu.cli.train_avqa")
    monkeypatch.setattr(sys, "argv", ["train_avqa"])
    want = vars(jax_cli.parse_args())
    got = vars(train_avqa.parse_args([]))
    assert (got.pop("device"), got.pop("bf16")) == ("cuda", True)
    assert got == want
