"""The port's AVVP command line, `avmoe_tpu_torch.cli.train_avvp`, end to end
on the CPU at the tiny and mini sizes: train for two epochs, evaluate the
best checkpoint with `--mode test`, resume for the epoch after the latest
checkpoint's; the mini config through the on-disk LLP reader and its
annotation CSVs; the flags against the JAX CLI's.

No JAX computation: the JAX CLI's flow is what these runs follow, its parts
are held against the JAX package in tests/test_torch_avvp*.py and
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

from avmoe_tpu_torch.cli import train_avvp

ROOT = pathlib.Path(__file__).resolve().parent.parent
torch.set_num_threads(2)

TINY = ["--tiny", "--synthetic", "--device", "cpu", "--no-bf16", "--batch_size", "1",
        "--accum_itr", "2", "--num_workers", "2"]
F1_KEYS = {"seg_a", "seg_v", "seg_av", "seg_type_avg", "seg_event_avg", "event_a", "event_v",
           "event_av", "event_type_avg", "event_event_avg"}


def _stats(directory) -> dict:
    return {n: np.load(os.path.join(directory, n)) for n in sorted(os.listdir(directory))
            if n.startswith("expert_stats_")}


def _steps(directory) -> list:
    return sorted(int(d) for d in os.listdir(directory) if d.isdigit())


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("avvp_cli"))
    summary = train_avvp.main(TINY + ["--epochs", "2", "--model_save_dir", ck])
    return dict(ck=ck, summary=summary, stats=_stats(ck))


def test_train_writes_checkpoints_and_telemetry(trained):
    ck = trained["ck"]
    with open(os.path.join(ck, "best.json")) as f:
        best = json.load(f)
    assert set(trained["summary"]) == F1_KEYS
    assert best["metric"] == trained["summary"]["seg_type_avg"]
    assert best["step"] == max(_steps(ck)) and set(_steps(ck)) <= {8, 16}
    stats = trained["stats"]
    assert len(stats) == 12
    for key in ("audio_p1", "audio_p2", "video_p1", "video_p2"):
        probs = stats[f"expert_stats_{key}_mean_gating_probs.npy"]
        assert probs.shape == (12, 2)                  # sites in all four stages, experts
        np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)
        counts = stats[f"expert_stats_{key}_activation_counts.npy"]
        assert counts.sum() == 12 * 2 * 2              # sites x (val clips x segments)


def test_test_mode_reproduces_the_best_checkpoint(trained):
    """--mode test restores the latest step (saves happen on improvement
    only, so it is the best) and evaluates the same clips: best.json's F1."""
    ck = trained["ck"]
    with open(os.path.join(ck, "best.json")) as f:
        best = json.load(f)
    summary = train_avvp.main(TINY + ["--mode", "test", "--model_save_dir", ck])
    assert summary["seg_type_avg"] == best["metric"]
    if best["step"] == 16:     # the last epoch's eval made the train run's statistics
        for name, arr in _stats(ck).items():
            np.testing.assert_array_equal(arr, trained["stats"][name], err_msg=name)


def test_resume_runs_the_next_epoch(trained, capsys):
    ck = trained["ck"]
    latest = max(_steps(ck))
    # checkpoints are saved on improvement only: the run continues after the
    # latest one's epoch (8 steps an epoch)
    epoch = latest // 8 + 1
    capsys.readouterr()
    train_avvp.main(TINY + ["--resume", "--epochs", str(epoch), "--model_save_dir", ck])
    text = capsys.readouterr().err     # main's logging.basicConfig writes to stderr
    assert f"resumed from step {latest}" in text
    assert [e for e in (1, 2, 3) if f"epoch {e}: loss" in text] == [epoch]
    assert np.isfinite(float(text.split(f"epoch {epoch}: loss ")[1].split()[0]))
    assert max(_steps(ck)) >= latest


def test_mini_config_through_the_on_disk_reader(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "make_mini_datasets", ROOT / "tools" / "make_mini_datasets.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    data = tmp_path / "llp"
    mod.make_avvp(str(data), n=4, img=48)
    ck = str(tmp_path / "ck")
    paths = [f"--{flag}={data / name}" for flag, name in (
        ("label_train", "train.csv"), ("label_val", "val.csv"),
        ("eval_audio_csv", "AVVP_eval_audio.csv"), ("eval_visual_csv", "AVVP_eval_visual.csv"))]
    summary = train_avvp.main(["--mini", "--data_root", str(data), *paths, "--device", "cpu",
                               "--no-bf16", "--batch_size", "2", "--accum_itr", "1",
                               "--epochs", "1", "--num_workers", "2", "--model_save_dir", ck])
    assert set(summary) == F1_KEYS and all(np.isfinite(v) for v in summary.values())
    with open(os.path.join(ck, "best.json")) as f:
        assert json.load(f) == {"step": 1, "metric": summary["seg_type_avg"]}


def test_without_a_card_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        train_avvp.main(["--tiny", "--synthetic", "--model_save_dir", str(tmp_path)])


def test_flags_and_defaults_match_jax(monkeypatch):
    """The port's flags are the JAX CLI's, with the same defaults, plus
    --bf16 / --no-bf16 and --device."""
    jax_cli = pytest.importorskip("avmoe_tpu.cli.train_avvp")
    monkeypatch.setattr(sys, "argv", ["train_avvp"])
    want = vars(jax_cli.parse_args())
    got = vars(train_avvp.parse_args([]))
    assert (got.pop("device"), got.pop("bf16")) == ("cuda", True)
    assert got == want
