"""The port's AVE command line, `avmoe_tpu_torch.cli.train_ave`, end to end
on the CPU at the tiny and mini sizes: train for two epochs, evaluate the
best checkpoint with `--mode test`, resume for a third epoch; the mini
config through the on-disk reader; the flags' errors.

No JAX: the JAX CLI's flow is what these runs follow, its parts are held
against the JAX package in tests/test_torch_ave_{data,driver,heads}.py.
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

from avmoe_tpu_torch.cli import train_ave

ROOT = pathlib.Path(__file__).resolve().parent.parent
torch.set_num_threads(2)

TINY = ["--tiny", "--synthetic", "--device", "cpu", "--no-bf16", "--batch_size", "1",
        "--accum_itr", "2", "--num_workers", "2", "--decay_epoch", "1"]


def _stats(directory) -> dict:
    return {n: np.load(os.path.join(directory, n)) for n in sorted(os.listdir(directory))
            if n.startswith("expert_stats_")}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("ave_cli"))
    best = train_ave.main(TINY + ["--epochs", "2", "--model_save_dir", ck])
    return dict(ck=ck, best=best, stats=_stats(ck))


def test_train_writes_checkpoints_and_telemetry(trained):
    ck = trained["ck"]
    with open(os.path.join(ck, "best.json")) as f:
        best = json.load(f)
    assert best["metric"] == trained["best"]
    steps = sorted(int(d) for d in os.listdir(ck) if d.isdigit())
    assert best["step"] == max(steps) and set(steps) <= {8, 16} and len(steps) <= 3
    stats = trained["stats"]
    assert len(stats) == 12
    for key in ("audio_p1", "audio_p2", "video_p1", "video_p2"):
        probs = stats[f"expert_stats_{key}_mean_gating_probs.npy"]
        assert probs.shape == (8, 2)
        np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)
        counts = stats[f"expert_stats_{key}_activation_counts.npy"]
        assert counts.sum() == 8 * 2 * 2           # sites x (val clips x segments)


def test_test_mode_reproduces_the_best_checkpoint(trained):
    """--mode test restores the latest (best) step's weights and evaluates
    the same validation set: best.json's accuracy and, since the best step
    is the last epoch's, the same expert statistics bit for bit."""
    ck = trained["ck"]
    with open(os.path.join(ck, "best.json")) as f:
        best = json.load(f)
    assert best["step"] == 16     # the last epoch's save: its eval made the stats
    acc = train_ave.main(TINY + ["--mode", "test", "--model_save_dir", ck])
    assert acc == best["metric"]
    for name, arr in _stats(ck).items():
        np.testing.assert_array_equal(arr, trained["stats"][name], err_msg=name)


def test_resume_runs_the_next_epoch(trained, capsys):
    ck = trained["ck"]
    capsys.readouterr()
    train_ave.main(TINY + ["--resume", "--epochs", "3", "--model_save_dir", ck])
    text = capsys.readouterr().err     # main's logging.basicConfig writes to stderr
    assert "resumed from step 16" in text
    assert "epoch 3 done" in text and "epoch 1 done" not in text and "epoch 2 done" not in text
    loss = float(text.split("epoch 3 done")[1].split("train_loss ")[1].split()[0])
    assert np.isfinite(loss)
    steps = sorted(int(d) for d in os.listdir(ck) if d.isdigit())
    assert len(steps) <= 3 and max(steps) in (16, 24)


def test_mini_config_through_the_on_disk_reader(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "make_mini_datasets", ROOT / "tools" / "make_mini_datasets.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    data = tmp_path / "ave"
    mod.make_ave(str(data), n=4, img=48)
    ck = str(tmp_path / "ck")
    best = train_ave.main(["--mini", "--data_root", str(data), "--device", "cpu", "--no-bf16",
                           "--batch_size", "2", "--accum_itr", "1", "--epochs", "1",
                           "--num_workers", "2", "--model_save_dir", ck])
    assert np.isfinite(best)
    with open(os.path.join(ck, "best.json")) as f:
        assert json.load(f) == {"step": 1, "metric": best}
    assert len(_stats(ck)) == 12


def test_flag_errors(tmp_path):
    ck = str(tmp_path / "ck")
    with pytest.raises(SystemExit):            # v3, v1 and lavish are the models
        train_ave.main(TINY + ["--model", "v2", "--model_save_dir", ck])
    with pytest.raises(FileNotFoundError, match="labels.h5"):
        train_ave.main(["--data_root", "/nonexistent", "--tiny", "--device", "cpu",
                        "--model_save_dir", ck])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train_ave.main(["--tiny", "--synthetic", "--model_save_dir", ck])


def test_flags_and_defaults_match_jax(monkeypatch):
    """The port's flags are the JAX CLI's, with the same defaults, plus
    --device; --bf16 also takes --no-bf16."""
    jax_cli = pytest.importorskip("avmoe_tpu.cli.train_ave")
    monkeypatch.setattr(sys, "argv", ["train_ave"])
    want = vars(jax_cli.parse_args())
    got = vars(train_ave.parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == want
    assert train_ave.parse_args(["--no-bf16"]).bf16 is False


@pytest.mark.parametrize("flag, dtype", [("--bf16", torch.bfloat16), ("--no-bf16", torch.float32)])
def test_bf16_flag_reaches_the_model_through_the_train_config(monkeypatch, tmp_path, flag, dtype):
    """--bf16 sets TrainConfig.dtype, and the model is built in that dtype."""
    seen = {}

    class Built(Exception):
        pass

    def model(cfg, dtype, device, seed):
        seen.update(dtype=dtype, device=str(device), seed=seed)
        raise Built

    monkeypatch.setattr(train_ave, "AVEModel", model)
    with pytest.raises(Built):
        train_ave.main(["--tiny", "--synthetic", "--device", "cpu", flag, "--seed", "7",
                        "--model_save_dir", str(tmp_path)])
    assert seen == {"dtype": dtype, "device": "cpu", "seed": 7}
