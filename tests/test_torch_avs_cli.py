"""The port's AVS command line, `avmoe_tpu_torch.cli.train_avs`, end to end on
the CPU at the tiny and mini sizes: S4 trains for two epochs (HTS-AT
training), `--mode test --save_pred_mask` evaluates the best checkpoint and
writes its masks, `--resume` runs the epoch after the latest checkpoint's;
MS3 trains and tests (these runs at `--tiny` with both backbones cut to
depths 1-1-1-1, `_main`: nothing they check depends on the depth); the mini
configs through the on-disk S4 and MS3 readers; `build_config` field by
field and the flags against the JAX CLI's.

No JAX computation: the JAX CLI's flow is what these runs follow, its parts
are held against the JAX package in tests/test_torch_avs*.py and
tests/test_torch_task_data.py.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

from avmoe_tpu_torch.checkpoint.manager import CheckpointManager
from avmoe_tpu_torch.cli import train_avs
from avmoe_tpu_torch.config import tiny_avs_config

ROOT = pathlib.Path(__file__).resolve().parent.parent
torch.set_num_threads(2)

TINY = ["--tiny", "--synthetic", "--device", "cpu", "--no-bf16", "--train_batch_size", "1",
        "--accum_itr", "2", "--num_workers", "2"]


def _main(argv):
    """`train_avs.main(argv)` with `--tiny` as both backbones at depths
    1-1-1-1 (the tiny depths, Swin 2-2-18-2, made this file's runs ~40 s)."""
    def cut():
        cfg = tiny_avs_config()
        return dataclasses.replace(
            cfg, swin=dataclasses.replace(cfg.swin, depths=(1, 1, 1, 1)),
            htsat=dataclasses.replace(cfg.htsat, depths=(1, 1, 1, 1)))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_avs, "tiny_avs_config", cut)
        return train_avs.main(argv)


def _steps(directory) -> list:
    return sorted(int(d) for d in os.listdir(directory) if d.isdigit())


@pytest.fixture(scope="module")
def s4(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("avs_s4"))
    best = _main(TINY + ["--setting", "s4", "--max_epoches", "2",
                                  "--model_save_dir", ck])
    return dict(ck=ck, best=best)


def test_s4_trains_htsat_and_keeps_its_best_checkpoint(s4):
    ck = s4["ck"]
    with open(os.path.join(ck, "best.json")) as f:
        best = json.load(f)
    assert best["metric"] == s4["best"] and 0.0 <= s4["best"] <= 1.0
    assert best["step"] == max(_steps(ck)) and set(_steps(ck)) <= {4, 8}
    trainable = [n for n, _ in CheckpointManager(ck).load()["trainable"]]
    assert any(n.startswith("encoder.htsat.block_") for n in trainable)
    assert not any(n.startswith("encoder.swin.") and "_moe_" not in n for n in trainable)
    assert len([n for n in os.listdir(ck) if n.startswith("expert_stats_")]) == 12


def test_s4_archives_the_sources_before_training(s4):
    sources = pathlib.Path(s4["ck"]) / "sources"
    assert (sources / "cli" / "train_avs.py").is_file()
    assert (sources / "csrc" / "mlp_block.cu").is_file()
    assert not (sources / "avmoe_tpu").exists()


def test_s4_test_mode_saves_every_mask_and_reproduces_the_best(s4):
    """--mode test restores the latest (best) step: the same mIoU as
    best.json, and a PNG for each of the 2 validation clips' 2 frames."""
    ck = s4["ck"]
    with open(os.path.join(ck, "best.json")) as f:
        best = json.load(f)
    miou = _main(TINY + ["--setting", "s4", "--mode", "test", "--save_pred_mask",
                                  "--model_save_dir", ck])
    assert miou == best["metric"]
    masks = sorted(os.listdir(os.path.join(ck, "pred_masks")))
    assert masks == sorted(f"batch{b}_{j}.png" for b in range(2) for j in range(2))


def test_s4_resume_runs_the_next_epoch(s4, capsys):
    ck = s4["ck"]
    latest = max(_steps(ck))
    epoch = latest // 4 + 1           # the one after the latest checkpoint's
    capsys.readouterr()
    _main(TINY + ["--setting", "s4", "--resume", "--max_epoches", str(epoch),
                           "--model_save_dir", ck])
    text = capsys.readouterr().err     # main's logging.basicConfig writes to stderr
    assert f"resumed from step {latest}" in text
    assert [e for e in (1, 2, 3) if f"epoch {e}: loss" in text] == [epoch]


def test_ms3_trains_and_tests(tmp_path):
    ck = str(tmp_path)
    best = _main(TINY + ["--setting", "ms3", "--max_epoches", "1",
                                  "--model_save_dir", ck])
    trainable = [n for n, _ in CheckpointManager(ck).load()["trainable"]]
    assert not any(n.startswith("encoder.htsat.block_") for n in trainable)
    assert _main(TINY + ["--setting", "ms3", "--mode", "test",
                                  "--model_save_dir", ck]) == best
    assert not os.path.exists(os.path.join(ck, "pred_masks"))


@pytest.mark.parametrize("setting", ["s4", "ms3"])
def test_mini_config_through_the_on_disk_reader(tmp_path, setting):
    spec = importlib.util.spec_from_file_location(
        "make_mini_datasets", ROOT / "tools" / "make_mini_datasets.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    data = tmp_path / setting
    mod.make_avs(str(data), setting, n=4, img=48)
    ck = str(tmp_path / "ck")
    best = train_avs.main(["--mini", "--setting", setting, "--data_root", str(data),
                           "--device", "cpu", "--no-bf16", "--train_batch_size", "2",
                           "--accum_itr", "1", "--max_epoches", "1", "--num_workers", "1",
                           "--model_save_dir", ck])
    assert 0.0 <= best <= 1.0
    with open(os.path.join(ck, "best.json")) as f:
        assert json.load(f) == {"step": 1, "metric": best}


def test_without_a_card_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        train_avs.main(["--tiny", "--synthetic", "--model_save_dir", str(tmp_path)])


def test_flags_and_defaults_match_jax(monkeypatch):
    """The port's flags are the JAX CLI's, with the same defaults, plus
    --bf16 / --no-bf16 and --device."""
    jax_cli = pytest.importorskip("avmoe_tpu.cli.train_avs")
    monkeypatch.setattr(sys, "argv", ["train_avs"])
    want = vars(jax_cli.parse_args())
    got = vars(train_avs.parse_args([]))
    assert (got.pop("device"), got.pop("bf16")) == ("cuda", True)
    assert got == want


CONFIG_FLAGS = [
    [], ["--tiny"], ["--mini"], ["--setting", "ms3"], ["--setting", "ms3", "--tiny"],
    ["--setting", "ms3", "--mini"], ["--sa_loss_flag"], ["--setting", "ms3", "--no_sa_loss"],
    ["--sa_loss_flag", "--lambda_1", "0.3", "--sa_loss_kind", "euclidean", "--sa_norm_fea", "0",
     "--sa_threshold", "0", "--masked_av_stages", "1", "2", "--closer_loss"],
    ["--setting", "ms3", "--tpavi_stages", "0", "3", "--load_balancing_loss_weight", "0.5"],
    ["--setting", "ms3", "--sa_loss_kind", "cosine", "--sa_norm_fea", "1", "--sa_threshold", "1"],
    ["--tpavi_stages", "1", "--load_balancing_loss_weight", "0.02"],
]


@pytest.mark.parametrize("flags", CONFIG_FLAGS, ids=lambda f: " ".join(f) or "defaults")
def test_build_config_matches_jax_field_by_field(monkeypatch, flags):
    jax_cli = pytest.importorskip("avmoe_tpu.cli.train_avs")
    monkeypatch.setattr(sys, "argv", ["train_avs", *flags])
    want = dataclasses.asdict(jax_cli.build_config(jax_cli.parse_args()))
    got = dataclasses.asdict(train_avs.build_config(train_avs.parse_args(flags)))

    def same(a: dict, b: dict, path: str = "") -> None:
        for k, v in a.items():               # every field of the port's config
            if isinstance(v, dict):
                same(v, b[k], f"{path}{k}.")
            else:
                assert v == b[k], f"{path}{k}: {v!r} vs JAX {b[k]!r}"

    same(got, want)
