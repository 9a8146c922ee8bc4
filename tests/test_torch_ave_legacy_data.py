"""The LAVisH input (avmoe_tpu_torch/data/ave.py) and the AVE command line's
legacy models, on the CPU.

  * `wave_to_lavish_spec` against the JAX package's, the differences taken
    in float64, at 16 kHz (the fbank's default) and at the rate the command
    line passes (`cfg.htsat.frontend.sample_rate`), for segments longer and
    shorter than the image's frames;
  * `LAVisHView`'s keys and shapes;
  * `cli/train_ave.main` with `--model v1` and `--model lavish` at `--tiny
    --synthetic --device cpu`: two epochs, `--mode test` (its accuracy is
    best.json's, the best evaluation's), `--resume` for a third epoch. The
    command line's tiny config is cut to Swin 1-1-3-1 / HTS-AT 1-1-1-1 for
    these runs (`_cut_depths`): nothing they check depends on the depth.

No JAX but in the spectrogram comparison.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from avmoe_tpu_torch.cli import train_ave
from avmoe_tpu_torch.config import AVEConfig, tiny_ave_config
from avmoe_tpu_torch.data.ave import LAVisHView, SyntheticAVEDataset, wave_to_lavish_spec

torch.set_num_threads(2)

TINY = ["--tiny", "--synthetic", "--device", "cpu", "--no-bf16", "--batch_size", "1",
        "--accum_itr", "2", "--num_workers", "2", "--decay_epoch", "1"]


@pytest.mark.parametrize("sample_rate, length", [
    (16_000, 32_000),          # 381 frames, cut to 192
    (AVEConfig().htsat.frontend.sample_rate, 32_000),   # 188 frames, padded
    (tiny_ave_config().htsat.frontend.sample_rate, 4_000),
])
def test_lavish_spec_matches_jax(sample_rate, length):
    pytest.importorskip("jax")
    from avmoe_tpu.data.ave import wave_to_lavish_spec as jax_spec

    wave = np.random.RandomState(length).randn(3, length).astype(np.float32) * 0.1
    ours = wave_to_lavish_spec(wave, sample_rate=sample_rate)
    ref = jax_spec(wave, sample_rate=sample_rate)
    assert ours.shape == ref.shape == (3, 192, 192) and ours.dtype == np.float32
    d = np.abs(ours.astype(np.float64) - ref.astype(np.float64))
    assert d.max() <= 1e-6 * (1.0 + np.abs(ref).max()), d.max()
    hop = int(sample_rate * 5.2 / 1000)
    frames = 1 + (length - int(sample_rate * 0.025)) // hop
    if frames < 192:
        assert not ours[:, frames:].any() and ours[:, frames - 1].any()


def test_lavish_view_replaces_the_wave_by_the_fbank_image():
    base = SyntheticAVEDataset(length=3, num_segments=2, audio_len=4000, img_size=64)
    view = LAVisHView(base, sample_rate=32_000, size=64)
    assert len(view) == 3
    item, raw = view[1], base[1]
    assert set(item) == {"audio_spec", "images", "labels"}
    assert item["audio_spec"].shape == (2, 64, 64) and item["audio_spec"].dtype == np.float32
    np.testing.assert_array_equal(item["audio_spec"],
                                  wave_to_lavish_spec(raw["wave"], sample_rate=32_000, size=64))
    np.testing.assert_array_equal(item["images"], raw["images"])
    np.testing.assert_array_equal(item["labels"], raw["labels"])


@pytest.fixture(scope="module", autouse=True)
def _cut_depths():
    """`--tiny` as Swin 1-1-3-1 / HTS-AT 1-1-1-1 (the tiny depths, Swin
    2-2-18-2, made the four command-line runs of this file ~60 s)."""
    def cut():
        cfg = tiny_ave_config()
        return dataclasses.replace(
            cfg, swin=dataclasses.replace(cfg.swin, depths=(1, 1, 3, 1)),
            htsat=dataclasses.replace(cfg.htsat, depths=(1, 1, 1, 1)))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_ave, "tiny_ave_config", cut)
        yield


@pytest.fixture(scope="module", params=["v1", "lavish"])
def trained(request, tmp_path_factory):
    model = request.param
    ck = str(tmp_path_factory.mktemp(f"ave_cli_{model}"))
    argv = TINY + ["--model", model, "--model_save_dir", ck]
    best = train_ave.main(argv + ["--epochs", "2"])
    return dict(ck=ck, best=best, argv=argv, model=model)


def test_legacy_model_trains_and_saves(trained):
    with open(os.path.join(trained["ck"], "best.json")) as f:
        best = json.load(f)
    assert best["metric"] == trained["best"] and np.isfinite(trained["best"])
    steps = sorted(int(d) for d in os.listdir(trained["ck"]) if d.isdigit())
    assert best["step"] in steps and set(steps) <= {8, 16}
    # no expert telemetry: the legacy models route nothing
    assert not [n for n in os.listdir(trained["ck"]) if n.startswith("expert_stats_")]


def test_legacy_model_test_mode_equals_the_best_evaluation(trained):
    """--mode test restores the latest step, the best one (saves happen on
    improvement only), and evaluates the same validation set."""
    with open(os.path.join(trained["ck"], "best.json")) as f:
        best = json.load(f)
    steps = sorted(int(d) for d in os.listdir(trained["ck"]) if d.isdigit())
    assert steps[-1] == best["step"]
    acc = train_ave.main(trained["argv"] + ["--mode", "test"])
    assert acc == best["metric"]


def test_legacy_model_resumes_for_a_third_epoch(trained, capsys):
    capsys.readouterr()
    with open(os.path.join(trained["ck"], "best.json")) as f:
        step = json.load(f)["step"]
    train_ave.main(trained["argv"] + ["--resume", "--epochs", "3"])
    text = capsys.readouterr().err
    assert f"resumed from step {step}" in text
    done = [e for e in (1, 2, 3) if f"epoch {e} done" in text]
    assert done and done[-1] == 3 and min(done) == step // 8 + 1
    loss = float(text.split("epoch 3 done")[1].split("train_loss ")[1].split()[0])
    assert np.isfinite(loss)
