"""The port's Kaldi fbank (avmoe_tpu_torch/audio/kaldi.py) and the data-prep
tools (cli/compute_audio_stats.py, cli/preprocess.py) against the JAX
package's, on the CPU. None of them imports JAX: the JAX package's
versions are numpy and subprocess code.

Tolerances, against JAX's numpy fbank (float64 math, float32 output) on
log energies up to ~15 in size: float64 rtol 1e-6, atol 1e-6 (measured max
|d| 4.8e-7, JAX's float32 rounding); float32 rtol 1e-5, atol 5e-4
(measured 7.3e-5). The silence floor log(EPSILON) is exact in both.
"""

from __future__ import annotations

import os
import re
import stat
import sys

import numpy as np
import pytest
import torch

from avmoe_tpu.audio import kaldi as jkaldi
from avmoe_tpu.cli import compute_audio_stats as jstats
from avmoe_tpu.cli import preprocess as jprep

from avmoe_tpu_torch.audio import kaldi
from avmoe_tpu_torch.cli import compute_audio_stats, preprocess

TOL = {torch.float64: dict(rtol=1e-6, atol=1e-6), torch.float32: dict(rtol=1e-5, atol=5e-4)}


def _waves(n: int, length: int, sr: float, seed: int) -> np.ndarray:
    """Noise and tones, at amplitudes from 1e-3 to 1."""
    rng = np.random.RandomState(seed)
    t = np.arange(length) / sr
    out = []
    for i in range(n):
        amp = 10.0 ** rng.uniform(-3, 0)
        tone = np.sin(2 * np.pi * rng.uniform(100, sr / 3) * t)
        out.append(amp * (0.5 * rng.randn(length) + tone))
    return np.stack(out)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("sr", [16_000.0, 32_000.0])
@pytest.mark.parametrize("window", ["hanning", "povey", "hamming"])
def test_fbank_matches_jax(window, sr, dtype):
    waves = _waves(3, int(sr * 0.6) + 17, sr, seed=int(sr) % 7 + len(window))
    kw = dict(sample_frequency=sr, num_mel_bins=64, frame_shift_ms=5.2, window_type=window)
    ours = kaldi.fbank(torch.from_numpy(waves).to(dtype), **kw)
    assert ours.dtype == dtype and ours.shape[0] == 3
    for i in range(3):
        want = jkaldi.fbank(waves[i], **kw)
        assert ours[i].shape == want.shape
        np.testing.assert_allclose(ours[i].double().numpy(), want, **TOL[dtype])
        single = kaldi.fbank(torch.from_numpy(waves[i]).to(dtype), **kw)
        assert torch.equal(single, ours[i])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_fbank_silence_floor_is_exact(dtype):
    ours = kaldi.fbank(torch.zeros(2, 8000, dtype=dtype), num_mel_bins=23)
    want = jkaldi.fbank(np.zeros(8000), num_mel_bins=23)
    assert np.array_equal(ours.float().numpy()[0], want)
    assert (ours.float() == np.float32(np.log(kaldi.EPSILON))).all()


@pytest.mark.parametrize("length", [399, 400, 483, 16_000])
def test_fbank_framing_arithmetic(length):
    """A 5.2-ms shift at 16 kHz is int(83.2) = 83 samples; snip edges; fewer
    samples than a 25-ms frame give no frames."""
    kw = dict(sample_frequency=16_000.0, num_mel_bins=192, frame_shift_ms=5.2)
    wave = _waves(1, length, 16_000.0, seed=length)
    ours = kaldi.fbank(torch.from_numpy(wave), **kw)
    want = jkaldi.fbank(wave[0], **kw)
    assert ours.shape == (1,) + want.shape
    assert want.shape[0] == (0 if length < 400 else 1 + (length - 400) // 83)


def test_mel_banks_equal_jax():
    for args in ((40, 512, 16_000.0), (192, 512, 16_000.0), (128, 1024, 32_000.0, 50.0, -200.0)):
        ours = kaldi.kaldi_mel_banks(*args)
        assert ours.dtype == torch.float32
        assert np.array_equal(ours.numpy(), jkaldi.kaldi_mel_banks(*args))
    assert kaldi.kaldi_mel_banks(40, 512, 16_000.0, dtype=torch.float64).dtype == torch.float64


# ---------------------------------------------------------- compute_audio_stats


def _packs(directory, lengths, seed: int) -> None:
    os.makedirs(directory, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i, n in enumerate(lengths):
        pack = _waves(1, n, 16_000.0, seed + i).astype(np.float32).reshape(2, -1)
        np.save(os.path.join(directory, f"clip{i:03d}.npy"), pack * rng.uniform(0.2, 1.0))


def _jax_stats(monkeypatch, capsys, argv):
    monkeypatch.setattr(sys, "argv", ["compute_audio_stats"] + argv)
    jstats.main()
    line = capsys.readouterr().out.strip().splitlines()[-1]
    m = re.fullmatch(r"dataset fbank mean=(\S+) std=(\S+) over (\d+) values", line)
    return float(m.group(1)), float(m.group(2)), int(m.group(3))


@pytest.mark.parametrize("limit", [0, 5])
def test_compute_audio_stats_matches_jax(tmp_path, monkeypatch, capsys, limit):
    """Packs of two lengths, so a batch ends where the length changes, and
    more packs than a batch holds. JAX prints 6 decimals: atol 1e-6."""
    monkeypatch.setattr(compute_audio_stats, "PACKS_PER_BATCH", 4)
    _packs(tmp_path / "wave", [8000] * 6 + [6400] * 3, seed=3)
    argv = ["--wave_dir", str(tmp_path / "wave"), "--limit", str(limit)]
    mean, std, count = _jax_stats(monkeypatch, capsys, argv)
    ours = compute_audio_stats.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == f"dataset fbank mean={ours[0]:.6f} std={ours[1]:.6f} over {count} values"
    np.testing.assert_allclose(ours, (mean, std), rtol=0, atol=1e-6)
    assert out[0].startswith("[")           # the running line of file 0


def test_compute_audio_stats_needs_packs(tmp_path):
    with pytest.raises(FileNotFoundError, match="no .npy files under"):
        compute_audio_stats.main(["--wave_dir", str(tmp_path), "--device", "cpu"])


# ------------------------------------------------------------------ preprocess


FAKE_FFMPEG = """#!{python}
# stands in for ffmpeg: frames for -vf, else a 16-bit mono wav of a length
# set by the input's name, its samples a function of the name
import os, sys, wave
import numpy as np
a = sys.argv[1:]
src, out = a[a.index("-i") + 1], a[-1]
if "-vf" in a:
    for k in range(1, 4):
        with open(out % k, "wb") as f:
            f.write(("frame %d of %s" % (k, os.path.basename(src))).encode())
else:
    rate = int(a[a.index("-ar") + 1])
    seconds = float(os.path.basename(src).split("_")[0])
    seed = sum(map(ord, os.path.basename(src)))
    data = np.random.RandomState(seed).randint(-32768, 32767, int(seconds * rate))
    with wave.open(out, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(data.astype("<i2").tobytes())
"""


@pytest.fixture
def fake_ffmpeg(tmp_path, monkeypatch):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    exe = bindir / "ffmpeg"
    exe.write_text(FAKE_FFMPEG.replace("{python}", sys.executable))
    exe.chmod(exe.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    videos = tmp_path / "videos"
    videos.mkdir()
    for name in ("2.5_a.mp4", "7_b.mkv", "4_c.webm", "notes.txt"):
        (videos / name).write_bytes(b"")
    return videos


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def test_preprocess_writes_the_packs_jax_writes(tmp_path, fake_ffmpeg, monkeypatch, capsys):
    """Byte-identical frames and .npy packs (a short clip padded, two longer
    ones sampled at evenly spaced starts), no wav left, the same messages."""
    argv = ["--video_dir", str(fake_ffmpeg), "--num_segments", "5", "--sample_rate", "800"]
    monkeypatch.setattr(sys, "argv", ["preprocess"] + argv + ["--out_dir", str(tmp_path / "j")])
    jprep.main()
    jout = capsys.readouterr().out.replace(str(tmp_path / "j"), "OUT")
    preprocess.main(argv + ["--out_dir", str(tmp_path / "p")])
    pout = capsys.readouterr().out.replace(str(tmp_path / "p"), "OUT")
    theirs, ours = _tree(tmp_path / "j"), _tree(tmp_path / "p")
    assert sorted(ours) == sorted(theirs)
    assert sum(k.endswith(".npy") for k in ours) == 3 and not any(k.endswith(".wav") for k in ours)
    assert all(ours[k] == theirs[k] for k in ours)
    assert pout == jout
    pack = np.load(tmp_path / "p" / "wave" / "2.5_a.npy")
    assert pack.shape == (5, 800) and pack.dtype == np.float32 and not pack[-1].any()


def test_preprocess_without_ffmpeg_exits_with_the_jax_message(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(SystemExit) as ours:
        preprocess.main(["--video_dir", str(tmp_path), "--out_dir", str(tmp_path / "o")])
    monkeypatch.setattr(sys, "argv", ["preprocess", "--video_dir", str(tmp_path),
                                      "--out_dir", str(tmp_path / "o")])
    with pytest.raises(SystemExit) as theirs:
        jprep.main()
    assert str(ours.value) == str(theirs.value) and "ffmpeg" in str(ours.value)
