"""Audio front end: waveform -> log-mel -> HTS-AT spectrogram image.

Counterpart of `avmoe_tpu/audio/frontend.py`. The constant matrices are
built once on the host with numpy (own copies of the JAX package's
builders); the transforms are GEMMs against them:

  * STFT as frames @ windowed real-DFT basis (center=True, reflect pad);
  * Slaney mel filterbank as a matmul, then power_to_db;
  * torch-compatible bicubic (align_corners=True) time stretch as a matmul,
    then the HTS-AT frequency fold as reshapes;
  * train-time augmentation: SpecAugment stripes and batch mixup. The random
    draws (`stripe_mask`, `get_mix_lambda`) take an explicit generator; the
    ops themselves (`apply_spec_augment`, `mixup`) take the masks and λ.

`mel_filterbank_htk` (`avmoe_tpu/audio/frontend.py:75-100`) is VGGish's
HTK-scale filterbank (`backbones/vggish.py` `waveform_to_examples`).
`LogMelFrontend` bundles `log_mel_spectrogram` and `reshape_wav2img` as the
JAX module's class does.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from avmoe_tpu_torch.config import AudioFrontendConfig
from avmoe_tpu_torch.parallel.mesh import (broadcast_from_main, gather_batch, local_slice,
                                          world_size)


@functools.lru_cache(maxsize=None)
def _dft_basis(n_fft: int, win_length: int) -> Tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT basis: (n_fft, n_freq) cos / sin matrices
    (periodic hann window, as torchlibrosa's conv STFT)."""
    n_freq = n_fft // 2 + 1
    window = np.hanning(win_length + 1)[:-1]
    if win_length < n_fft:
        pad = (n_fft - win_length) // 2
        window = np.pad(window, (pad, n_fft - win_length - pad))
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_freq)[None, :]
    angle = 2.0 * np.pi * n * k / n_fft
    cos_basis = (np.cos(angle) * window[:, None]).astype(np.float32)
    sin_basis = (-np.sin(angle) * window[:, None]).astype(np.float32)
    return cos_basis, sin_basis


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    """Slaney mel scale (librosa htk=False)."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3.0
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    mels)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3.0
    freqs = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@functools.lru_cache(maxsize=None)
def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int, fmin: float,
                   fmax: float) -> np.ndarray:
    """(n_freq, n_mels) Slaney-normalized triangular mel filterbank
    (librosa.filters.mel(htk=False, norm='slaney'))."""
    n_freq = n_fft // 2 + 1
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, n_freq)
    mel_pts = np.linspace(_hz_to_mel(np.array(fmin)), _hz_to_mel(np.array(fmax)), n_mels + 2)
    mel_f = _mel_to_hz(mel_pts)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    weights = np.zeros((n_mels, n_freq), dtype=np.float64)
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights.T.astype(np.float32)


def _hz_to_mel_htk(f) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m) -> np.ndarray:
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=None)
def mel_filterbank_htk(sample_rate: int, n_fft: int, n_mels: int, fmin: float,
                       fmax: float) -> np.ndarray:
    """(n_freq, n_mels) HTK-scale unnormalized triangular filterbank of the
    VGGish front end: float64 arithmetic, rounded to float32; the DC row is
    zero."""
    n_freq = n_fft // 2 + 1
    spectrogram_mels = _hz_to_mel_htk(np.linspace(0.0, sample_rate / 2.0, n_freq))
    band_edges = np.linspace(_hz_to_mel_htk(fmin), _hz_to_mel_htk(fmax), n_mels + 2)
    weights = np.zeros((n_freq, n_mels), dtype=np.float64)
    for i in range(n_mels):
        lo, center, hi = band_edges[i: i + 3]
        lower = (spectrogram_mels - lo) / (center - lo)
        upper = (hi - spectrogram_mels) / (hi - center)
        weights[:, i] = np.maximum(0.0, np.minimum(lower, upper))
    weights[0, :] = 0.0
    return weights.astype(np.float32)


def _cubic_kernel(s: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution kernel (torch bicubic uses a=-0.75)."""
    s = np.abs(s)
    return np.where(
        s <= 1.0,
        (a + 2.0) * s**3 - (a + 3.0) * s**2 + 1.0,
        np.where(s < 2.0, a * s**3 - 5.0 * a * s**2 + 8.0 * a * s - 4.0 * a, 0.0),
    )


@functools.lru_cache(maxsize=None)
def bicubic_resize_matrix(in_size: int, out_size: int,
                          align_corners: bool = True) -> np.ndarray:
    """(out_size, in_size) matrix of torch's 1-D bicubic interpolation with
    border clamping."""
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    scale = (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
    for i in range(out_size):
        x = i * scale if align_corners else (i + 0.5) * in_size / out_size - 0.5
        x0 = int(np.floor(x))
        t = x - x0
        for offset in range(-1, 3):
            idx = int(np.clip(x0 + offset, 0, in_size - 1))
            mat[i, idx] += _cubic_kernel(np.array(offset - t))
    return mat.astype(np.float32)


def _const(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(arr).to(device=like.device, dtype=torch.float32)


def stft_power(wave: torch.Tensor, cfg: AudioFrontendConfig) -> torch.Tensor:
    """(B, L) waveform -> (B, T, n_freq) power spectrum, T = L // hop + 1."""
    cos_b, sin_b = _dft_basis(cfg.n_fft, cfg.win_length)
    basis = _const(np.concatenate([cos_b, sin_b], axis=1), wave)  # (n_fft, 2F)
    pad = cfg.n_fft // 2
    x = F.pad(wave[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, cfg.n_fft, cfg.hop_length)               # (B, T, n_fft)
    out = torch.matmul(frames, basis)                              # (B, T, 2F)
    n_freq = cfg.n_fft // 2 + 1
    real, imag = out[..., :n_freq], out[..., n_freq:]
    return real * real + imag * imag


def log_mel_spectrogram(wave: torch.Tensor, cfg: AudioFrontendConfig) -> torch.Tensor:
    """(B, L) waveform -> (B, T, n_mels) log-mel (power_to_db, top_db=None)."""
    power = stft_power(wave, cfg)
    mel = _const(mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels,
                                cfg.fmin, cfg.fmax), wave)
    mel_spec = torch.matmul(power, mel)
    log_spec = 10.0 * torch.log10(torch.clamp(mel_spec, min=cfg.amin))
    return log_spec - 10.0 * float(np.log10(max(cfg.ref, cfg.amin)))


def reshape_wav2img(spec: torch.Tensor, spec_size: int, freq_ratio: int) -> torch.Tensor:
    """(B, T, F) log-mel -> (B, spec_size, spec_size, 1) folded image with
    img[r*F + f, t] = spec[r*Tc + t, f] after the bicubic time stretch."""
    B, T, Fq = spec.shape
    target_t = spec_size * freq_ratio
    target_f = spec_size // freq_ratio
    if T < target_t:
        spec = torch.matmul(_const(bicubic_resize_matrix(T, target_t), spec), spec)
    if Fq < target_f:
        interp_f = _const(bicubic_resize_matrix(Fq, target_f), spec)
        spec = torch.matmul(spec, interp_f.t())
    x = spec.reshape(B, freq_ratio, spec_size, target_f)
    x = x.transpose(2, 3)
    x = x.reshape(B, freq_ratio * target_f, spec_size)
    return x[..., None]


def stripe_mask(generator: torch.Generator, batch: int, width: int, drop_width: int,
                num_stripes: int, device) -> torch.Tensor:
    """(batch, width) bool keep-mask with `num_stripes` zero stripes per row,
    each of a width drawn from [0, drop_width) at a start drawn from
    [0, width - stripe width] (torchlibrosa DropStripes)."""
    dist = torch.randint(0, drop_width, (batch, num_stripes), generator=generator,
                         device=device)
    u = torch.rand((batch, num_stripes), generator=generator, device=device)
    bgn = torch.floor(u * (width - dist + 1).float()).long()
    pos = torch.arange(width, device=device)[None, None, :]
    dropped = (pos >= bgn[..., None]) & (pos < (bgn + dist)[..., None])
    return ~dropped.any(dim=1)


def apply_spec_augment(spec: torch.Tensor, tmask: torch.Tensor,
                       fmask: torch.Tensor) -> torch.Tensor:
    """(B, T, F) log-mel with time stripes tmask (B, T) and frequency
    stripes fmask (B, F) zeroed."""
    return spec * tmask[:, :, None].to(spec.dtype) * fmask[:, None, :].to(spec.dtype)


def spec_augment(generator: torch.Generator, spec: torch.Tensor,
                 cfg: AudioFrontendConfig) -> torch.Tensor:
    """SpecAugment time / frequency stripes on (B, T, F) log-mel (train only)."""
    B, T, Fq = spec.shape
    tmask = stripe_mask(generator, B, T, cfg.time_drop_width, cfg.time_stripes_num,
                        spec.device)
    fmask = stripe_mask(generator, B, Fq, cfg.freq_drop_width, cfg.freq_stripes_num,
                        spec.device)
    return apply_spec_augment(spec, tmask, fmask)


def mixup(x: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Batch mixup against the flipped batch: x λ + flip(x) (1 − λ), λ (B,).
    Under a process group the flip is the global batch's, as the JAX
    package's sharded flip is: a rank's partners are the mirrored rank's
    rows, reversed (gathered differentiably)."""
    lam = lam.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)
    partner = local_slice(torch.flip(gather_batch(x), dims=(0,)), x.shape[0])
    return x * lam + partner * (1.0 - lam)


def get_mix_lambda(generator: torch.Generator, alpha: float, batch: int,
                   device: Optional[torch.device] = None) -> torch.Tensor:
    """(batch,) float32 Beta(alpha, alpha) mixing weights. torch's Beta
    sampler takes no generator, so the draw is numpy's, seeded from
    `generator`. Under a process group `batch` is this rank's rows: every
    rank takes rank 0's seed, draws the global batch's weights and keeps
    its own slice, so that λ is one draw over the global batch, as the JAX
    package's is."""
    seed = broadcast_from_main(
        torch.randint(0, 2**31 - 1, (1,), generator=generator, device=generator.device))
    lam = np.random.default_rng(int(seed.item())).beta(
        alpha, alpha, batch * world_size()).astype(np.float32)
    lam = torch.from_numpy(lam).to(device if device is not None else generator.device)
    return local_slice(lam, batch)


class LogMelFrontend:
    """The wave -> folded-image pipeline of HTS-AT, bundled; counterpart of
    the JAX `LogMelFrontend`. Stateless: the BatchNorm over mel bins
    (`bn0`) has parameters and lives in the HTS-AT module."""

    def __init__(self, cfg: AudioFrontendConfig, spec_size: int):
        self.cfg = cfg
        self.spec_size = spec_size
        self.freq_ratio = spec_size // cfg.n_mels

    def __call__(self, wave: torch.Tensor) -> torch.Tensor:
        return log_mel_spectrogram(wave, self.cfg)

    def fold(self, spec: torch.Tensor) -> torch.Tensor:
        return reshape_wav2img(spec, self.spec_size, self.freq_ratio)
