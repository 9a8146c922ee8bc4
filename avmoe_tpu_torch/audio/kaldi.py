"""Kaldi-compatible log-mel filterbank features, batched, on a given device.

Counterpart of `avmoe_tpu/audio/kaldi.py` (torchaudio.compliance.kaldi.fbank
as the reference's data loaders call it: htk_compat, hanning window, no
dither, use_energy=False): snip-edges framing, per-frame DC removal,
preemphasis 0.97, a power-of-two FFT, Kaldi's mel scale (1127 ln(1 +
f/700)), and the log of the mel energies floored at EPSILON. The JAX
package runs this on the host in numpy float64; here it runs in the
waveform's dtype and on its device, over (N, L) waveforms at once. The
data-prep path: the models' own front end is `audio/frontend.py`.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

EPSILON = 1.1920928955078125e-07  # torch.finfo(torch.float32).eps


def _mel(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


@functools.lru_cache(maxsize=None)
def _mel_banks_host(num_bins: int, fft_len: int, sample_rate: float, low_freq: float,
                    high_freq: float) -> np.ndarray:
    if high_freq <= 0.0:
        high_freq = sample_rate / 2.0 + high_freq
    num_fft_bins = fft_len // 2
    fft_bin_width = sample_rate / fft_len
    mel_low, mel_high = _mel(low_freq), _mel(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    out = np.zeros((num_bins, num_fft_bins), dtype=np.float64)
    bin_mels = _mel(fft_bin_width * np.arange(num_fft_bins))
    for b in range(num_bins):
        left = mel_low + b * mel_delta
        center = left + mel_delta
        right = center + mel_delta
        up = (bin_mels - left) / (center - left)
        down = (right - bin_mels) / (right - center)
        out[b] = np.clip(np.minimum(up, down), 0.0, None)
    return out.astype(np.float32)


def kaldi_mel_banks(num_bins: int, fft_len: int, sample_rate: float,
                    low_freq: float = 20.0, high_freq: float = 0.0, *,
                    device="cpu", dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(num_bins, fft_len // 2) triangular mel banks, Kaldi style (no
    normalisation, the DC bin dropped, the Nyquist bin left out), made in
    float64 and rounded to float32 as the JAX package's are, then given in
    `dtype` on `device`."""
    banks = _mel_banks_host(num_bins, fft_len, float(sample_rate), float(low_freq),
                            float(high_freq))
    return torch.from_numpy(banks).to(device=device, dtype=dtype)


def _window(window_type: str, win: int, device, dtype) -> torch.Tensor:
    n = torch.arange(win, device=device, dtype=torch.float64)
    cos = torch.cos(2 * math.pi * n / (win - 1))
    if window_type == "hanning":
        w = 0.5 - 0.5 * cos
    elif window_type == "povey":
        w = (0.5 - 0.5 * cos) ** 0.85
    elif window_type == "hamming":
        w = 0.54 - 0.46 * cos
    else:
        raise ValueError(window_type)
    return w.to(dtype)


def fbank(
    waveform: torch.Tensor,
    *,
    sample_frequency: float = 16_000.0,
    frame_length_ms: float = 25.0,
    frame_shift_ms: float = 10.0,
    num_mel_bins: int = 23,
    window_type: str = "hanning",
    preemphasis: float = 0.97,
    remove_dc_offset: bool = True,
    low_freq: float = 20.0,
    high_freq: float = 0.0,
) -> torch.Tensor:
    """(L,) or (N, L) waveforms -> (T, num_mel_bins) or (N, T, num_mel_bins)
    log mel energies, in the waveform's floating dtype (float32 or float64)
    on its device. Frame length and shift in samples are int() of the float
    products, as in Kaldi: a 5.2-ms shift at 16 kHz is 83 samples."""
    wave = waveform if waveform.is_floating_point() else waveform.float()
    batched = wave.dim() == 2
    wave = wave.reshape(wave.shape[0] if batched else 1, -1)
    dev, dt = wave.device, wave.dtype
    win = int(sample_frequency * frame_length_ms / 1000.0)
    hop = int(sample_frequency * frame_shift_ms / 1000.0)
    if wave.shape[1] < win:
        out = wave.new_zeros((wave.shape[0], 0, num_mel_bins))
        return out if batched else out[0]
    frames = wave.unfold(1, win, hop)                 # (N, T, win), snip edges
    if remove_dc_offset:
        frames = frames - frames.mean(dim=2, keepdim=True)
    if preemphasis:
        shifted = torch.cat([frames[..., :1], frames[..., :-1]], dim=2)
        frames = frames - preemphasis * shifted
    frames = frames * _window(window_type, win, dev, dt)
    fft_len = 2 ** int(math.ceil(math.log2(win)))
    spec = torch.fft.rfft(frames, n=fft_len, dim=2).abs() ** 2    # power
    banks = kaldi_mel_banks(num_mel_bins, fft_len, sample_frequency, low_freq, high_freq,
                            device=dev, dtype=dt)
    mel = spec[..., : fft_len // 2] @ banks.T
    out = torch.log(torch.clamp(mel, min=EPSILON))
    return out if batched else out[0]
