"""VGGish: the waveform -> log-mel examples front end, the audio CNN and its
PCA postprocessor, which give the AVSBench baseline its (B, T, 128) audio
embeddings.

Counterpart of `avmoe_tpu/backbones/vggish.py` (constants `:22-35`,
`waveform_to_examples` `:37`, `VGGish` `:64`, `VGGishPostprocessor` `:95`).
Differences kept on purpose:

  * `waveform_to_examples` runs on tensors, on the waves' device, batched
    over clips: (B, L) -> (B, N, 96, 64); the JAX package's runs host numpy
    on one (L,) wave. The arithmetic is the same float64 (periodic Hann
    window, `torch.fft.rfft` magnitudes, the float32-rounded HTK filterbank,
    log(mel + 0.01)), rounded to float32 at the end.
  * `VGGish` keeps its maps channels-last, as the JAX module does, with
    torch convs over a channels-last view (`heads/avs.py` `Conv2d`): the
    flatten before `fc1_1` is then in the reference's (H, W, C) order
    without a permute.
  * `VGGishPostprocessor` holds its PCA on a device and takes tensors.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from avmoe_tpu_torch.audio.frontend import mel_filterbank_htk
from avmoe_tpu_torch.heads.avs import Conv2d

SAMPLE_RATE = 16_000
STFT_WINDOW_SECONDS = 0.025
STFT_HOP_SECONDS = 0.010
NUM_MEL_BINS = 64
MEL_MIN_HZ = 125.0
MEL_MAX_HZ = 7_500.0
LOG_OFFSET = 0.01
EXAMPLE_WINDOW_SECONDS = 0.96
EXAMPLE_HOP_SECONDS = 0.96
EMBEDDING_SIZE = 128
QUANTIZE_MIN_VAL = -2.0
QUANTIZE_MAX_VAL = 2.0


def waveform_to_examples(wave: torch.Tensor, sample_rate: int = SAMPLE_RATE) -> torch.Tensor:
    """(B, L) or (L,) waves -> (B, N, 96, 64) or (N, 96, 64) float32 log-mel
    examples of 0.96 s, computed in float64 on the waves' device."""
    single = wave.dim() == 1
    x = (wave[None] if single else wave).to(torch.float64)
    L = x.shape[-1]
    win = int(round(STFT_WINDOW_SECONDS * sample_rate))
    hop = int(round(STFT_HOP_SECONDS * sample_rate))
    fft_length = 2 ** int(np.ceil(np.log2(win)))
    per_example = int(round(EXAMPLE_WINDOW_SECONDS / STFT_HOP_SECONDS))
    hop_frames = int(round(EXAMPLE_HOP_SECONDS / STFT_HOP_SECONDS))
    frames = 1 + (L - win) // hop if L >= win else 0
    m = 1 + (frames - per_example) // hop_frames if frames >= per_example else 0
    if m <= 0:
        out = x.new_zeros((x.shape[0], 0, per_example, NUM_MEL_BINS), dtype=torch.float32)
        return out[0] if single else out
    window = torch.hann_window(win, periodic=True, dtype=torch.float64, device=x.device)
    spec = torch.fft.rfft(x.unfold(-1, win, hop) * window, n=fft_length).abs()
    bank = torch.from_numpy(mel_filterbank_htk(sample_rate, fft_length, NUM_MEL_BINS,
                                               MEL_MIN_HZ, MEL_MAX_HZ))
    log_mel = torch.log(spec @ bank.to(device=x.device, dtype=torch.float64) + LOG_OFFSET)
    out = log_mel.unfold(1, per_example, hop_frames)[:, :m].transpose(-1, -2)
    out = out.to(torch.float32).contiguous()
    return out[0] if single else out


class VGGish(nn.Module):
    """VGG audio CNN: (B, 96, 64, 1) log-mel examples -> (B, 128) embeddings."""

    FEATURES = (("conv1", 1, 64), ("conv2", 64, 128), ("conv3_1", 128, 256),
                ("conv3_2", 256, 256), ("conv4_1", 256, 512), ("conv4_2", 512, 512))
    POOL_AFTER = ("conv1", "conv2", "conv3_2", "conv4_2")

    def __init__(self):
        super().__init__()
        for name, cin, cout in self.FEATURES:
            self.add_module(name, Conv2d(cin, cout, 3, padding=1))
        self.fc1_1 = nn.Linear(6 * 4 * 512, 4096)
        self.fc1_2 = nn.Linear(4096, 4096)
        self.fc2 = nn.Linear(4096, EMBEDDING_SIZE)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name, _, _ in self.FEATURES:
            x = F.relu(getattr(self, name)(x))
            if name in self.POOL_AFTER:
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        x = x.reshape(x.shape[0], -1)                    # (H, W, C) order
        x = F.relu(self.fc1_1(x))
        x = F.relu(self.fc1_2(x))
        return F.relu(self.fc2(x))


class VGGishPostprocessor:
    """PCA + quantization: (N, 128) embeddings -> float values in [0, 255]
    (the reference keeps them float after the scale)."""

    def __init__(self, pca_matrix, pca_means, device="cpu"):
        self.pca_matrix = torch.as_tensor(np.asarray(pca_matrix, np.float32), device=device)
        self.pca_means = torch.as_tensor(np.asarray(pca_means, np.float32),
                                         device=device).reshape(-1, 1)

    def __call__(self, embeddings: torch.Tensor) -> torch.Tensor:
        x = self.pca_matrix @ (embeddings.to(torch.float32).T - self.pca_means)
        x = torch.clamp(x.T, QUANTIZE_MIN_VAL, QUANTIZE_MAX_VAL)
        return (x - QUANTIZE_MIN_VAL) * (255.0 / (QUANTIZE_MAX_VAL - QUANTIZE_MIN_VAL))
