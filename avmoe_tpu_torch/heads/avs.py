"""AVS decoder: resizes, the ASPP classifier, FPN fusion, TPAVI and the
four-scale temporal attention.

Counterpart of `avmoe_tpu/heads/avs.py`. Feature maps stay channels-last,
(B, H, W, C), as in the JAX package; the convs read them through a
channels-last view, so their weights are torch's (out, in, kh, kw) and the
converter maps the flax (kh, kw, in, out) kernels onto them. Resizes are two
products with precomputed 1-D interpolation matrices, as the JAX package
computes them.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from avmoe_tpu_torch.audio.frontend import bicubic_resize_matrix
from avmoe_tpu_torch.heads.common import BiLSTM, TransformerEncoder
from avmoe_tpu_torch.ops.dropout import dropout
from avmoe_tpu_torch.ops.norm import BatchNorm, LayerNorm

Gen = Optional[torch.Generator]


@functools.lru_cache(maxsize=None)
def _linear_matrix(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """(out_size, in_size) matrix of 1-D linear interpolation; without
    align_corners the source index is clamped to the border, as torch's
    bilinear F.interpolate clamps it."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == 1:
        m[:, 0] = 1.0
        return m
    for i in range(out_size):
        if align_corners:
            src = i * (in_size - 1) / max(out_size - 1, 1)
        else:
            src = min(max((i + 0.5) * in_size / out_size - 0.5, 0.0), in_size - 1)
        lo = int(np.floor(src))
        hi = min(lo + 1, in_size - 1)
        t = src - lo
        m[i, lo] += 1.0 - t
        m[i, hi] += t
    return m


@functools.lru_cache(maxsize=None)
def _matrix(kind: str, in_size: int, out_size: int, align_corners: bool,
            device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The 1-D interpolation matrix as a tensor on `device`, made once: a
    copy from host memory on every resize would wait for the card each
    time, and the host could no longer queue a forward's work ahead of it.
    Made outside inference mode, so that a later autograd pass may save it."""
    make = _linear_matrix if kind == "linear" else bicubic_resize_matrix
    with torch.inference_mode(False):
        return torch.from_numpy(make(in_size, out_size, align_corners)).to(device=device,
                                                                            dtype=dtype)


def _resize(x: torch.Tensor, kind: str, h: int, w: int, align_corners: bool) -> torch.Tensor:
    """(B, H, W, C) -> (B, h, w, C): the rows, then the columns, each as a
    batched product over the channels-last layout (no transposed copy)."""
    B, H, W, C = x.shape
    mh = _matrix(kind, H, h, align_corners, x.device, x.dtype)
    mw = _matrix(kind, W, w, align_corners, x.device, x.dtype)
    x = torch.matmul(mh, x.reshape(B, H, W * C))                      # (B, h, W*C)
    return torch.matmul(mw, x.reshape(B * h, W, C)).reshape(B, h, w, C)


def resize_bilinear(x: torch.Tensor, h: int, w: int, align_corners: bool = True
                    ) -> torch.Tensor:
    """(B, H, W, C) bilinear resize to (B, h, w, C)."""
    if tuple(x.shape[1:3]) == (h, w):
        return x
    return _resize(x, "linear", h, w, align_corners)


def resize_bicubic(x: torch.Tensor, h: int, w: int, align_corners: bool = False
                   ) -> torch.Tensor:
    """(B, H, W, C) bicubic resize (torch's kernel, a = -0.75, border
    clamped) to (B, h, w, C); the AVS decoder leaves align_corners off."""
    if tuple(x.shape[1:3]) == (h, w):
        return x
    return _resize(x, "cubic", h, w, align_corners)


class Conv2d(nn.Conv2d):
    """A torch conv over channels-last (B, H, W, C) maps. On the card cuDNN
    times its algorithms for each new shape (benchmark mode, for this call
    only): in float32 with TF32 off its heuristic picks an FFT algorithm for
    out_conv1's 3x3 256 -> 128 conv at 112 x 112 that takes 100 to 122 ms a
    batch-4 forward (tools/avs_profile_ops.py)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        if x.is_cuda:
            b = torch.backends.cudnn
            with b.flags(enabled=b.enabled, benchmark=True, deterministic=b.deterministic,
                         allow_tf32=b.allow_tf32):
                return super().forward(x).permute(0, 2, 3, 1)
        return super().forward(x).permute(0, 2, 3, 1)


class ASPPClassifier(nn.Module):
    """The AVSBench baseline's per-stage projection
    (`avmoe_tpu/heads/avs.py:73`): the sum of four 3x3 convs dilated by 3,
    6, 12 and 18, each padded by its dilation."""

    def __init__(self, in_channels: int, features: int,
                 dilations: Tuple[int, ...] = (3, 6, 12, 18)):
        super().__init__()
        self.convs = []
        for i, d in enumerate(dilations):
            m = Conv2d(in_channels, features, 3, padding=d, dilation=d)
            self.add_module(f"conv_{i}", m)
            self.convs.append(m)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.convs[0](x)
        for conv in self.convs[1:]:
            out = out + conv(x)
        return out


class ResidualConvUnit(nn.Module):
    """conv2(relu(conv1(relu(x)))) + relu(x): the residual is relu(x), not
    x, since the reference's in-place ReLU rewrites x before the sum."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = Conv2d(features, features, 3, padding=1)
        self.conv2 = Conv2d(features, features, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(x)
        return self.conv2(F.relu(self.conv1(x))) + x


class FeatureFusionBlock(nn.Module):
    """[x + res1(skip)] -> res2 -> bilinear x2 (align_corners). The block
    of the coarsest level takes no skip and, as in the flax tree, has no
    res1."""

    def __init__(self, features: int, skip: bool = True):
        super().__init__()
        if skip:
            self.res1 = ResidualConvUnit(features)
        else:
            # the reference builds its res1 too and never calls it; a
            # converted checkpoint holds that subtree
            self.flax_off_path = ("res1",)
        self.res2 = ResidualConvUnit(features)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        if skip is not None:
            x = x + self.res1(skip)
        x = self.res2(x)
        return resize_bilinear(x, 2 * x.shape[1], 2 * x.shape[2], align_corners=True)


class PointwiseConv3d(nn.Module):
    """flax Conv(out, (1, 1, 1)) over channels-last (B, T, H, W, C): the
    kernel keeps the flax layout (1, 1, 1, in, out)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(1, 1, 1, in_dim, out_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel[0, 0, 0].to(x.dtype) + self.bias.to(x.dtype)


class TPAVIModule(nn.Module):
    """Temporal-pixel audio-visual non-local attention ('dot' mode) over a
    visual map (B, T, H, W, C) and, with audio (B, T, 128), the audio
    broadcast to every pixel (without audio, the visual map itself):

      g, theta = Dense(x); phi = Dense(audio or x), each of C/2 channels
      f = theta phi^T / N in float32, N = T*H*W; y = f g
      z = LayerNorm(BN(W_z_conv(y)) + x)

    W_z_conv's kernel and W_z_bn's scale start at zero, so an untrained
    block is LayerNorm(x). Returns (z, the aligned audio (B, T, C) or None)."""

    def __init__(self, in_channels: int):
        super().__init__()
        C, inter = in_channels, max(in_channels // 2, 1)
        self.align_channel = nn.Linear(128, C)
        self.g = nn.Linear(C, inter)
        self.theta = nn.Linear(C, inter)
        self.phi = nn.Linear(C, inter)
        self.W_z_conv = PointwiseConv3d(inter, C)
        self.W_z_bn = BatchNorm(C)
        self.norm_layer = LayerNorm(C)

    def forward(self, x: torch.Tensor, audio: Optional[torch.Tensor] = None,
                train: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        B, T, H, W, C = x.shape
        if audio is not None:
            a = self.align_channel(audio)                           # (B, T, C)
            other = a[:, :, None, None, :].expand(B, T, H, W, C)
        else:
            a, other = None, x
        g = self.g(x).reshape(B, T * H * W, -1)
        theta = self.theta(x).reshape(B, T * H * W, -1)
        phi = self.phi(other).reshape(B, T * H * W, -1)
        # in place: the (B, N, N) float32 logits are the block's largest tensor
        f = torch.matmul(theta.float(), phi.float().transpose(1, 2)).div_(T * H * W)
        y = torch.matmul(f, g.to(f.dtype)).reshape(B, T, H, W, -1)
        wz = self.W_z_bn(self.W_z_conv(y), train=train)
        return self.norm_layer(wz + x), a


class MultiScaleTemporalAttention(nn.Module):
    """Per pyramid level (four): a BiLSTM and a post-norm transformer encoder per
    stream over the T segments, and sigmoid gates. Each map (B*T, H, W, C)
    grows by gamma * audio_gate * map; the audio (B, T, 128) by gamma * the
    mean of the levels' video gates * audio. Returns (maps, audio (B*T, 128))."""

    def __init__(self, d_model: int = 256, audio_dim: int = 128, num_segments: int = 5,
                 gamma: float = 0.05):
        super().__init__()
        self.num_segments, self.gamma = num_segments, gamma
        for i in range(4):
            self.add_module(f"v_fc_{i}", nn.Linear(d_model, d_model))
            self.add_module(f"audio_rnn_{i}", BiLSTM(audio_dim, d_model // 2))
            self.add_module(f"visual_rnn_{i}", BiLSTM(d_model, d_model))
            self.add_module(f"video_enc_affine_{i}", nn.Linear(2 * d_model, d_model))
            self.add_module(f"video_encoder_{i}", TransformerEncoder(d_model, 4, 2, 1024))
            self.add_module(f"audio_enc_affine_{i}", nn.Linear(d_model, d_model))
            self.add_module(f"audio_encoder_{i}", TransformerEncoder(d_model, 4, 2, 1024))
            self.add_module(f"audio_gated_{i}", nn.Linear(d_model, 1))
            self.add_module(f"video_gated_{i}", nn.Linear(d_model, 1))

    def forward(self, maps: List[torch.Tensor], audio: torch.Tensor, train: bool = False,
                generator: Gen = None) -> Tuple[List[torch.Tensor], torch.Tensor]:
        T, B = self.num_segments, audio.shape[0]
        m = lambda name, i: getattr(self, f"{name}_{i}")
        new_maps, video_gates = [], []
        for i, fmap in enumerate(maps):
            pooled = fmap.mean(dim=(1, 2)).reshape(B, T, -1)
            v = dropout(F.relu(m("v_fc", i)(pooled)), 0.2, train=train, generator=generator)
            a_rnn = m("audio_rnn", i)(audio)
            v_rnn = m("visual_rnn", i)(v)
            video_kv = m("video_encoder", i)(m("video_enc_affine", i)(v_rnn), train, generator)
            audio_kv = m("audio_encoder", i)(m("audio_enc_affine", i)(a_rnn), train, generator)
            audio_gate = torch.sigmoid(m("audio_gated", i)(audio_kv))       # (B, T, 1)
            video_gates.append(torch.sigmoid(m("video_gated", i)(video_kv)))
            gate = audio_gate.reshape(B * T, 1, 1, 1)
            new_maps.append(fmap + gate * fmap * self.gamma)
        video_gate = sum(video_gates) / len(video_gates)
        audio_flat = audio.reshape(B * T, -1)
        return new_maps, audio_flat + video_gate.reshape(B * T, 1) * audio_flat * self.gamma
