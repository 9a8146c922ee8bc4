"""Swin transformer building blocks, channels-last (B, L, C) tokens.

Counterpart of `avmoe_tpu/ops/swin.py`. Both attention generations:

  * V1 (pre-norm, learned relative-position-bias table): HTS-AT.
  * V2 (post-norm, cosine attention, continuous position bias MLP): Swin-V2.

The attention core of every window-attention call is the window-attention
kernel (`kernels/window_attention.py`); the MLP sub-block of every block,
norm and residual add included, is the MLP-block kernel
(`kernels/mlp_block.py`). The qkv and proj products stay `torch.matmul`.

Train mode (`train=True` with a `generator`): DropPath scales each residual
branch per frame (the MLP branch inside K2, as its per-frame scale), and the
projection dropout runs at its configured rate. The two dropout sites inside
the kernels (attention probabilities, MLP hidden and output) are not
ported: a train forward with a non-zero rate there raises (their rates are
0 in every ported config). Gradients reach the inputs through K1b and K2b,
and, where a backbone trains (AVS S4 trains HTS-AT), its weights too: K1b
gives the attention bias's gradient, which autograd carries into the
relative-position table or the CPB MLP, and K2b the MLP's and norm2's.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from avmoe_tpu_torch.backbones.geometry import effective_window
from avmoe_tpu_torch.kernels.mlp_block import mlp_block
from avmoe_tpu_torch.kernels.window_attention import window_attention
from avmoe_tpu_torch.ops.dropout import drop_path_scale, dropout
from avmoe_tpu_torch.ops.norm import LayerNorm
from avmoe_tpu_torch.utils.runtime import dropout_det


# ---------------------------------------------------------------------------
# Static host-side geometry helpers (numpy)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """(Wh*Ww, Wh*Ww) int32 index into a (2Wh-1)(2Ww-1) bias table."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1).astype(np.int32)


@functools.lru_cache(maxsize=None)
def shifted_window_mask(h: int, w: int, window: int, shift: int) -> Optional[np.ndarray]:
    """(nW, N, N) additive attention mask (0 / -100) for shifted windows."""
    if shift == 0:
        return None
    img = np.zeros((h, w), dtype=np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(h // window, window, w // window, window)
    win = win.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def log_cpb_coords_table(wh: int, ww: int, pre_wh: int, pre_ww: int) -> np.ndarray:
    """((2Wh-1)(2Ww-1), 2) log-spaced relative coordinates for the Swin-V2
    continuous-position-bias MLP (timm's normalization)."""
    ch = np.arange(-(wh - 1), wh, dtype=np.float64)
    cw = np.arange(-(ww - 1), ww, dtype=np.float64)
    table = np.stack(np.meshgrid(ch, cw, indexing="ij"), axis=-1)
    denom_h = (pre_wh - 1) if pre_wh > 0 else (wh - 1)
    denom_w = (pre_ww - 1) if pre_ww > 0 else (ww - 1)
    table[..., 0] /= max(denom_h, 1)
    table[..., 1] /= max(denom_w, 1)
    table *= 8.0
    table = np.sign(table) * np.log2(np.abs(table) + 1.0) / np.log2(8.0)
    return table.reshape(-1, 2).astype(np.float32)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, window*window, C)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // window, window, W // window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, C)


def window_reverse(windows: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    """(B * nW, window*window, C) -> (B, H, W, C)."""
    C = windows.shape[-1]
    B = windows.shape[0] // ((h // window) * (w // window))
    x = windows.reshape(B, h // window, w // window, window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, h, w, C)


def partition_windows(x: torch.Tensor, H: int, W: int, window: int, shift: int) -> torch.Tensor:
    """(B, L, C) tokens -> (B*nW, N, C), rolled by -shift first."""
    B, L, C = x.shape
    x = x.reshape(B, H, W, C)
    if shift:
        x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
    return window_partition(x, window)


def unpartition_windows(wins: torch.Tensor, H: int, W: int, window: int, shift: int) -> torch.Tensor:
    """(B*nW, N, C) -> (B, L, C), inverse of partition_windows."""
    x = window_reverse(wins, window, H, W)
    if shift:
        x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
    return x.reshape(x.shape[0], H * W, x.shape[-1])


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """nn.Linear applied in x's dtype (float32 master weights cast at use)."""
    b = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), b)


def _full_bias(bias: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """(H, N, N) position bias [+ (nW, N, N) shift mask] -> (nW, H, N, N) f32."""
    if mask is None:
        return bias.float()[None].contiguous()
    return (bias.float()[None] + mask[:, None]).contiguous()


def _in_kernel_dropout(rate: float, train: bool, where: str) -> None:
    if rate and not dropout_det(train):
        raise NotImplementedError(f"{where} dropout (rate {rate}) would run inside a kernel; "
                                  "it is not ported (train with rate 0)")


def _attend(q, k, v, bias, mask, out_dtype):
    """(B_, H, N, D) q/k/v -> (B_, N, C) through the window-attention kernel."""
    B_, H, N, D = q.shape
    out = window_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           _full_bias(bias, mask))
    return out.transpose(1, 2).reshape(B_, N, H * D).to(out_dtype)


# ---------------------------------------------------------------------------
# Common layers
# ---------------------------------------------------------------------------


class Mlp(nn.Module):
    """Transformer MLP parameters (fc1 -> exact erf GELU -> fc2). SwinBlock
    runs them, with norm2 and the residual, as one MLP-block kernel call."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, out_dim)


class PatchEmbed(nn.Module):
    """Channels-last image -> patch tokens (conv, optional LayerNorm)."""

    def __init__(self, in_chans: int, embed_dim: int, patch_size: Tuple[int, int],
                 patch_stride: Tuple[int, int], use_norm: bool = True):
        super().__init__()
        ph, pw = patch_size
        sh, sw = patch_stride
        pad_h, pad_w = (ph - sh) // 2, (pw - sw) // 2
        # flax padding ((lo, hi), (lo, hi)) as F.pad's (w_lo, w_hi, h_lo, h_hi)
        self.padding = (pad_w, pw - sw - pad_w, pad_h, ph - sh - pad_h)
        self.stride = (sh, sw)
        self.proj = nn.Conv2d(in_chans, embed_dim, kernel_size=(ph, pw), stride=(sh, sw))
        self.norm = LayerNorm(embed_dim) if use_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        x = x.permute(0, 3, 1, 2)
        if any(self.padding):
            x = F.pad(x, self.padding)
        x = F.conv2d(x, self.proj.weight.to(dt), self.proj.bias.to(dt), stride=self.stride)
        x = x.flatten(2).transpose(1, 2)
        return x if self.norm is None else self.norm(x)


def _merge_2x2(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B, H*W, C) -> (B, H*W/4, 4C) in the reference's (x0, x1, x2, x3) order."""
    B, L, C = x.shape
    x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 4, 2, 5)
    return x.reshape(B, (H // 2) * (W // 2), 4 * C)


class PatchMergingV1(nn.Module):
    """Swin-V1 downsample: 2x2 concat -> LayerNorm(4C) -> Linear(4C->2C)."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int]):
        super().__init__()
        self.input_resolution = input_resolution
        self.norm = LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _merge_2x2(x, *self.input_resolution)
        return _linear(self.norm(x), self.reduction)


class PatchMergingV2(nn.Module):
    """Swin-V2 downsample: 2x2 concat -> Linear(4C->2C) -> LayerNorm(2C)."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int]):
        super().__init__()
        self.input_resolution = input_resolution
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = LayerNorm(2 * dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _merge_2x2(x, *self.input_resolution)
        return self.norm(_linear(x, self.reduction))


# ---------------------------------------------------------------------------
# Window attention
# ---------------------------------------------------------------------------


class WindowAttentionV1(nn.Module):
    """Scaled dot-product window attention with a learned relative-position
    bias table. q is scaled by D**-0.5 before the kernel."""

    def __init__(self, dim: int, window: Tuple[int, int], num_heads: int,
                 qkv_bias: bool = True, attn_drop: float = 0.0, proj_drop: float = 0.0):
        super().__init__()
        wh, ww = window
        self.num_heads = num_heads
        self.attn_drop, self.proj_drop = attn_drop, proj_drop
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * wh - 1) * (2 * ww - 1), num_heads))
        self.proj = nn.Linear(dim, dim)
        idx = relative_position_index(wh, ww).astype(np.int64).reshape(-1)
        self.register_buffer("relative_position_index", torch.from_numpy(idx),
                             persistent=False)

    def position_bias(self) -> torch.Tensor:
        """(H, N, N) float32 bias gathered from the table."""
        N = math.isqrt(self.relative_position_index.numel())
        bias = self.relative_position_bias_table[self.relative_position_index]
        return bias.reshape(N, N, self.num_heads).permute(2, 0, 1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, *,
                train: bool = False, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        B_, N, C = x.shape
        H = self.num_heads
        D = C // H
        _in_kernel_dropout(self.attn_drop, train, "attention-probability")
        qkv = _linear(x, self.qkv).reshape(B_, N, 3, H, D).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * (D ** -0.5), qkv[1], qkv[2]
        out = _attend(q, k, v, self.position_bias(), mask, x.dtype)
        return dropout(_linear(out, self.proj), self.proj_drop, train=train, generator=generator)


class WindowAttentionV2(nn.Module):
    """Swin-V2 cosine window attention with continuous position bias.

    q and k are row-normalized (1 / max(||.||, 1e-12)) and q is multiplied by
    the clamped per-head logit scale before the kernel; the CPB MLP output
    goes through 16 * sigmoid."""

    def __init__(self, dim: int, window: Tuple[int, int], num_heads: int,
                 pretrained_window: Tuple[int, int] = (0, 0), cpb_hidden: int = 512,
                 attn_drop: float = 0.0, proj_drop: float = 0.0):
        super().__init__()
        wh, ww = window
        self.num_heads = num_heads
        self.attn_drop, self.proj_drop = attn_drop, proj_drop
        # flax layout (in, out), used as x @ qkv_kernel
        self.qkv_kernel = nn.Parameter(torch.zeros(dim, 3 * dim))
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.logit_scale = nn.Parameter(torch.full((num_heads, 1, 1), math.log(10.0)))
        self.cpb_fc1 = nn.Linear(2, cpb_hidden)
        self.cpb_fc2 = nn.Linear(cpb_hidden, num_heads, bias=False)
        self.proj = nn.Linear(dim, dim)
        coords = log_cpb_coords_table(wh, ww, *pretrained_window)
        self.register_buffer("cpb_coords", torch.from_numpy(coords), persistent=False)
        idx = relative_position_index(wh, ww).astype(np.int64).reshape(-1)
        self.register_buffer("relative_position_index", torch.from_numpy(idx),
                             persistent=False)

    def position_bias(self) -> torch.Tensor:
        """(H, N, N) float32 bias: 16 * sigmoid(CPB MLP gathered)."""
        N = math.isqrt(self.relative_position_index.numel())
        cpb = self.cpb_fc2(F.relu(self.cpb_fc1(self.cpb_coords)))
        bias = cpb[self.relative_position_index].reshape(N, N, self.num_heads)
        return 16.0 * torch.sigmoid(bias.permute(2, 0, 1))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, *,
                train: bool = False, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        B_, N, C = x.shape
        H = self.num_heads
        D = C // H
        dt = x.dtype
        _in_kernel_dropout(self.attn_drop, train, "attention-probability")
        qkv_bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias), self.v_bias])
        qkv = x @ self.qkv_kernel.to(dt) + qkv_bias.to(dt)
        qkv = qkv.reshape(B_, N, 3, H, D).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]

        def _row_normalize(t):
            ss = (t.float() * t.float()).sum(dim=-1, keepdim=True)
            return t * (1.0 / torch.clamp(torch.sqrt(ss), min=1e-12)).to(t.dtype)

        scale = torch.exp(torch.clamp(self.logit_scale, max=math.log(100.0)))
        q = _row_normalize(q) * scale.to(dt)
        k = _row_normalize(k)
        out = _attend(q, k, v, self.position_bias(), mask, dt)
        return dropout(_linear(out, self.proj), self.proj_drop, train=train, generator=generator)


# ---------------------------------------------------------------------------
# Swin block with injection seams
# ---------------------------------------------------------------------------


class SwinBlock(nn.Module):
    """One Swin block over (B, L, C) tokens.

    version 'v1' is pre-norm: x + attn(norm1(x)), x + mlp(norm2(x));
    version 'v2' is post-norm: x + norm1(attn(x)), x + norm2(mlp(x)).
    `attn_state` / `mlp_state` are the two sub-block state updates the MoE
    injection engine weaves adapters between. The window shrinks to the
    grid (and the shift drops to 0) when the grid is not larger than it.
    In train mode each residual branch is scaled per frame by DropPath at
    rate `drop_path`; `drop` is the projection (and MLP) dropout rate,
    `attn_drop` the attention-probability one.
    """

    def __init__(self, dim: int, input_resolution: Tuple[int, int], num_heads: int,
                 window_size: int, shift_size: int, version: str = "v1",
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 pretrained_window: int = 0, drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path: float = 0.0):
        super().__init__()
        self.drop, self.drop_path = drop, drop_path
        # frozen MLP weights in a compute dtype, with their transposes (K2b)
        self._mlp_cache = {}
        self.dim = dim
        self.input_resolution = tuple(input_resolution)
        self.num_heads = num_heads
        self.window_size = window_size
        self.shift_size = shift_size
        self.version = version
        window, shift = self._geometry()
        if version == "v1":
            self.attn = WindowAttentionV1(dim, (window, window), num_heads, qkv_bias,
                                          attn_drop=attn_drop, proj_drop=drop)
        else:
            self.attn = WindowAttentionV2(dim, (window, window), num_heads,
                                          (pretrained_window, pretrained_window),
                                          attn_drop=attn_drop, proj_drop=drop)
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)
        mask = shifted_window_mask(*self.input_resolution, window, shift)
        self.register_buffer("attn_mask", None if mask is None else torch.from_numpy(mask),
                             persistent=False)

    def _geometry(self) -> Tuple[int, int]:
        return effective_window(self.input_resolution, self.window_size, self.shift_size)

    def _windowed_attn(self, x: torch.Tensor, train: bool,
                       generator: Optional[torch.Generator]) -> torch.Tensor:
        H, W = self.input_resolution
        window, shift = self._geometry()
        wins = partition_windows(x, H, W, window, shift)
        wins = self.attn(wins, mask=self.attn_mask, train=train, generator=generator)
        return unpartition_windows(wins, H, W, window, shift)

    def _drop_path(self, x: torch.Tensor, train: bool,
                   generator: Optional[torch.Generator]) -> Optional[torch.Tensor]:
        return drop_path_scale(x.shape[0], self.drop_path, train=train, generator=generator,
                               device=x.device)

    def attn_residual(self, x: torch.Tensor, train: bool = False,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Residual delta of the attention sub-block (DropPath-scaled in train)."""
        if self.version == "v1":
            r = self._windowed_attn(self.norm1(x), train, generator)
        else:
            r = self.norm1(self._windowed_attn(x, train, generator))
        scale = self._drop_path(x, train, generator)
        return r if scale is None else r * scale.reshape(-1, 1, 1).to(r.dtype)

    def attn_state(self, x: torch.Tensor, train: bool = False,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x + attn_residual(x)."""
        return x + self.attn_residual(x, train, generator)

    def _mlp_weights(self, dt: torch.dtype, transposed: bool):
        """(w1, w2, w1ᵀ, w2ᵀ) of the frozen MLP in dtype dt, contiguous (the
        transposes, which only K2b reads, None unless asked for), made once
        and made again only when a weight changes (its version counter or
        storage)."""
        w1, w2 = self.mlp.fc1.weight, self.mlp.fc2.weight
        key = (w1.data_ptr(), w1._version, w2.data_ptr(), w2._version)
        hit = self._mlp_cache.get(dt)
        with torch.no_grad():
            if hit is None or hit[0] != key:
                hit = [key, w1.to(dt).contiguous(), w2.to(dt).contiguous(), None, None]
                self._mlp_cache[dt] = hit
            if transposed and hit[3] is None:
                hit[3], hit[4] = hit[1].t().contiguous(), hit[2].t().contiguous()
        return hit[1], hit[2], hit[3], hit[4]

    def mlp_state(self, x: torch.Tensor, train: bool = False,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x + [norm2 ->] fc1 -> GELU -> fc2 [-> norm2], one MLP-block kernel
        call; in train the branch is DropPath-scaled per frame inside it."""
        dt = x.dtype
        m = self.mlp
        _in_kernel_dropout(self.drop, train, "MLP")
        scale = self._drop_path(x, train, generator)
        params = (m.fc1.weight, m.fc1.bias, m.fc2.weight, m.fc2.bias,
                  self.norm2.weight, self.norm2.bias)
        grad = torch.is_grad_enabled()
        if grad and any(p.requires_grad for p in params):
            # trainable: the float32 masters go in as they are; the kernel's
            # autograd Function casts them, makes their transposes for K2b and
            # returns their gradients as float32 sums
            w1, w2, w1t, w2t = m.fc1.weight, m.fc2.weight, None, None
        else:
            w1, w2, w1t, w2t = self._mlp_weights(dt, transposed=grad and x.requires_grad)
        return mlp_block(
            x, self.norm2.weight, self.norm2.bias, w1, m.fc1.bias, w2, m.fc2.bias,
            pre_norm=self.version == "v1", eps=self.norm2.eps, scale=scale, w1t=w1t, w2t=w2t)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.mlp_state(self.attn_state(x, train, generator), train, generator)
