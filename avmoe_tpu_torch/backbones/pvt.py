"""PVT-v2 visual backbone of the AVSBench baseline: overlapping patch
embeds, spatial-reduction attention, depthwise-conv MLPs; returns the
4-level channels-last pyramid.

Counterpart of `avmoe_tpu/backbones/pvt.py:20-155` (`DWConv`, `PVTMlp`,
`SRAttention`, `PVTBlock`, `OverlapPatchEmbed`, `PVTv2`, `pvt_v2_b0`,
`pvt_v2_b2`, `pvt_v2_b5`), same module names, so the flax tree loads
through `convert.py` `load_jax_variables`. Maps stay channels-last, (B, H,
W, C), and the convs read them through a channels-last view
(`heads/avs.py` `Conv2d`); flax's `feature_group_count=C` is torch's
`groups=C`. The spatial-reduction conv pads as flax's 'SAME' does (nothing
where the grid divides by its stride, as at 224 and 64 px). LayerNorm eps is
1e-6 everywhere; the MLP's GELU is flax's default, the tanh form. DropPath
draws one keep per frame from an explicit generator (`ops/dropout.py`
`drop_path_scale`). The JAX modules' dropout sites have rate 0 wherever its
constructors build them, so the port has none.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from avmoe_tpu_torch.heads.avs import Conv2d
from avmoe_tpu_torch.ops.dropout import drop_path_scale
from avmoe_tpu_torch.ops.norm import LayerNorm

Gen = Optional[torch.Generator]
EPS = 1e-6


def _same_pad(size: int, k: int, s: int) -> Tuple[int, int]:
    """flax 'SAME' padding (lo, hi) of one axis for kernel k, stride s."""
    total = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class DWConv(nn.Module):
    """3x3 depthwise conv over the (h, w) token grid of (B, N, C) tokens."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 3, padding=1, groups=dim)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        B, N, C = x.shape
        return self.dwconv(x.reshape(B, h, w, C)).reshape(B, N, C)


class PVTMlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x, h: int, w: int):
        return self.fc2(F.gelu(self.dwconv(self.fc1(x), h, w), approximate="tanh"))


class SRAttention(nn.Module):
    """Attention whose keys and values come from the grid reduced by an sr x
    sr conv of stride sr and a LayerNorm (sr > 1), else from the tokens."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int = 1):
        super().__init__()
        self.num_heads, self.sr_ratio = num_heads, sr_ratio
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.norm = LayerNorm(dim, eps=EPS)

    def forward(self, x, h: int, w: int):
        B, N, C = x.shape
        H, D = self.num_heads, C // self.num_heads
        q = self.q(x).reshape(B, N, H, D).transpose(1, 2)               # (B, H, N, D)
        if self.sr_ratio > 1:
            r = self.sr_ratio
            (ht, hb), (wl, wr) = _same_pad(h, r, r), _same_pad(w, r, r)
            g = F.pad(x.reshape(B, h, w, C), (0, 0, wl, wr, ht, hb))
            kv_in = self.norm(self.sr(g).reshape(B, -1, C))
        else:
            kv_in = x
        kv = self.kv(kv_in).reshape(B, -1, 2, H, D).permute(2, 0, 3, 1, 4)  # (2, B, H, S, D)
        attn = torch.softmax(q @ kv[0].transpose(-1, -2) * (D ** -0.5), dim=-1)
        return self.proj((attn @ kv[1]).transpose(1, 2).reshape(B, N, C))


class PVTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, sr_ratio: int = 1,
                 drop_path: float = 0.0):
        super().__init__()
        self.drop_path = drop_path
        self.norm1 = LayerNorm(dim, eps=EPS)
        self.attn = SRAttention(dim, num_heads, sr_ratio)
        self.norm2 = LayerNorm(dim, eps=EPS)
        self.mlp = PVTMlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x, h: int, w: int, train: bool = False, generator: Gen = None):
        def residual(x, branch):
            s = drop_path_scale(x.shape[0], self.drop_path, train=train, generator=generator,
                                device=x.device)
            return x + (branch if s is None else s.to(branch.dtype)[:, None, None] * branch)

        x = residual(x, self.attn(self.norm1(x), h, w))
        return residual(x, self.mlp(self.norm2(x), h, w))


class OverlapPatchEmbed(nn.Module):
    def __init__(self, in_chans: int, dim: int, patch: int, stride: int):
        super().__init__()
        self.proj = Conv2d(in_chans, dim, patch, stride=stride, padding=patch // 2)
        self.norm = LayerNorm(dim, eps=EPS)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
        x = self.proj(x)
        B, H, W, C = x.shape
        return self.norm(x.reshape(B, H * W, C)), H, W


class PVTv2(nn.Module):
    """4-stage PVT-v2 over (B, H, W, 3) images; returns the channels-last maps
    (B, H/4, W/4, dims[0]) ... (B, H/32, W/32, dims[3]); `widths` = dims."""

    def __init__(self, dims: Sequence[int] = (64, 128, 320, 512),
                 num_heads: Sequence[int] = (1, 2, 5, 8), depths: Sequence[int] = (3, 6, 40, 3),
                 sr_ratios: Sequence[int] = (8, 4, 2, 1),
                 mlp_ratios: Sequence[float] = (4, 4, 4, 4), drop_path_rate: float = 0.1,
                 in_chans: int = 3):
        super().__init__()
        self.widths, self.depths = tuple(dims), tuple(depths)
        total = sum(depths)
        dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        self.stages: List[Tuple[OverlapPatchEmbed, List[PVTBlock], LayerNorm]] = []
        k = 0
        for s in range(4):
            embed = OverlapPatchEmbed(in_chans if s == 0 else dims[s - 1], dims[s],
                                      patch=7 if s == 0 else 3, stride=4 if s == 0 else 2)
            self.add_module(f"patch_embed{s + 1}", embed)
            blocks = []
            for i in range(depths[s]):
                blk = PVTBlock(dims[s], num_heads[s], mlp_ratios[s], sr_ratios[s], dpr[k])
                self.add_module(f"block{s + 1}_{i}", blk)
                blocks.append(blk)
                k += 1
            norm = LayerNorm(dims[s], eps=EPS)
            self.add_module(f"norm{s + 1}", norm)
            self.stages.append((embed, blocks, norm))

    def forward(self, x: torch.Tensor, train: bool = False, generator: Gen = None
                ) -> List[torch.Tensor]:
        outs = []
        for embed, blocks, norm in self.stages:
            x, h, w = embed(x)
            for blk in blocks:
                x = blk(x, h, w, train, generator)
            x = norm(x).reshape(x.shape[0], h, w, -1)
            outs.append(x)
        return outs


def pvt_v2_b0() -> PVTv2:
    return PVTv2(dims=(32, 64, 160, 256), depths=(2, 2, 2, 2), mlp_ratios=(8, 8, 4, 4))


def pvt_v2_b2() -> PVTv2:
    return PVTv2(depths=(3, 4, 6, 3), mlp_ratios=(8, 8, 4, 4))


def pvt_v2_b5() -> PVTv2:
    return PVTv2(depths=(3, 6, 40, 3))
