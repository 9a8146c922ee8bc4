"""Legacy backbone variants of the reference's surface: the BasicBlock
ResNet-18 (AVQA's grounding-gen visual net), NetVLAD pooling and the AVENet
audio encoder (VGGSound), a plain ViT encoder, and the PHM linear layer.

Counterpart of `avmoe_tpu/backbones/legacy.py:26-171` (`BasicBlock`,
`ResNet18`, `NetVLAD`, `AVENet`, `SimpleViT`, `PHMLinear`), same module and
parameter names, so the flax trees load through `convert.py`
`load_jax_variables`. Maps are channels-last, as in the JAX package.
`SimpleViT`'s attention is flax's MultiHeadDotProductAttention (per-head
(C, H, D) projections, (H, D, C) output, the port's `heads/common.py`
`MultiHeadAttention`); its LayerNorms have eps 1e-5 and its MLP the exact
GELU. Left out as they change nothing: NetVLAD's `alpha` (unused in the
JAX module) and SimpleViT's `train` (its dropout rates are 0). No model of
the port uses these modules.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from avmoe_tpu_torch.backbones.resnet import max_pool_3x3_s2
from avmoe_tpu_torch.heads.avs import Conv2d
from avmoe_tpu_torch.heads.common import MultiHeadAttention
from avmoe_tpu_torch.ops.norm import BatchNorm, LayerNorm
from avmoe_tpu_torch.ops.swin import Mlp


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


class BasicBlock(nn.Module):
    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_channels, features, 3, stride=stride, padding=1, bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv2d(features, features, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(features)
        self.downsample = in_channels != features or stride != 1
        if self.downsample:
            self.downsample_conv = Conv2d(in_channels, features, 1, stride=stride, bias=False)
            self.downsample_bn = BatchNorm(features)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), train))
        y = self.bn2(self.conv2(y), train)
        if self.downsample:
            x = self.downsample_bn(self.downsample_conv(x), train)
        return F.relu(y + x)


class ResNet18(nn.Module):
    """BasicBlock ResNet over (B, H, W, in_chans): the spatial map
    (`return_map`), the pooled features, or with `num_classes` the logits of
    the pooled features. The grounding variant keeps layer4 at stride 1."""

    def __init__(self, num_classes: int = 0, depths: Sequence[int] = (2, 2, 2, 2),
                 layer4_stride: int = 1, return_map: bool = False, in_chans: int = 3):
        super().__init__()
        self.return_map = return_map
        self.conv1 = Conv2d(in_chans, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        self.blocks = []
        feats, cin = 64, 64
        for s, d in enumerate(depths):
            for i in range(d):
                stride = 1
                if s > 0 and i == 0:
                    stride = layer4_stride if s == 3 else 2
                blk = BasicBlock(cin, feats, stride)
                self.add_module(f"layer{s + 1}_{i}", blk)
                self.blocks.append(blk)
                cin = feats
            feats *= 2
        self.fc = nn.Linear(cin, num_classes) if num_classes else None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = max_pool_3x3_s2(F.relu(self.bn1(self.conv1(x), train)))
        for blk in self.blocks:
            x = blk(x, train)
        if self.return_map:
            return x
        pooled = x.mean(dim=(1, 2))
        return pooled if self.fc is None else self.fc(pooled)


class NetVLAD(nn.Module):
    """NetVLAD pooling of (B, H, W, C) maps -> (B, num_clusters * C)."""

    def __init__(self, num_clusters: int = 8, dim: int = 512):
        super().__init__()
        self.centroids = nn.Parameter(torch.zeros(num_clusters, dim))
        self.conv = Conv2d(dim, num_clusters, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        xn = _l2_normalize(x)
        soft = torch.softmax(self.conv(xn).reshape(B, H * W, -1), dim=-1)  # (B, N, K)
        vlad = soft.transpose(1, 2) @ xn.reshape(B, H * W, C) \
            - soft.sum(dim=1)[..., None] * self.centroids[None]
        return _l2_normalize(_l2_normalize(vlad).reshape(B, -1))


class AVENet(nn.Module):
    """ResNet-18 audio encoder of (B, T, F, 1) spectrograms + a projection."""

    def __init__(self, embed_dim: int = 512):
        super().__init__()
        self.audnet = ResNet18(in_chans=1)
        self.proj = nn.Linear(512, embed_dim)

    def forward(self, spec: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.proj(self.audnet(spec, train))


class SimpleViT(nn.Module):
    """Plain pre-norm ViT encoder over (B, H, W, in_chans) images ->
    (B, N, embed_dim) tokens. `num_patches` is (H / patch) * (W / patch)
    (flax makes the position embedding at its first call's shape)."""

    def __init__(self, embed_dim: int = 192, depth: int = 4, num_heads: int = 3,
                 patch: int = 16, mlp_ratio: float = 4.0, num_patches: int = 196,
                 in_chans: int = 3):
        super().__init__()
        self.depth = depth
        self.patch_embed = Conv2d(in_chans, embed_dim, patch, stride=patch)
        self.pos_embed = nn.Parameter(torch.zeros(1, num_patches, embed_dim))
        hidden = int(embed_dim * mlp_ratio)
        for i in range(depth):
            self.add_module(f"norm1_{i}", LayerNorm(embed_dim))
            self.add_module(f"attn_{i}", MultiHeadAttention(embed_dim, num_heads))
            self.add_module(f"norm2_{i}", LayerNorm(embed_dim))
            self.add_module(f"mlp_{i}", Mlp(embed_dim, hidden, embed_dim))
        self.norm = LayerNorm(embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x)
        x = x.reshape(x.shape[0], -1, x.shape[-1]) + self.pos_embed
        for i in range(self.depth):
            h = getattr(self, f"norm1_{i}")(x)
            x = x + getattr(self, f"attn_{i}")(h, h)
            h = getattr(self, f"norm2_{i}")(x)
            mlp = getattr(self, f"mlp_{i}")
            x = x + mlp.fc2(F.gelu(mlp.fc1(h)))
        return self.norm(x)


class PHMLinear(nn.Module):
    """Parameterized hypercomplex linear: W = sum_i kron(A_i, S_i), (out, in)."""

    def __init__(self, n: int, in_features: int, out_features: int):
        super().__init__()
        if in_features % n or out_features % n:
            raise ValueError(f"features {in_features}, {out_features} not divisible by n={n}")
        self.n, self.in_features, self.out_features = n, in_features, out_features
        self.A = nn.Parameter(torch.zeros(n, n, n))
        self.S = nn.Parameter(torch.zeros(n, out_features // n, in_features // n))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def weight(self) -> torch.Tensor:
        w = torch.einsum("ipq,irs->iprqs", self.A, self.S).sum(0)
        return w.reshape(self.out_features, self.in_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.weight().T + self.bias
