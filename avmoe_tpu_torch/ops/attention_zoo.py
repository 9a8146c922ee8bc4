"""The AVVP reference's attention library: scaled dot-product, additive
(Bahdanau), location-aware (Chorowski) scoring and a q/k/v-projected
multi-head attention, each returning (context, attention weights).

Counterpart of `avmoe_tpu/ops/attention_zoo.py:15-92`, plain PyTorch
computing what the flax bodies compute, with their parameter names (Dense
layers as `nn.Linear`; the location conv keeps flax's (3, 1, C) kernel).
No model of either package uses them.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

Pair = Tuple[torch.Tensor, torch.Tensor]


class ScaledDotProductAttention(nn.Module):
    """softmax(Q K^T / sqrt(d)) V; a boolean mask keeps the True scores."""

    def forward(self, query, key, value, mask: Optional[torch.Tensor] = None) -> Pair:
        score = query @ key.transpose(-1, -2) / math.sqrt(query.shape[-1])
        if mask is not None:
            score = torch.where(mask, score, torch.full_like(score, -1e9))
        attn = torch.softmax(score, dim=-1)
        return attn @ value, attn


class AdditiveAttention(nn.Module):
    """Bahdanau scoring: v^T tanh(W_q q + W_k k + b)."""

    def __init__(self, query_dim: int, key_dim: int, hidden_dim: int):
        super().__init__()
        self.query_proj = nn.Linear(query_dim, hidden_dim, bias=False)
        self.key_proj = nn.Linear(key_dim, hidden_dim, bias=False)
        self.bias = nn.Parameter(torch.zeros(hidden_dim))
        self.score_proj = nn.Linear(hidden_dim, 1)

    def forward(self, query, key, value) -> Pair:
        q, k = self.query_proj(query), self.key_proj(key)
        score = self.score_proj(torch.tanh(q[:, :, None] + k[:, None, :] + self.bias))[..., 0]
        attn = torch.softmax(score, dim=-1)
        return attn @ value, attn


class FlaxConv1d(nn.Module):
    """flax Conv(out, (k,), padding=p) over channels-last (B, L, C_in),
    its kernel in flax's (k, C_in, C_out) layout."""

    def __init__(self, in_dim: int, out_dim: int, k: int, padding: int):
        super().__init__()
        self.padding = padding
        self.kernel = nn.Parameter(torch.zeros(k, in_dim, out_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv1d(x.transpose(1, 2), self.kernel.permute(2, 1, 0), self.bias,
                     padding=self.padding)
        return y.transpose(1, 2)


class LocationAwareAttention(nn.Module):
    """Additive scoring plus a conv over the previous alignment; the weights
    are a softmax, or with `smoothing` normalized sigmoids. Returns the
    context (B, D) of one query (B, Dq) over value (B, K, D)."""

    def __init__(self, query_dim: int, value_dim: int, hidden_dim: int,
                 conv_out_channel: int = 10, smoothing: bool = False):
        super().__init__()
        self.smoothing = smoothing
        self.loc_conv = FlaxConv1d(1, conv_out_channel, 3, padding=1)
        self.query_proj = nn.Linear(query_dim, hidden_dim, bias=False)
        self.value_proj = nn.Linear(value_dim, hidden_dim, bias=False)
        self.loc_proj = nn.Linear(conv_out_channel, hidden_dim, bias=False)
        self.bias = nn.Parameter(torch.zeros(hidden_dim))
        self.score_proj = nn.Linear(hidden_dim, 1)

    def forward(self, query, value, last_attn: Optional[torch.Tensor] = None) -> Pair:
        if last_attn is None:
            last_attn = value.new_zeros(value.shape[:2])
        conv_attn = self.loc_conv(last_attn[..., None])
        h = self.query_proj(query)[:, None] + self.value_proj(value) \
            + self.loc_proj(conv_attn) + self.bias
        score = self.score_proj(torch.tanh(h))[..., 0]
        if self.smoothing:
            s = torch.sigmoid(score)
            attn = s / s.sum(dim=-1, keepdim=True)
        else:
            attn = torch.softmax(score, dim=-1)
        return (attn[:, :, None] * value).sum(dim=1), attn


class MultiHeadAttention(nn.Module):
    """q / k / v projections to `dim`, split into heads, no output
    projection: (context (B, Q, dim), attention (B, H, Q, K))."""

    def __init__(self, query_dim: int, key_dim: int, value_dim: int, dim: int,
                 num_heads: int = 8):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.query_proj = nn.Linear(query_dim, dim)
        self.key_proj = nn.Linear(key_dim, dim)
        self.value_proj = nn.Linear(value_dim, dim)

    def forward(self, query, key, value) -> Pair:
        B, Q, _ = query.shape
        H, D = self.num_heads, self.dim // self.num_heads
        q = self.query_proj(query).reshape(B, Q, H, D).transpose(1, 2)
        k = self.key_proj(key).reshape(B, -1, H, D).transpose(1, 2)
        v = self.value_proj(value).reshape(B, -1, H, D).transpose(1, 2)
        attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(D), dim=-1)
        return (attn @ v).transpose(1, 2).reshape(B, Q, self.dim), attn
