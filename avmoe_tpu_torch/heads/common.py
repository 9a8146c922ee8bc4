"""Post-norm transformer encoder/decoder stacks and the BiLSTM of the heads.

Counterpart of `avmoe_tpu/heads/common.py`. Dropout (rate 0.1 by default:
attention weights, both residual branches and the feed-forward hidden) runs
in train mode only, from an explicit generator; on the attention weights its
mask is one (queries, keys) draw shared by every batch row and head, as
flax's `broadcast_dropout=True` default draws it. Attention follows flax's
MultiHeadDotProductAttention: per-head
query/key/value projections with (C, H, D) kernels and an (H, D, C) output
projection, q scaled by D**-0.5. The decoder's keys and values are the
concatenation of memory and target.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from avmoe_tpu_torch.ops.dropout import dropout
from avmoe_tpu_torch.ops.norm import LayerNorm

Gen = Optional[torch.Generator]


class DenseGeneral(nn.Module):
    """flax DenseGeneral as used by MHA: kernel (C, H, D) in, (H, D, C) out."""

    def __init__(self, kernel_shape, bias_shape):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(*kernel_shape))
        self.bias = nn.Parameter(torch.zeros(*bias_shape))


class MultiHeadAttention(nn.Module):
    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        D = d_model // num_heads
        self.query = DenseGeneral((d_model, num_heads, D), (num_heads, D))
        self.key = DenseGeneral((d_model, num_heads, D), (num_heads, D))
        self.value = DenseGeneral((d_model, num_heads, D), (num_heads, D))
        self.out = DenseGeneral((num_heads, D, d_model), (d_model,))

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor, *, rate: float = 0.0,
                train: bool = False, generator: Gen = None) -> torch.Tensor:
        def proj(m, x):
            return torch.einsum("btc,chd->bthd", x, m.kernel) + m.bias

        q, k, v = proj(self.query, q_in), proj(self.key, kv_in), proj(self.value, kv_in)
        q = q / math.sqrt(q.shape[-1])
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        if rate > 0.0 and train:   # one (q, k) mask for every batch row and head
            w = w * dropout(w.new_ones(w.shape[-2:]), rate, train=train, generator=generator)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v)
        return torch.einsum("bqhd,hdc->bqc", o, self.out.kernel) + self.out.bias


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 1024,
                 dropout: float = 0.1):
        super().__init__()
        self.rate = dropout
        self.self_attn = MultiHeadAttention(d_model, nhead)
        self.norm1 = LayerNorm(d_model)
        self.ff1 = nn.Linear(d_model, dim_feedforward)
        self.ff2 = nn.Linear(dim_feedforward, d_model)
        self.norm2 = LayerNorm(d_model)

    def forward(self, x: torch.Tensor, train: bool = False, generator: Gen = None
                ) -> torch.Tensor:
        drop = lambda t: dropout(t, self.rate, train=train, generator=generator)
        x = self.norm1(x + drop(self.self_attn(x, x, rate=self.rate, train=train,
                                               generator=generator)))
        return self.norm2(x + drop(self.ff2(drop(F.relu(self.ff1(x))))))


class DecoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 1024,
                 dropout: float = 0.1):
        super().__init__()
        self.rate = dropout
        self.cross_attn = MultiHeadAttention(d_model, nhead)
        self.norm1 = LayerNorm(d_model)
        self.ff1 = nn.Linear(d_model, dim_feedforward)
        self.ff2 = nn.Linear(dim_feedforward, d_model)
        self.norm2 = LayerNorm(d_model)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor, train: bool = False,
                generator: Gen = None) -> torch.Tensor:
        drop = lambda t: dropout(t, self.rate, train=train, generator=generator)
        mem = torch.cat([memory, tgt], dim=1)  # keys/values include the target
        tgt = self.norm1(tgt + drop(self.cross_attn(tgt, mem, rate=self.rate, train=train,
                                                    generator=generator)))
        return self.norm2(tgt + drop(self.ff2(drop(F.relu(self.ff1(tgt))))))


class TransformerEncoder(nn.Module):
    def __init__(self, d_model: int, nhead: int, num_layers: int, dim_feedforward: int = 1024):
        super().__init__()
        self.layers = []
        for i in range(num_layers):
            layer = EncoderLayer(d_model, nhead, dim_feedforward)
            self.add_module(f"layer_{i}", layer)
            self.layers.append(layer)

    def forward(self, x: torch.Tensor, train: bool = False, generator: Gen = None
                ) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, train, generator)
        return x


class TransformerDecoder(nn.Module):
    def __init__(self, d_model: int, nhead: int, num_layers: int, dim_feedforward: int = 1024):
        super().__init__()
        self.layers = []
        for i in range(num_layers):
            layer = DecoderLayer(d_model, nhead, dim_feedforward)
            self.add_module(f"layer_{i}", layer)
            self.layers.append(layer)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor, train: bool = False,
                generator: Gen = None) -> torch.Tensor:
        for layer in self.layers:
            tgt = layer(tgt, memory, train, generator)
        return tgt


class LSTMCell(nn.Module):
    """One LSTM direction: gates i, f, g, o packed row-wise as in torch.

    weight_ih (4H, in), weight_hh (4H, H), bias (4H,); the flax cell's
    per-gate input kernels carry no bias, its hidden kernels do."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.weight_ih = nn.Parameter(torch.zeros(4 * hidden, in_dim))
        self.weight_hh = nn.Parameter(torch.zeros(4 * hidden, hidden))
        self.bias = nn.Parameter(torch.zeros(4 * hidden))

    def forward(self, x: torch.Tensor, reverse: bool = False, return_carry: bool = False):
        """(B, T, in) -> (B, T, H); reverse runs from the last step, outputs
        kept in input order. With return_carry, (outputs, (h, c)) of the
        last step run."""
        B, T, _ = x.shape
        xi = F.linear(x, self.weight_ih, self.bias)                 # (B, T, 4H)
        h = x.new_zeros(B, self.hidden)
        c = x.new_zeros(B, self.hidden)
        outs = [None] * T
        for t in (range(T - 1, -1, -1) if reverse else range(T)):
            gates = xi[:, t] + F.linear(h, self.weight_hh)
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs[t] = h
        out = torch.stack(outs, dim=1)
        return (out, (h, c)) if return_carry else out


class BiLSTM(nn.Module):
    """Single-layer bidirectional LSTM over (B, T, C) -> (B, T, 2*hidden)."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.fwd_cell = LSTMCell(in_dim, hidden)
        self.bwd_cell = LSTMCell(in_dim, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.fwd_cell(x), self.bwd_cell(x, reverse=True)], dim=-1)
