"""GroupViT-style grouping heads of the AVVP (MGN) model.

Counterpart of `avmoe_tpu/heads/grouping.py`, with the flax tree's module
names. The heads run in float32 (the JAX package's Dense and Mlp promote
the float32 parameters), their MLPs on the exact erf GELU:

  * AttnBlock: pre-norm self-attention transformer block, DropPath on both
    residual branches (train only, per sample, from the generator);
  * CrossAttnBlock: query + attention(query, key), + MLP, then a post-norm;
  * AssignAttention: token -> group assignment, softmax over the group axis
    (-2), or its straight-through argmax ('hard'), or a Gumbel-softmax in
    train ('gumbel'), then rows renormalized over the tokens;
  * GroupingBlock: group tokens projected to the output groups by an MLP over
    the token axis, a cross-attention, the assignment and a channel MLP;
  * ModalityTrans: AttnBlocks over [tokens ; group tokens], optionally the
    HAN grouping of the tokens against the other modality's, then grouping.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from avmoe_tpu_torch.ops.dropout import drop_path_scale
from avmoe_tpu_torch.ops.norm import LayerNorm
from avmoe_tpu_torch.ops.swin import Mlp

Gen = Optional[torch.Generator]

# Fixed by the MGN heads: every attention has 8 heads, every transformer MLP a
# 4x hidden width, and the assignment a Gumbel temperature of 1 and a
# renormalization epsilon of 1.
NUM_HEADS = 8
MLP_RATIO = 4
GUMBEL_TAU = 1.0
ASSIGN_EPS = 1.0


def gumbel_noise(shape, generator: torch.Generator, device, dtype) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(u)) with u uniform in (tiny, 1), drawn
    from `generator`."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device).clamp_(min=tiny)
    return (-torch.log(-torch.log(u))).to(dtype)


def _one_hot_argmax(y: torch.Tensor, dim: int) -> torch.Tensor:
    idx = torch.argmax(y, dim=dim, keepdim=True)
    return torch.zeros_like(y).scatter_(dim, idx, 1.0)


def _straight_through(y_soft: torch.Tensor, dim: int) -> torch.Tensor:
    """The argmax's one-hot in the forward, y_soft's gradient in the backward."""
    return _one_hot_argmax(y_soft, dim) - y_soft.detach() + y_soft


def gumbel_softmax(logits: torch.Tensor, tau: float = 1.0, hard: bool = False, dim: int = -1,
                   *, generator: Gen = None, noise: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """softmax((logits + g) / tau) over `dim`, g Gumbel noise given as `noise`
    or drawn from `generator`; with `hard`, its straight-through argmax."""
    if noise is None:
        if generator is None:
            raise ValueError("a Gumbel-softmax in train mode needs a torch.Generator")
        noise = gumbel_noise(logits.shape, generator, logits.device, logits.dtype)
    y_soft = torch.softmax((logits + noise.to(logits.dtype)) / tau, dim=dim)
    return _straight_through(y_soft, dim) if hard else y_soft


class ProjAttention(nn.Module):
    """q/k/v-projected multi-head attention, NUM_HEADS heads."""

    def __init__(self, dim: int):
        super().__init__()
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, query: torch.Tensor, key: Optional[torch.Tensor] = None,
                value: Optional[torch.Tensor] = None) -> torch.Tensor:
        key = query if key is None else key
        value = key if value is None else value
        B, N, C = query.shape
        H = NUM_HEADS
        D = C // H
        q = self.q_proj(query).reshape(B, N, H, D)
        k = self.k_proj(key).reshape(B, -1, H, D)
        v = self.v_proj(value).reshape(B, -1, H, D)
        attn = torch.softmax(torch.einsum("bnhd,bshd->bhns", q, k) * D ** -0.5, dim=-1)
        out = torch.einsum("bhns,bshd->bnhd", attn, v).reshape(B, N, C)
        return self.proj(out)


def _mlp(m: Mlp, x: torch.Tensor) -> torch.Tensor:
    return m.fc2(F.gelu(m.fc1(x)))


class AttnBlock(nn.Module):
    """Pre-norm self-attention transformer block with DropPath."""

    def __init__(self, dim: int, drop_path: float = 0.0):
        super().__init__()
        self.drop_path = drop_path
        self.norm1 = LayerNorm(dim)
        self.attn = ProjAttention(dim)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, MLP_RATIO * dim, dim)

    def _residual(self, x: torch.Tensor, h: torch.Tensor, train: bool, generator: Gen):
        s = drop_path_scale(x.shape[0], self.drop_path, train=train, generator=generator,
                            device=x.device)
        return x + h if s is None else x + s[:, None, None] * h

    def forward(self, x: torch.Tensor, train: bool = False, generator: Gen = None):
        x = self._residual(x, self.attn(self.norm1(x)), train, generator)
        return self._residual(x, _mlp(self.mlp, self.norm2(x)), train, generator)


class CrossAttnBlock(nn.Module):
    """Cross-attention block, post-norm: no norm before the attention."""

    def __init__(self, dim: int):
        super().__init__()
        self.attn = ProjAttention(dim)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, MLP_RATIO * dim, dim)
        self.norm_post = LayerNorm(dim)

    def forward(self, query: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
        x = query + self.attn(query, key)
        x = x + _mlp(self.mlp, self.norm2(x))
        return self.norm_post(x)


class AssignAttention(nn.Module):
    """Token -> group assignment. forward(query (B, S2, C) groups, key (B, L, C)
    tokens) -> (grouped (B, S2, C), attn dict or None); with return_attn the
    dict holds 'hard' (the assignment as used) and 'soft', which is
    1 + softmax_tokens(softmax_groups(raw)), as the JAX package computes it."""

    def __init__(self, dim: int, hard: bool = False, gumbel: bool = False):
        super().__init__()
        self.hard, self.gumbel = hard, gumbel
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, query: torch.Tensor, key: torch.Tensor, train: bool = False,
                return_attn: bool = False, generator: Gen = None
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
        C = query.shape[-1]
        q, k, v = self.q_proj(query), self.k_proj(key), self.v_proj(key)
        raw = torch.einsum("bgc,btc->bgt", q, k) * C ** -0.5   # (B, groups, tokens)
        if self.gumbel and train:
            attn = gumbel_softmax(raw, GUMBEL_TAU, self.hard, dim=-2, generator=generator)
        elif self.hard:
            attn = _straight_through(torch.softmax(raw, dim=-2), -2)
        else:
            attn = torch.softmax(raw, dim=-2)
        attn_dict = None
        if return_attn:
            soft = torch.softmax(raw, dim=-2)
            attn_dict = {"hard": attn, "soft": 1.0 + torch.softmax(soft, dim=-1)}
        attn = attn / (attn.sum(dim=-1, keepdim=True) + ASSIGN_EPS)
        out = torch.einsum("bgt,btc->bgc", attn, v)
        return self.proj(out), attn_dict


class GroupingBlock(nn.Module):
    """Group tokens + input tokens -> output group features.
    forward(x (B, L, C), group_tokens (B, S1, C)) -> ((B, S2, C), attn dict)."""

    def __init__(self, dim: int, num_group_token: int, num_output_group: int,
                 hard: bool = False, gumbel: bool = False):
        super().__init__()
        self.num_group_token = num_group_token
        self.norm_tokens = LayerNorm(dim)
        self.norm_x = LayerNorm(dim)
        self.mlp_inter = Mlp(num_group_token, int(0.5 * dim), num_output_group)
        self.norm_post_tokens = LayerNorm(dim)
        self.pre_assign_attn = CrossAttnBlock(dim)
        self.assign = AssignAttention(dim, hard=hard, gumbel=gumbel)
        self.norm_new_x = LayerNorm(dim)
        self.mlp_channels = Mlp(dim, MLP_RATIO * dim, dim)

    def forward(self, x: torch.Tensor, group_tokens: torch.Tensor, train: bool = False,
                return_attn: bool = False, generator: Gen = None):
        if group_tokens.shape[1] != self.num_group_token:
            raise ValueError(f"{group_tokens.shape[1]} group tokens, built for "
                             f"{self.num_group_token}")
        group_tokens = self.norm_tokens(group_tokens)
        x = self.norm_x(x)
        # project the S1 group tokens to S2 output groups: an MLP over the token axis
        g = _mlp(self.mlp_inter, group_tokens.transpose(1, 2))
        projected = self.norm_post_tokens(g.transpose(1, 2))
        projected = self.pre_assign_attn(projected, x)
        new_x, attn_dict = self.assign(projected, x, train, return_attn, generator)
        new_x = new_x + projected
        return new_x + _mlp(self.mlp_channels, self.norm_new_x(new_x)), attn_dict


class ModalityTrans(nn.Module):
    """AttnBlocks over [x ; group tokens], the HAN grouping (use_han) of x
    against the other modality's `num_other_tokens` tokens, then grouping.

    forward(x (B, L, C), group_token (S1, C) class tokens or (B, S1, C)
    features, x_other) -> (grouped (B, S2, C), attn dict, pre-grouping x).
    HAN's assignment is the opposite of the head's: with soft assignment it
    draws Gumbel noise in train and takes a straight-through argmax in eval.
    """

    def __init__(self, dim: int, depth: int, num_group_tokens: int = 25,
                 num_output_groups: int = 25, hard_assignment: bool = False,
                 use_han: bool = False, num_other_tokens: int = 0, drop_path: float = 0.1):
        super().__init__()
        self.depth, self.num_group_tokens, self.use_han = depth, num_group_tokens, use_han
        for i in range(depth):
            self.add_module(f"block_{i}", AttnBlock(dim, drop_path=drop_path))
        if use_han:
            self.han_encoder = GroupingBlock(
                dim, num_other_tokens, num_other_tokens,
                hard=not hard_assignment, gumbel=not hard_assignment)
        self.grouping = GroupingBlock(dim, num_group_tokens, num_output_groups,
                                      hard=hard_assignment, gumbel=hard_assignment)

    def forward(self, x: torch.Tensor, group_token: torch.Tensor,
                x_other: Optional[torch.Tensor] = None, train: bool = False,
                return_attn: bool = False, generator: Gen = None):
        B = x.shape[0]
        gt = group_token.expand(B, *group_token.shape) if group_token.dim() == 2 else group_token
        cat = torch.cat([x, gt], dim=1)
        for i in range(self.depth):
            cat = getattr(self, f"block_{i}")(cat, train, generator)
        x_attn = cat[:, : -self.num_group_tokens]
        gt = cat[:, -self.num_group_tokens:]
        if self.use_han and x_other is not None:
            x_attn, _ = self.han_encoder(x_attn, x_other, train, False, generator)
        out, attn_dict = self.grouping(x_attn, gt, train, return_attn, generator)
        return out, attn_dict, x_attn
