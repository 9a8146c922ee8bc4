"""AVMoE adapter experts and the soft router.

Counterpart of `avmoe_tpu/moe/adapter.py`. Expert parameters are stored
stacked with a leading expert axis E, as the JAX package's `nn.vmap` stores
them, and the experts run as one batched computation over that axis. The
mixture is the materialized dense one: every expert's (B, N, C) output,
weighted by the router's softmax gates. That is the same function as the
JAX package's fused eval combine, and, in train, the function of its
unfused train path (AVMOE_FUSED_MOE_TRAIN unset): the bottleneck's batch
norms run on batch statistics over each expert's (B, N) rows.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from avmoe_tpu_torch.config import AdapterConfig, MoEConfig
from avmoe_tpu_torch.heads.common import DenseGeneral
from avmoe_tpu_torch.ops.dropout import dropout
from avmoe_tpu_torch.ops.norm import BatchNorm, LayerNorm


def _per_expert(p: torch.Tensor, ndim: int) -> torch.Tensor:
    """(E, 1) scalar-per-expert parameter -> (E, 1, ..., 1) of rank ndim."""
    return p.reshape(p.shape[0], *([1] * (ndim - 1)))


class GroupedDense(nn.Module):
    """Grouped 1x1 projection over the channel axis (block-diagonal matmul),
    stacked over E experts: kernel (E, g, in/g, out/g), input (E, ..., in).
    With num=None it is one unstacked projection, kernel (g, in/g, out/g)
    over any (..., in), as the single adapters of the legacy AVE models
    store it."""

    def __init__(self, in_dim: int, features: int, num_groups: int, num: Optional[int]):
        super().__init__()
        g = num_groups
        if in_dim % g or features % g:
            raise ValueError(f"GroupedDense: {in_dim} -> {features} not divisible by {g} groups")
        self.num_groups = g
        self.features = features
        lead = () if num is None else (num,)
        self.kernel = nn.Parameter(torch.zeros(*lead, g, in_dim // g, features // g))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.num_groups
        xg = x.reshape(*x.shape[:-1], g, x.shape[-1] // g)
        spec = "...gi,gio->...go" if self.kernel.dim() == 3 else "e...gi,egio->e...go"
        out = torch.einsum(spec, xg, self.kernel.to(x.dtype))
        return out.reshape(*x.shape[:-1], self.features)


class _Bottleneck(nn.Module):
    """down -> BN -> [ReLU] -> up -> BN, stacked over E experts (unstacked
    with num=None)."""

    def __init__(self, dim: int, cfg: AdapterConfig, use_activation: bool, num: Optional[int]):
        super().__init__()
        hidden = max(dim // cfg.downsample, cfg.num_conv_group)
        self.use_activation = use_activation
        self.down = GroupedDense(dim, hidden, cfg.num_conv_group, num)
        self.up = GroupedDense(hidden, dim, cfg.num_conv_group, num)
        self.use_bn = cfg.use_bn
        if cfg.use_bn:
            stack = () if num is None else (num,)
            self.bn1 = BatchNorm(hidden, stack=stack)
            self.bn2 = BatchNorm(dim, stack=stack)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        z = self.down(x)
        if self.use_bn:
            z = self.bn1(z, train=train)
        if self.use_activation:
            z = F.relu(z)
        out = self.up(z)
        if self.use_bn:
            out = self.bn2(out, train=train)
        return out


class _Expert(nn.Module):
    """Shared tail of both expert kinds: [ln_before] -> bottleneck ->
    [ln_post] -> [gate], stacked over `num` experts."""

    def __init__(self, dim: int, cfg: AdapterConfig, num: int, use_activation: bool):
        super().__init__()
        self.cfg = cfg
        if cfg.use_gate:
            self.gate = nn.Parameter(torch.zeros(num, 1))
        if cfg.before_layernorm:
            self.ln_before = LayerNorm(dim, stack=(num,))
        if cfg.post_layernorm:
            self.ln_post = LayerNorm(dim, stack=(num,))
        self.bottleneck = _Bottleneck(dim, cfg, use_activation, num)

    def _tail(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if self.cfg.before_layernorm:
            x = self.ln_before(x)
        out = self.bottleneck(x, train)
        if self.cfg.post_layernorm:
            out = self.ln_post(out)
        if self.cfg.use_gate:
            out = _per_expert(self.gate, out.dim()).to(out.dtype) * out
        return out


class CrossModalExpert(_Expert):
    """Latent tokens attend to the other modality, re-inject into x through
    gate_av, then the bottleneck (with ReLU)."""

    def __init__(self, dim: int, cfg: AdapterConfig, num: int):
        super().__init__(dim, cfg, num, use_activation=True)
        self.latent_tokens = nn.Parameter(torch.zeros(num, cfg.num_tokens, dim))
        self.gate_av = nn.Parameter(torch.zeros(num, 1))

    def forward(self, x: torch.Tensor, other: torch.Tensor, train: bool = False) -> torch.Tensor:
        """x (B, N, C), other (B, M, C) -> (E, B, N, C)."""
        dt = x.dtype
        B = x.shape[0]
        E, T, C = self.latent_tokens.shape
        rep = self.latent_tokens.to(dt)[:, None].expand(E, B, T, C)
        # logits accumulate in float32 (bf16 operands are exact in float32)
        att_o2t = torch.softmax(
            torch.einsum("ebtc,bmc->ebtm", rep.float(), other.float()), dim=-1).to(dt)
        rep = rep + torch.einsum("ebtm,bmc->ebtc", att_o2t, other.to(dt))
        att_t2x = torch.softmax(
            torch.einsum("bnc,ebtc->ebnt", x.float(), rep.float()), dim=-1).to(dt)
        delta = torch.einsum("ebnt,ebtc->ebnc", att_t2x, rep)
        xe = x[None] + _per_expert(self.gate_av, 4).to(dt) * delta
        return self._tail(xe, train)


class _GramBf16(torch.autograd.Function):
    """x xᵀ in float32 for a bf16 x on the card: one bf16 product that
    accumulates in float32 on the tensor cores. The products of bf16 values
    are exact there, as they are in the float32 product of the upcast values.
    The backward is the float32 one of that product, each operand's part cast
    to bf16 as the upcast's backward casts it."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x)
        return torch.bmm(x, x.transpose(1, 2), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        (x,) = ctx.saved_tensors
        xf = x.float()
        return torch.bmm(g, xf).to(x.dtype) + torch.bmm(g.transpose(1, 2), xf).to(x.dtype)


def _gram_f32(x: torch.Tensor) -> torch.Tensor:
    """(B, N, C) -> (B, N, N) float32 logits x_i . x_j."""
    if x.is_cuda and x.dtype == torch.bfloat16:
        return _GramBf16.apply(x)
    return torch.matmul(x.float(), x.float().transpose(1, 2))


class StackedMultiHeadAttention(nn.Module):
    """flax MultiHeadDotProductAttention (self-attention, 4 heads), one per
    expert, over (L, S, C) inputs: attention over the S axis at each L index.
    Its DenseGeneral kernels carry the expert axis first: (E, C, H, D) and
    (E, H, D) biases in, (E, H, D, C) and (E, C) out.

    As flax computes it at `dtype`: q scaled by D**-0.5 before the product,
    the logits and the softmax in the compute dtype (flax promotes q and k
    to it and leaves force_fp32_for_softmax off), the weights cast to it.
    Train dropout (rate 0.2) multiplies the weights by one (queries, keys)
    mask per expert, shared by every L row and head (flax's
    broadcast_dropout, one rng per expert under nn.vmap)."""

    RATE = 0.2

    def __init__(self, dim: int, num: int, num_heads: int = 4):
        super().__init__()
        H, D = num_heads, dim // num_heads
        self.query = DenseGeneral((num, dim, H, D), (num, H, D))
        self.key = DenseGeneral((num, dim, H, D), (num, H, D))
        self.value = DenseGeneral((num, dim, H, D), (num, H, D))
        self.out = DenseGeneral((num, H, D, dim), (num, dim))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (L, S, C) -> (E, L, S, C)."""
        dt = x.dtype

        def proj(m):
            return (torch.einsum("lsc,echd->elshd", x, m.kernel.to(dt))
                    + m.bias.to(dt)[:, None, None])

        q, k, v = proj(self.query), proj(self.key), proj(self.value)
        q = q / torch.tensor(math.sqrt(q.shape[-1])).to(dt)   # sqrt(D) rounded to dt
        w = torch.softmax(torch.einsum("elqhd,elkhd->elhqk", q, k), dim=-1).to(dt)
        if train:
            E, S = w.shape[0], w.shape[-1]
            w = w * dropout(w.new_ones(E, 1, 1, S, S), self.RATE, train=train,
                            generator=generator)
        o = torch.einsum("elhqk,elkhd->elqhd", w, v)
        return (torch.einsum("elqhd,ehdc->elqc", o, self.out.kernel.to(dt))
                + self.out.bias.to(dt)[:, None, None])


def _latent_self_attention(x: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The 'token' expert's two hops for x (B, N, C) and per-expert latent
    tokens (E, T, C): the tokens attend to x, then x attends to the updated
    tokens; float32 logits, weights cast to x's dtype. Returns the delta
    A @ rep (E, B, N, C) that gate_self scales."""
    dt = x.dtype
    B = x.shape[0]
    E, T, C = tokens.shape
    rep = tokens.to(dt)[:, None].expand(E, B, T, C)
    att_x2t = torch.softmax(torch.einsum("ebtc,bnc->ebtn", rep.float(), x.float()),
                            dim=-1).to(dt)
    rep = rep + torch.einsum("ebtn,bnc->ebtc", att_x2t, x)
    att_t2x = torch.softmax(torch.einsum("bnc,ebtc->ebnt", x.float(), rep.float()),
                            dim=-1).to(dt)
    return torch.einsum("ebnt,ebtc->ebnc", att_t2x, rep)


class UnimodalExpert(_Expert):
    """Bottleneck (no activation) on x alone, after an optional self-attention:
    'none' (AVE, AVQA); 'bmm' (AVVP), a gated dot-product self-attention with
    a per-expert gate_av; 'mha' (AVS S4), a 4-head MHA per expert that
    replaces x; 'token' (AVS MS3), the latent-token two-hop attention of the
    cross-modal expert over x itself, gated by gate_self."""

    KINDS = ("none", "bmm", "mha", "token")

    def __init__(self, dim: int, cfg: AdapterConfig, num: int):
        if cfg.self_attention not in self.KINDS:
            raise ValueError(f"self_attention={cfg.self_attention!r}, want one of {self.KINDS}")
        super().__init__(dim, cfg, num, use_activation=False)
        if cfg.self_attention == "bmm":
            self.gate_av = nn.Parameter(torch.zeros(num, 1))
        elif cfg.self_attention == "mha":
            self.self_attention = StackedMultiHeadAttention(dim, num)
        elif cfg.self_attention == "token":
            self.latent_tokens = nn.Parameter(torch.zeros(num, cfg.num_tokens, dim))
            self.gate_self = nn.Parameter(torch.zeros(num, 1))

    def forward(self, x: torch.Tensor, other: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, N, C) -> (E, B, N, C)."""
        del other
        E = self.bottleneck.down.kernel.shape[0]
        dt = x.dtype
        kind = self.cfg.self_attention
        if kind == "none":
            return self._tail(x[None].expand(E, *x.shape), train)
        if kind == "mha":
            # attention ACROSS the frame axis B' at each token index, as the
            # reference's sequence-first torch MHA reads (B', N, C): it mixes
            # the samples of a batch
            xe = self.self_attention(x.transpose(0, 1), train, generator)
            xe = xe.transpose(1, 2).contiguous()
            return self._tail(xe, train)
        if kind == "token":
            delta = _latent_self_attention(x, self.latent_tokens)
            return self._tail(x[None] + _per_expert(self.gate_self, 4).to(dt) * delta, train)
        # att[i, j] = softmax_j(x_i . x_j), float32 logits, cast to x's dtype;
        # res_j = sum_i att[i, j] x_i: the transposed product att^T x. Both
        # are the same for every expert: only gate_av differs.
        att = torch.softmax(_gram_f32(x), dim=-1).to(dt)
        res = torch.matmul(att.transpose(1, 2), x)
        xe = x[None] + _per_expert(self.gate_av, 4).to(dt) * res[None]
        return self._tail(xe, train)


def project_tokens(other: torch.Tensor, tk: torch.Tensor, tb: torch.Tensor,
                   fk: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
    """The other modality in this one's shape, in other's dtype: (B, M,
    C_other) through the token-axis dense tk (N, M) with bias tb (N,), then
    the channel dense fk (C_other, C) with bias fb (C,), -> (B, N, C). The
    two products commute, so the cheaper order is taken, and the token bias
    is folded through fk's column sums."""
    dt = other.dtype
    tkd, fkd = tk.to(dt), fk.to(dt)
    if fk.shape[1] < fk.shape[0]:
        proj = torch.matmul(tkd, other @ fkd)
    else:
        proj = torch.matmul(tkd, other) @ fkd
    folded = tb[:, None] * fk.sum(dim=0)[None, :] + fb[None, :]
    return proj + folded.to(dt)[None]


def router_noise(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard normal router-logit noise of `shape`, drawn from `generator`."""
    if generator is None:
        raise ValueError("router noise in train mode needs a torch.Generator")
    return torch.randn(shape, generator=generator, device=device)


class MoEAdapter(nn.Module):
    """Router + dense soft mixture over cross-modal and unimodal experts.

    1. project the other modality into this modality's (N, C) shape
       (token-axis dense then channel dense; the two commute, so the cheaper
       order is taken and the token bias is folded through fc's column sums);
    2. route on mean-pooled features of both, in float32 (train adds the
       configured Gaussian router noise, drawn from the generator);
    3. weight every expert's output by the softmax gates.

    Returns (out (B, N, C), aux) with aux['gating_probs'] (B, E),
    aux['expert_index'] (B,) and, when configured, aux['lb_loss'].
    """

    def __init__(self, dim: int, other_dim: int, num_tokens: int, other_num_tokens: int,
                 cfg: MoEConfig):
        super().__init__()
        self.dim, self.other_dim = dim, other_dim
        self.num_tokens, self.other_num_tokens = num_tokens, other_num_tokens
        self.cfg = cfg
        self.token_proj_kernel = nn.Parameter(torch.zeros(num_tokens, other_num_tokens))
        self.token_proj_bias = nn.Parameter(torch.zeros(num_tokens))
        self.fc_kernel = nn.Parameter(torch.zeros(other_dim, dim))
        self.fc_bias = nn.Parameter(torch.zeros(dim))
        width = 2 * dim
        for i, hidden in enumerate(cfg.router_hidden):
            self.add_module(f"router_fc{i}", nn.Linear(width, hidden))
            width = hidden
        self.router_out = nn.Linear(width, cfg.num_experts)
        if cfg.num_multimodal_experts > 0:
            self.multimodal_experts = CrossModalExpert(dim, cfg.adapter,
                                                       cfg.num_multimodal_experts)
        if cfg.num_singlemodal_experts > 0:
            self.singlemodal_experts = UnimodalExpert(dim, cfg.adapter,
                                                      cfg.num_singlemodal_experts)

    def project_other(self, other: torch.Tensor) -> torch.Tensor:
        """(B, M, C_other) -> (B, N, C)."""
        return project_tokens(other, self.token_proj_kernel, self.token_proj_bias,
                              self.fc_kernel, self.fc_bias)

    def forward(self, x: torch.Tensor, other: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        B, N, C = x.shape
        if N != self.num_tokens or C != self.dim:
            raise ValueError(f"x {tuple(x.shape)} does not match adapter "
                             f"({self.num_tokens}, {self.dim})")
        other_proj = self.project_other(other.to(x.dtype))

        h = torch.cat([x.mean(dim=1), other_proj.mean(dim=1)], dim=-1).float()
        for i in range(len(self.cfg.router_hidden)):
            h = F.relu(getattr(self, f"router_fc{i}")(h))
        logits = self.router_out(h)
        if train and self.cfg.router_noise_std > 0:
            logits = logits + self.cfg.router_noise_std * router_noise(
                logits.shape, generator, logits.device)
        probs = torch.softmax(logits, dim=-1)                        # (B, E)

        outs = []
        if self.cfg.num_multimodal_experts > 0:
            outs.append(self.multimodal_experts(x, other_proj, train))
        if self.cfg.num_singlemodal_experts > 0:
            outs.append(self.singlemodal_experts(x, other_proj, train, generator))
        expert_out = torch.cat(outs, dim=0)                          # (E, B, N, C)
        out = torch.einsum("ebnc,be->bnc", expert_out, probs.to(expert_out.dtype))

        aux = {"gating_probs": probs, "expert_index": torch.argmax(probs, dim=-1)}
        if self.cfg.load_balance_loss:
            E = self.cfg.num_experts
            mean_p = torch.clamp(probs.mean(dim=0), 1e-9, 1.0)
            if self.cfg.lb_loss_compat:
                aux["lb_loss"] = -torch.log(mean_p).sum()
            else:
                u = 1.0 / E
                aux["lb_loss"] = (u * (math.log(u) - torch.log(mean_p))).sum() / E
        return out, aux
