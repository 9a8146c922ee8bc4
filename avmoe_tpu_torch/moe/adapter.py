"""AVMoE adapter experts and the soft router.

Counterpart of `avmoe_tpu/moe/adapter.py`. Expert parameters are stored
stacked with a leading expert axis E, as the JAX package's `nn.vmap` stores
them, and the experts run as one batched computation over that axis.

The mixture has two routes, both exact:
  * materialized (the default): every expert's (B, N, C) output, weighted
    by the router's softmax gates; in train the bottleneck's batch norms
    run on batch statistics over each expert's (B, N) rows;
  * fused (`MoEAdapter(..., fused_moe=True)` in eval, `fused_moe_train=True`
    in train; the JAX package's AVMOE_FUSED_MOE / AVMOE_FUSED_MOE_TRAIN):
    the (E, B, N, C) expert outputs are never built. ln_before and a gated
    latent-token delta fold into the down projection (`fused_trunk_z`),
    bn2 folds into the up kernel (running statistics in eval; in train the
    batch statistics of the never-built up projection in closed form from
    z's first and second moments, `_Bottleneck.finish`), ln_post's row
    statistics come from closed-form quadratic forms, and the mixture is
    one grouped product over (expert x bottleneck) plus a rank-3E epilogue
    (`fused_gated_combine`). The 'bmm' and 'mha' experts' deltas stay
    materialized; only their trunk and the combine fuse.
Moments and statistics are float32, products in the compute dtype, as in
the JAX package. Under a process group (`parallel/mesh.py`) the train
path's batch reductions (BatchNorm statistics, the fused moments of z, the
load-balance loss's mean gate, the 'mha' expert's attention across the
frames) run over the global batch.
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
from avmoe_tpu_torch.ops.norm import BatchNorm, LayerNorm, global_means
from avmoe_tpu_torch.parallel.mesh import gather_batch, local_slice


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

    def finish(self, z: torch.Tensor, train: bool = False, apply_bn1: bool = True
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        """The split tail of the stacked bottleneck from its down projection
        z (E, B, N, h): [bn1] -> [ReLU], then, instead of the up projection
        and bn2, the float32 up kernel U (E, g, i, o) and bn2's folded
        (w, b) (E, C) for `fused_gated_combine`. In train, bn2's batch
        statistics of o = z U come in closed form from z's moments,
        mean = E[z] U and E[o²] = uᵀ E[z zᵀ] u per group, and update its
        running averages as the materialized path's bn2 does."""
        if self.use_bn and apply_bn1:
            z = self.bn1(z, train=train)
        if self.use_activation:
            z = F.relu(z)
        U = self.up.kernel
        E, g, i, o = U.shape
        if not self.use_bn:
            ones = U.new_ones(E, g * o)
            return z, (U, ones, torch.zeros_like(ones))
        if not train:
            return z, (U,) + self.bn2.folded()
        zf = z.float().reshape(E, -1, g, i)
        rows = zf.shape[1]
        zz = torch.einsum("ergi,ergj->egij", zf, zf)
        mz, M = global_means(rows, zf.sum(dim=1), zz)
        mean = torch.einsum("egi,egio->ego", mz, U).reshape(E, -1)
        sq = torch.einsum("egio,egij,egjo->ego", U, M, U).reshape(E, -1)
        var = torch.clamp(sq - mean * mean, min=0.0)
        return z, (U,) + self.bn2.folded((mean, var))


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

    def _fused_z(self, x: torch.Tensor, delta=None) -> torch.Tensor:
        """The fused trunk's down projection z (E, B, N, h) of x (B, N, C)
        (+ the gated latent delta), ln_before folded in."""
        ln = ((self.ln_before.weight, self.ln_before.bias) if self.cfg.before_layernorm
              else None)
        return fused_trunk_z(x, self.bottleneck.down.kernel, ln=ln, delta=delta)

    def _split(self, z: torch.Tensor, train: bool, apply_bn1: bool = True) -> Dict:
        return tail_dict(self, *self.bottleneck.finish(z, train, apply_bn1))

    def _split_stream(self, xe: torch.Tensor, train: bool) -> Dict:
        """Split tail of a materialized (E, B, N, C) trunk stream (the 'bmm'
        and 'mha' experts): ln_before, down and bn1 as the materialized path
        runs them, then the bottleneck's split tail."""
        if self.cfg.before_layernorm:
            xe = self.ln_before(xe)
        z = self.bottleneck.down(xe)
        if self.bottleneck.use_bn:
            z = self.bottleneck.bn1(z, train=train)
        return self._split(z, train, apply_bn1=False)


class CrossModalExpert(_Expert):
    """Latent tokens attend to the other modality, re-inject into x through
    gate_av, then the bottleneck (with ReLU)."""

    def __init__(self, dim: int, cfg: AdapterConfig, num: int):
        super().__init__(dim, cfg, num, use_activation=True)
        self.latent_tokens = nn.Parameter(torch.zeros(num, cfg.num_tokens, dim))
        self.gate_av = nn.Parameter(torch.zeros(num, 1))

    def forward(self, x: torch.Tensor, other: torch.Tensor, train: bool = False,
                split_tail: bool = False):
        """x (B, N, C), other (B, M, C) -> (E, B, N, C); with split_tail the
        fused route's payload (`tail_dict`) instead."""
        rep, att_t2x, logits = _latent_attention(x, other, self.latent_tokens)
        if split_tail:
            return self._split(self._fused_z(x, (rep, att_t2x, logits, self.gate_av)), train)
        delta = torch.einsum("ebnt,ebtc->ebnc", att_t2x, rep)
        xe = x[None] + _per_expert(self.gate_av, 4).to(x.dtype) * delta
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


def _latent_attention(x: torch.Tensor, other: torch.Tensor, tokens: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The two hops of the latent-token attention for x (B, N, C), the
    attended stream other (B, M, C) (x itself for the 'token' expert) and
    per-expert latent tokens (E, T, C): the tokens attend to other, then x
    attends to the updated tokens. Logits in float32 (bf16 operands are
    exact there), weights cast to x's dtype. Returns rep (E, B, T, C), the
    weights A (E, B, N, T) and their float32 logits P; the delta that the
    gate scales is A @ rep."""
    dt = x.dtype
    B = x.shape[0]
    E, T, C = tokens.shape
    rep = tokens.to(dt)[:, None].expand(E, B, T, C)
    att_o2t = torch.softmax(torch.einsum("ebtc,bmc->ebtm", rep.float(), other.float()),
                            dim=-1).to(dt)
    rep = rep + torch.einsum("ebtm,bmc->ebtc", att_o2t, other.to(dt))
    logits = torch.einsum("bnc,ebtc->ebnt", x.float(), rep.float())
    return rep, torch.softmax(logits, dim=-1).to(dt), logits


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
                generator: Optional[torch.Generator] = None, split_tail: bool = False):
        """x (B, N, C) -> (E, B, N, C); with split_tail the fused route's
        payload (`tail_dict`) instead."""
        del other
        E = self.bottleneck.down.kernel.shape[0]
        dt = x.dtype
        kind = self.cfg.self_attention
        if kind == "none":
            if split_tail:
                return self._split(self._fused_z(x), train)
            return self._tail(x[None].expand(E, *x.shape), train)
        if kind == "token":
            rep, att, logits = _latent_attention(x, x, self.latent_tokens)
            if split_tail:
                return self._split(self._fused_z(x, (rep, att, logits, self.gate_self)), train)
            delta = torch.einsum("ebnt,ebtc->ebnc", att, rep)
            return self._tail(x[None] + _per_expert(self.gate_self, 4).to(dt) * delta, train)
        if kind == "mha":
            # attention ACROSS the frame axis B' at each token index, as the
            # reference's sequence-first torch MHA reads (B', N, C): it mixes
            # the samples of a batch, so a train step under a process group
            # attends over the global batch's frames and keeps its own rows
            xe = self.self_attention((gather_batch(x) if train else x).transpose(0, 1),
                                     train, generator)                # (E, N, B', C)
            if train:
                xe = local_slice(xe.transpose(0, 2), x.shape[0]).transpose(0, 2)
            xe = xe.transpose(1, 2).contiguous()
        else:
            # 'bmm': att[i, j] = softmax_j(x_i . x_j), float32 logits, cast to
            # x's dtype; res_j = sum_i att[i, j] x_i: the transposed product
            # att^T x. Both are the same for every expert: only gate_av differs.
            att = torch.softmax(_gram_f32(x), dim=-1).to(dt)
            res = torch.matmul(att.transpose(1, 2), x)
            xe = x[None] + _per_expert(self.gate_av, 4).to(dt) * res[None]
        if split_tail:
            return self._split_stream(xe, train)
        return self._tail(xe, train)


def fused_trunk_z(x: torch.Tensor, down: torch.Tensor, *,
                  ln: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  delta=None) -> torch.Tensor:
    """Bottleneck-rank trunk z = down(ln_before(x + d)) (E, B, N, h) of the
    shared x (B, N, C), without building the per-expert (E, B, N, C) trunk
    stream; counterpart of the JAX `_fused_trunk_z`.

    down: the stacked grouped kernel (E, g, i, oh); ln: ln_before's stacked
    (scale, bias) (E, C) or None; delta: None or (rep (E, B, T, C), A (E, B,
    N, T), P (E, B, N, T) float32 logits, gate (E, 1)) for d = gate · A rep.

    With LN parameters (s, b): down(LN(x + d)) = inv ⊙ [(x + d)(s∘D) −
    mu (s D)] + b D, where (x + d)(s∘D) = x (s∘D) + gate · A (rep (s∘D)),
    and the row statistics come from closed-form moments: Σ_c d = gate ·
    A rowsum(rep), Σ_c x d = gate · Σ_t A ⊙ P, Σ_c d² = gate² · A G Aᵀ
    with G = rep repᵀ. The products run in x's dtype, the statistics in
    float32."""
    dt = x.dtype
    B, N, C = x.shape
    E, g, i, oh = down.shape
    if ln is not None:
        s, b = (p.float().reshape(E, g, i) for p in ln)
        Dw = (down * s[..., None]).to(dt)
        zb = torch.einsum("egi,egio->ego", b, down.float()).reshape(E, 1, 1, -1)
        sD = torch.einsum("egi,egio->ego", s, down.float()).reshape(E, 1, 1, -1)
    else:
        Dw = down.to(dt)
    xD = torch.einsum("bngi,egio->ebngo", x.reshape(B, N, g, i), Dw).reshape(E, B, N, -1)
    if delta is not None:
        rep, A, P, gate = delta
        ga = gate.float().reshape(E, 1, 1, 1)
        T = rep.shape[2]
        repD = torch.einsum("ebtgi,egio->ebtgo", rep.to(dt).reshape(E, B, T, g, i),
                            Dw).reshape(E, B, T, -1)
        xD = xD + ga.to(dt) * torch.matmul(A.to(dt), repD)
    if ln is None:
        return xD.to(dt)
    xf = x.float()
    sx, sx2 = xf.sum(dim=-1), (xf * xf).sum(dim=-1)          # (B, N), shared
    if delta is None:
        mu, sq = sx / C, sx2 / C
    else:
        ga = ga.reshape(E, 1, 1)
        A32, rep32 = A.float(), rep.float()
        mu = (sx + ga * torch.matmul(A32, rep32.sum(dim=-1)[..., None])[..., 0]) / C
        xdot = (A32 * P.float()).sum(dim=-1)
        G = torch.matmul(rep32, rep32.transpose(-1, -2))      # (E, B, T, T)
        quad = (torch.matmul(A32, G) * A32).sum(dim=-1)
        sq = (sx2 + 2.0 * ga * xdot + ga * ga * quad) / C
    mu = mu.expand(E, B, N)
    inv = torch.rsqrt(torch.clamp(sq - mu * mu, min=0.0) + 1e-5)
    z = (xD.float() - mu[..., None] * sD) * inv[..., None] + zb
    return z.to(dt)


def tail_dict(expert: "_Expert", z: torch.Tensor, tail) -> Dict[str, torch.Tensor]:
    """The split-tail payload of a stack of experts: z (E, B, N, h), the up
    kernel (E, g, i, o), bn2's folded (w, b), ln_post's (scale, bias) (E,
    C) and the gate (E, 1), identity-filled where a flag is off."""
    U, bn2_w, bn2_b = tail
    if expert.cfg.post_layernorm:
        lnp_scale, lnp_bias = expert.ln_post.weight, expert.ln_post.bias
    else:
        lnp_scale, lnp_bias = torch.ones_like(bn2_w), torch.zeros_like(bn2_w)
    gate = expert.gate if expert.cfg.use_gate else bn2_w.new_ones(bn2_w.shape[0], 1)
    return {"z": z, "up_kernel": U, "bn2_w": bn2_w, "bn2_b": bn2_b,
            "lnp_scale": lnp_scale, "lnp_bias": lnp_bias, "gate": gate}


def fused_gated_combine(t: Dict[str, torch.Tensor], probs: torch.Tensor, *,
                        post_layernorm: bool, eps: float = 1e-5,
                        dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Σ_e p_be · gate_e · ln_post_e(bn2_e(z_e U_e)) (B, N, C), contracted at
    bottleneck rank; counterpart of the JAX `fused_gated_combine`.

    bn2's affine folds into the up kernel, ln_post's row statistics of o_e =
    (z U) w2 + b2 come from closed-form moments (Σ_c o = z (U w2)1 + Σ b2,
    Σ_c o² = z Q zᵀ + 2 z (U w2) b2 + Σ b2², Q = (U w2)(U w2)ᵀ per group),
    and the mixture is one grouped product over (expert x bottleneck) plus
    a rank-3E epilogue. t: the experts' `tail_dict`s concatenated along E;
    probs (B, E) the router's gates. Statistics in float32, the products in
    `dtype`."""
    z = t["z"].float()
    U = t["up_kernel"].float()
    E, B, N, h = z.shape
    _, g, i, o = U.shape
    C = g * o
    w2 = t["bn2_w"].float().reshape(E, g, o)
    b2 = t["bn2_b"].float()
    gp = t["lnp_scale"].float().reshape(E, g, o)
    bp = t["lnp_bias"].float()
    pe = probs.float() * t["gate"].float().reshape(1, E)      # (B, E)
    zg = z.reshape(E, B, N, g, i)
    Uw = U * w2[:, :, None, :]                                # bn2 folded
    if not post_layernorm:
        zw = zg * pe.t()[:, :, None, None, None]
        out = torch.einsum("ebngi,egio->bngo", zw.to(dtype), Uw.to(dtype)).reshape(B, N, C)
        return (out + (pe @ b2)[:, None, :].to(dtype)).to(dtype)
    mu = (torch.einsum("ebngi,egi->ebn", zg, Uw.sum(dim=3))
          + b2.sum(dim=-1)[:, None, None]) / C                # (E, B, N)
    Q = torch.einsum("egio,egjo->egij", Uw, Uw)
    quad = (torch.einsum("ebngi,egij->ebngj", zg, Q) * zg).sum(dim=(-1, -2))
    Ub2 = torch.einsum("egio,ego->egi", Uw, b2.reshape(E, g, o))
    cross = 2.0 * torch.einsum("ebngi,egi->ebn", zg, Ub2)
    sq = (quad + cross + (b2 * b2).sum(dim=-1)[:, None, None]) / C
    inv = torch.rsqrt(torch.clamp(sq - mu * mu, min=0.0) + eps)
    a = pe.t()[:, :, None] * inv                              # (E, B, N)
    Ug = Uw * gp[:, :, None, :]                               # ln_post scale folded
    zw = zg * a[..., None, None]
    out = torch.einsum("ebngi,egio->bngo", zw.to(dtype), Ug.to(dtype)).reshape(B, N, C)
    # the rank-3E epilogue: + a b2∘gp − (a mu) gp + pe bp
    coeffs = torch.cat([a, -a * mu, pe.t()[:, :, None].expand(E, B, N)], dim=0)
    vecs = torch.cat([(b2.reshape(E, g, o) * gp).reshape(E, C), gp.reshape(E, C), bp], dim=0)
    return (out + torch.einsum("ebn,ec->bnc", coeffs, vecs).to(dtype)).to(dtype)


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

    `fused_moe` (eval) and `fused_moe_train` (train) take the fused route
    (module docstring); both are off by default, as the JAX package's
    AVMOE_FUSED_MOE and AVMOE_FUSED_MOE_TRAIN are.
    """

    def __init__(self, dim: int, other_dim: int, num_tokens: int, other_num_tokens: int,
                 cfg: MoEConfig, fused_moe: bool = False, fused_moe_train: bool = False):
        super().__init__()
        self.dim, self.other_dim = dim, other_dim
        self.num_tokens, self.other_num_tokens = num_tokens, other_num_tokens
        self.cfg = cfg
        self.fused_moe, self.fused_moe_train = fused_moe, fused_moe_train
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

        fused = self.fused_moe_train if train else self.fused_moe
        outs = []
        if self.cfg.num_multimodal_experts > 0:
            outs.append(self.multimodal_experts(x, other_proj, train, split_tail=fused))
        if self.cfg.num_singlemodal_experts > 0:
            outs.append(self.singlemodal_experts(x, other_proj, train, generator,
                                                 split_tail=fused))
        if fused:
            t = {k: torch.cat([o[k] for o in outs], dim=0) for k in outs[0]}
            out = fused_gated_combine(t, probs, post_layernorm=self.cfg.adapter.post_layernorm,
                                      dtype=x.dtype)
        else:
            expert_out = torch.cat(outs, dim=0)                      # (E, B, N, C)
            out = torch.einsum("ebnc,be->bnc", expert_out, probs.to(expert_out.dtype))

        aux = {"gating_probs": probs, "expert_index": torch.argmax(probs, dim=-1)}
        if self.cfg.load_balance_loss:
            E = self.cfg.num_experts
            # a train step's mean gate is the global batch's
            mean_p = global_means(B, probs.sum(dim=0))[0] if train else probs.mean(dim=0)
            mean_p = torch.clamp(mean_p, 1e-9, 1.0)
            if self.cfg.lb_loss_compat:
                aux["lb_loss"] = -torch.log(mean_p).sum()
            else:
                u = 1.0 / E
                aux["lb_loss"] = (u * (math.log(u) - torch.log(mean_p))).sum() / E
        return out, aux
