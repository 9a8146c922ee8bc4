"""LayerNorm and BatchNorm with the JAX package's numerics.

Counterpart of `avmoe_tpu/ops/norm.py`: statistics are float32
(fast-variance form, mean of squares minus squared mean), and the
normalization is applied in the compute dtype. In float32 this is the
textbook LayerNorm / BatchNorm up to rounding.

Both modules take an optional `stack` shape: expert parameters are stored
with a leading expert axis (E, C), and the input carries the same leading
axis, e.g. (E, B, N, C).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from avmoe_tpu_torch.parallel.mesh import data_parallel, global_sum


def upcast(x: torch.Tensor) -> torch.Tensor:
    """x in the statistics' type: float32, or float64 for float64 x."""
    return x if x.dtype == torch.float64 else x.float()


def _moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 (float64 for float64 x) mean / variance over the last axis (keepdim)."""
    xf = upcast(x)
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    return mean, var


def _expand(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(*stack, C) parameter -> broadcastable against (*stack, ..., C)."""
    if p.dim() == 1:
        return p
    lead = p.shape[:-1]
    return p.reshape(*lead, *([1] * (x.dim() - p.dim())), p.shape[-1])


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis; float32 stats, applied in x.dtype."""
    dt = x.dtype
    mean, var = _moments(x)
    y = (x - mean.to(dt)) * torch.rsqrt(var + eps).to(dt)
    return y * _expand(weight, x).to(dt) + _expand(bias, x).to(dt)


def layer_norm_xhat(src: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The normalized src, (src − mean) / sqrt(var + eps), in float32
    (float64 for float64 src): what the norm's scale multiplies."""
    src = upcast(src)
    mean, var = _moments(src)
    return (src - mean) * torch.rsqrt(var + eps)


def layer_norm_backward(g: torch.Tensor, src: torch.Tensor, ln_w: torch.Tensor,
                        eps: float = 1e-5) -> torch.Tensor:
    """Gradient wrt src of layer_norm(src, ln_w, ·) for the output gradient
    g, in float32 (float64 for float64 src): inv (dxh − mean(dxh) −
    xh mean(dxh xh)), dxh = g ln_w."""
    src = upcast(src)
    inv = torch.rsqrt(_moments(src)[1] + eps)
    xh = layer_norm_xhat(src, eps)
    dxh = g.to(src.dtype) * ln_w.to(src.dtype)
    return inv * (dxh - dxh.mean(dim=-1, keepdim=True)
                  - xh * (dxh * xh).mean(dim=-1, keepdim=True))


class LayerNorm(nn.Module):
    """flax-tree names: scale -> weight, bias -> bias."""

    def __init__(self, dim: int, eps: float = 1e-5, stack: Tuple[int, ...] = ()):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(*stack, dim))
        self.bias = nn.Parameter(torch.zeros(*stack, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


BN_MOMENTUM = 0.9    # flax's BatchNorm momentum, at every site of the model


class BatchNorm(nn.Module):
    """BatchNorm over the last axis with running statistics.

    flax-tree names: params scale/bias -> weight/bias, batch_stats
    mean/var -> buffers running_mean/running_var. Eval folds the running
    stats into one float32 (w, b) pair, applied as x * w + b in x.dtype.
    Train (`forward(x, train=True)`) folds the batch statistics instead, taken
    in float32 over every axis but the stack axes and the last (mean of
    squares minus squared mean, the biased variance), and updates the running
    stats in place as flax does with momentum 0.9: r = 0.9 r + 0.1 batch.
    (torch.nn.BatchNorm would update with momentum 0.1 on the unbiased
    variance.) Gradients flow through the batch statistics. Under a process
    group (`parallel/mesh.py`) the batch statistics are the global batch's:
    the ranks' sums of x and x² and their row counts, all-reduced.
    """

    def __init__(self, dim: int, eps: float = 1e-5, stack: Tuple[int, ...] = ()):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(*stack, dim))
        self.bias = nn.Parameter(torch.zeros(*stack, dim))
        self.register_buffer("running_mean", torch.zeros(*stack, dim))
        self.register_buffer("running_var", torch.ones(*stack, dim))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            lead = self.weight.dim() - 1
            axes = tuple(range(lead, x.dim() - 1))
            xf = upcast(x)
            rows = xf.numel() // self.weight.numel()
            mean, sq = global_means(rows, xf.sum(dim=axes), (xf * xf).sum(dim=axes))
            var = torch.clamp(sq - mean * mean, min=0.0)
            self.update_running(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        w = torch.rsqrt(var + self.eps) * self.weight
        b = self.bias - mean * w
        return x * _expand(w, x).to(x.dtype) + _expand(b, x).to(x.dtype)

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """r = 0.9 r + 0.1 batch, flax's momentum, from the batch's mean and
        biased variance."""
        m = BN_MOMENTUM
        self.running_mean.mul_(m).add_((1.0 - m) * mean.detach())
        self.running_var.mul_(m).add_((1.0 - m) * var.detach())

    def folded(self, stats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The float32 per-channel (w, b) with BN(x) = x * w + b, without
        applying it: the counterpart of the JAX BatchNorm's `affine_only`
        (the fused combine folds it into the up kernel). Without `stats` it
        folds the running statistics (eval); with `stats` = (mean, var), the
        batch statistics computed by the caller (train, `stats_override`),
        it folds those and updates the running averages with them as a
        train forward does."""
        if stats is None:
            mean, var = self.running_mean, self.running_var
        else:
            mean, var = stats
            self.update_running(mean, var)
        w = torch.rsqrt(var + self.eps) * self.weight
        return w, self.bias - mean * w


def global_means(rows: int, *sums: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Each of this rank's sums over its `rows` rows divided by the global
    batch's rows: the global batch's means, through one differentiable
    all-reduce of the sums and the row count, so that uneven local batches
    are weighted by their rows. In one process, each sum / rows."""
    if not data_parallel():
        return tuple(s / rows for s in sums)
    flat = [s.reshape(-1) for s in sums]
    tot = global_sum(torch.cat(flat + [sums[0].new_full((1,), float(rows))]))
    n, out, off = tot[-1], [], 0
    for s, f in zip(sums, flat):
        out.append(tot[off:off + f.numel()].reshape(s.shape) / n)
        off += f.numel()
    return tuple(out)
