"""Swin MLP sub-block with its residual: x + [LN ->] fc1 -> GELU -> fc2 [-> LN].

Replaces the TPU kernel `_run_mlp_only` (experiments/pallas/fused_block.py
:315, inline `kernel` :340, reached from `fused_block_chain(part='mlp')`).
The CUDA kernels are `csrc/mlp_block.cu`; `mlp_block_plain` below is the
plain PyTorch version, taken only for tensors on the CPU.

Contract, per token row of x (..., C):
  pre_norm=True  (V1):  x + fc2(gelu(fc1(LN(x))))
  pre_norm=False (V2):  x + LN(fc2(gelu(fc1(x))))
  x, w1 (Hd, C), w2 (C, Hd)   one dtype, float32 or bfloat16, contiguous
  b1 (Hd,), b2 (C,), ln_w, ln_b (C,)   float32
GELU is the exact erf form. LayerNorm statistics are float32.
On the card, bfloat16 also needs C % 8 == 0 and x, w1, w2 on 16-byte
boundaries (a ValueError otherwise). Each bf16 product's output tile width
is `pick_tile`'s, from the card's SM count.

DropPath (train): an optional float32 per-frame `scale` s, one value per
entry of x's leading axis, gives out = x + s ⊙ branch.

Training. Where x needs a gradient, the call goes through an autograd
Function whose backward is K2b (`mlp_block_bwd` in the same CUDA source;
plain version `mlp_block_backward_plain`): dx only, from x and the output's
gradient, the branch recomputed. The weights are frozen: on the card a
weight that needs a gradient raises; on the CPU that case takes plain
autograd. The backward products take the transposed weights w1t = w1ᵀ
(C, Hd) and w2t = w2ᵀ (Hd, C), which the caller keeps (SwinBlock does, once
per dtype).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from avmoe_tpu_torch.kernels import _build
from avmoe_tpu_torch.ops.norm import layer_norm, layer_norm_backward, upcast

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _frame_scale(scale: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(frames,) scale -> broadcastable against x (frames, ..., C)."""
    return scale.reshape(-1, *([1] * (x.dim() - 1)))


def mlp_block_plain(x, ln_w, ln_b, w1, b1, w2, b2, *, pre_norm: bool,
                    eps: float = 1e-5, scale=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same contract), in x's dtype."""
    dt = x.dtype
    h = layer_norm(x, ln_w, ln_b, eps) if pre_norm else x
    h = torch.matmul(h, w1.t()) + b1.to(dt)
    h = F.gelu(h, approximate="none")
    h = torch.matmul(h, w2.t()) + b2.to(dt)
    if not pre_norm:
        h = layer_norm(h, ln_w, ln_b, eps)
    if scale is not None:
        h = h * _frame_scale(scale, x).to(dt)
    return x + h


def gelu_grad(h: torch.Tensor) -> torch.Tensor:
    """d/dh of the exact-erf GELU."""
    cdf = 0.5 * (1.0 + torch.erf(h * 0.7071067811865476))
    return cdf + h * 0.3989422804014327 * torch.exp(-0.5 * h * h)


def mlp_block_backward_plain(x, dy, ln_w, ln_b, w1, b1, w2, b2, *, pre_norm: bool,
                             eps: float = 1e-5, scale=None) -> torch.Tensor:
    """Plain PyTorch version of K2b, by the kernel's formulas in float32
    (float64 for float64 x): dx of mlp_block for the output gradient dy,
    weights frozen, in x's dtype."""
    xf = upcast(x)
    f = lambda t: t.to(xf.dtype)
    w1f, w2f, dyf = f(w1), f(w2), f(dy)
    g = dyf if scale is None else dyf * f(_frame_scale(scale, x))
    if pre_norm:
        h1 = torch.matmul(layer_norm(xf, ln_w, ln_b, eps), w1f.t()) + f(b1)
        d_h1 = torch.matmul(g, w2f) * gelu_grad(h1)
        dx = dyf + layer_norm_backward(torch.matmul(d_h1, w1f), xf, ln_w, eps)
    else:
        h1 = torch.matmul(xf, w1f.t()) + f(b1)
        h2 = torch.matmul(F.gelu(h1, approximate="none"), w2f.t()) + f(b2)
        d_h1 = torch.matmul(layer_norm_backward(g, h2, ln_w, eps), w2f) * gelu_grad(h1)
        dx = dyf + torch.matmul(d_h1, w1f)
    return dx.to(x.dtype)


def _check(x, ln_w, ln_b, w1, b1, w2, b2) -> None:
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtype {x.dtype}; expected float32 or bfloat16")
    C = x.shape[-1]
    Hd = w1.shape[0]
    want = {"w1": (w1, (Hd, C), x.dtype), "w2": (w2, (C, Hd), x.dtype),
            "b1": (b1, (Hd,), torch.float32), "b2": (b2, (C,), torch.float32),
            "ln_w": (ln_w, (C,), torch.float32), "ln_b": (ln_b, (C,), torch.float32)}
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def _check_scale(scale, x) -> None:
    if scale is None:
        return
    if scale.dtype != torch.float32 or scale.dim() != 1 or scale.shape[0] != x.shape[0]:
        raise ValueError(f"scale must be float32 ({x.shape[0]},) (one value per frame), got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if scale.device != x.device or not scale.is_contiguous():
        raise ValueError("scale must be contiguous and on x's device")


# output tile widths of the bf16 product kernel; every tile is 128 rows
TILE_WIDTHS = (128, 96)
TILE_ROWS = 128
# what the product kernel reaches on an H100 SXM (PERF.md, run 3 of PR 5):
# one SM's main loop with no copies waiting, about 330 TFLOP/s over 132 SMs,
# and the L2 rate its cp.async copies sustain, 3.5 TB/s (222 TFLOP/s at the
# 64 operations a byte of a 128 x 128 tile)
SM_FLOPS = 2.5e12
L2_BYTES_PER_S = 3.5e12


def busiest_sm_tiles(M: int, N: int, width: int, sms: int) -> int:
    """Tiles of 128 x `width` that the busiest of `sms` SMs runs for an
    (M, N) output. The card runs rounds of sms x (CTAs per SM) tiles, and
    starts a tile as one ends; the last round spreads over the SMs, so
    whatever the CTAs per SM, the busiest SM runs ceil(tiles / sms)."""
    tiles = math.ceil(M / TILE_ROWS) * math.ceil(N / width)
    return math.ceil(tiles / sms)


def product_seconds(M: int, N: int, K: int, width: int, sms: int) -> float:
    """Modelled time of an (M, N, K) bf16 product at tile width `width`: the
    larger of the busiest SM's tiles at SM_FLOPS and every tile's A and B
    operand bytes through L2 at L2_BYTES_PER_S (a tile that overhangs N
    counts whole). Narrow tiles cut the wasted columns and even out the
    SMs' loads; wide ones read fewer operand bytes per output."""
    tiles = math.ceil(M / TILE_ROWS) * math.ceil(N / width)
    sm = busiest_sm_tiles(M, N, width, sms) * 2 * TILE_ROWS * width * K / SM_FLOPS
    return max(sm, tiles * (TILE_ROWS + width) * K * 2 / L2_BYTES_PER_S)


def pick_tile(M: int, N: int, K: int, sms: int) -> int:
    """The output tile width for an (M, N, K) bf16 product on `sms` SMs:
    the least modelled time, the widest on a tie."""
    return min(TILE_WIDTHS, key=lambda w: (product_seconds(M, N, K, w, sms), -w))


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("mlp_block")
    fn = lib.mlp_block_fwd
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.mlp_block_bwd
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.mlp_block_gemm_bf16
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.mlp_block_ctas_per_sm.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.mlp_block_ctas_per_sm.restype = ctypes.c_int
    return lib


def _check_bf16_layout(x, w1, w2, **more) -> None:
    """What the bf16 kernel needs beyond the contract: 16-byte rows."""
    if x.shape[-1] % 8:
        raise ValueError(f"bfloat16 on the card needs C % 8 == 0, got C={x.shape[-1]}")
    for name, t in (("x", x), ("w1", w1), ("w2", w2), *more.items()):
        if t.data_ptr() % 16:
            raise ValueError(f"bfloat16 on the card needs {name} on a 16-byte boundary")


# the product kernel's epilogues (csrc/mlp_block.cu kEpi*): the forward's
# + bias, GELU, + bias + resid and its DropPath form; K2b's kept h1 beside
# GELU, x gelu'(h1), + resid without a bias, none
EPI_BIAS, EPI_GELU, EPI_RESID, EPI_RESID_SCALE = 0, 1, 2, 3
EPI_GELU_SAVE, EPI_GELU_GRAD, EPI_ADD, EPI_PLAIN = 4, 5, 6, 7


def product_bf16(a, w, bias, *, epi: int, tile: int, resid=None, out2=None,
                 scale=None) -> torch.Tensor:
    """One bf16 product of the block alone on the card, epi(a w^T [+ bias])
    with one of the EPI_* epilogues, at output tile width `tile`: the kernel
    `mlp_block` and `mlp_block_bwd` launch, to time the products apart from
    the row passes. `resid` is the residual (or h1 for EPI_GELU_GRAD), `out2`
    EPI_GELU_SAVE's second output, `scale` the per-frame scale (rows of a
    frame: M / len(scale)). Not on any path and not counted."""
    M, K = a.shape
    out = torch.empty((M, w.shape[0]), dtype=a.dtype, device=a.device)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    err = _library().mlp_block_gemm_bf16(
        a.data_ptr(), w.data_ptr(), ptr(bias), ptr(resid), out.data_ptr(), ptr(out2),
        ptr(scale), 1 if scale is None else M // scale.shape[0], M, w.shape[0], K, epi, tile,
        torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mlp_block product failed: CUDA error {err}")
    return out


def ctas_per_sm(tile: int) -> int:
    """CTAs of the bf16 product kernel at width `tile` one SM holds at once."""
    n = ctypes.c_int(0)
    err = _library().mlp_block_ctas_per_sm(tile, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"mlp_block occupancy query failed: CUDA error {err}")
    return n.value


def _device_index(x: torch.Tensor) -> int:
    return x.device.index if x.device.index is not None else torch.cuda.current_device()


def _scale_args(scale, x):
    """(pointer, rows per frame) of the optional per-frame scale."""
    if scale is None:
        return 0, 1
    return scale.data_ptr(), x.numel() // x.shape[-1] // x.shape[0]


class MlpBlockBackward:
    """Callable wrapper of K2b: dx of the block for the gradient dy, weights
    frozen; `launches` counts calls that launched it (three or four products
    and one or two row passes)."""

    def __init__(self):
        self.launches = 0

    def __call__(self, x, dy, ln_w, ln_b, w1, b1, w2, b2, w1t, w2t, *, pre_norm: bool,
                 eps: float = 1e-5, scale=None) -> torch.Tensor:
        _check(x, ln_w, ln_b, w1, b1, w2, b2)
        _check_scale(scale, x)
        C, Hd = x.shape[-1], w1.shape[0]
        for name, t, shape in (("dy", dy, tuple(x.shape)), ("w1t", w1t, (C, Hd)),
                               ("w2t", w2t, (Hd, C))):
            if tuple(t.shape) != shape or t.dtype != x.dtype or t.device != x.device:
                raise ValueError(f"{name} must be {x.dtype} {shape} on {x.device}, got "
                                 f"{t.dtype} {tuple(t.shape)} on {t.device}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if x.device.type == "cpu":
            return mlp_block_backward_plain(x, dy, ln_w, ln_b, w1, b1, w2, b2,
                                            pre_norm=pre_norm, eps=eps, scale=scale)
        if x.device.type != "cuda":
            raise ValueError(f"mlp_block_bwd: unsupported device {x.device}")
        R = x.numel() // C
        hA = torch.empty((R, Hd), dtype=x.dtype, device=x.device)
        hB = torch.empty_like(hA)
        cA = torch.empty((R, C), dtype=x.dtype, device=x.device)
        cB = torch.empty_like(cA)
        dx = torch.empty_like(x)
        if x.dtype == torch.bfloat16:
            _check_bf16_layout(x, w1, w2, dy=dy, w1t=w1t, w2t=w2t)
        sms = sm_count(_device_index(x))
        sp, rpf = _scale_args(scale, x)
        err = _library().mlp_block_bwd(
            x.data_ptr(), dy.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), w1t.data_ptr(), w2t.data_ptr(), sp, rpf,
            hA.data_ptr(), hB.data_ptr(), cA.data_ptr(), cB.data_ptr(), dx.data_ptr(),
            R, C, Hd, int(pre_norm), _DTYPE_CODE[x.dtype], pick_tile(R, Hd, C, sms),
            pick_tile(R, C, Hd, sms), eps, torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"mlp_block_bwd kernel failed: CUDA error {err}")
        self.launches += 1
        return dx


mlp_block_bwd = MlpBlockBackward()


class _MlpBlockFn(torch.autograd.Function):
    """K2 forward, K2b backward (dx only; the weights are frozen)."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w1, b1, w2, b2, scale, w1t, w2t, pre_norm, eps):
        out = mlp_block.forward_only(x, ln_w, ln_b, w1, b1, w2, b2, pre_norm=pre_norm,
                                     eps=eps, scale=scale)
        ctx.save_for_backward(x, ln_w, ln_b, w1, b1, w2, b2, scale, w1t, w2t)
        ctx.pre_norm, ctx.eps = pre_norm, eps
        return out

    @staticmethod
    def backward(ctx, dy):
        x, ln_w, ln_b, w1, b1, w2, b2, scale, w1t, w2t = ctx.saved_tensors
        dy = dy.contiguous()
        if dy.data_ptr() % 16:     # a view off the bf16 kernel's 16-byte boundary
            dy = dy.clone()
        dx = mlp_block_bwd(x, dy, ln_w, ln_b, w1, b1, w2, b2, w1t, w2t,
                           pre_norm=ctx.pre_norm, eps=ctx.eps, scale=scale)
        return (dx,) + (None,) * 11


class MlpBlock:
    """Callable wrapper of the kernels; `launches` counts calls that launched
    them (one call is one MLP sub-block: two products and one row pass).
    Where x needs a gradient the call is differentiable through K2b; w1t and
    w2t (the transposed weights) are then taken as given or made here."""

    def __init__(self):
        self.launches = 0

    def __call__(self, x, ln_w, ln_b, w1, b1, w2, b2, *, pre_norm: bool,
                 eps: float = 1e-5, scale=None, w1t=None, w2t=None) -> torch.Tensor:
        _check(x, ln_w, ln_b, w1, b1, w2, b2)
        _check_scale(scale, x)
        if not (torch.is_grad_enabled() and x.requires_grad):
            return self.forward_only(x, ln_w, ln_b, w1, b1, w2, b2, pre_norm=pre_norm, eps=eps,
                                     scale=scale)
        if any(t.requires_grad for t in (ln_w, ln_b, w1, b1, w2, b2)):
            if x.device.type == "cpu":
                return mlp_block_plain(x, ln_w, ln_b, w1, b1, w2, b2, pre_norm=pre_norm,
                                       eps=eps, scale=scale)
            raise ValueError("mlp_block: the backward kernel gives dx only; the weights and "
                             "norm must be frozen (requires_grad=False)")
        w1t = w1.t().contiguous() if w1t is None else w1t
        w2t = w2.t().contiguous() if w2t is None else w2t
        return _MlpBlockFn.apply(x, ln_w, ln_b, w1, b1, w2, b2, scale, w1t, w2t, pre_norm, eps)

    def forward_only(self, x, ln_w, ln_b, w1, b1, w2, b2, *, pre_norm: bool,
                     eps: float = 1e-5, scale=None) -> torch.Tensor:
        """The kernels (plain version on the CPU), no autograd."""
        if x.device.type == "cpu":
            return mlp_block_plain(x, ln_w, ln_b, w1, b1, w2, b2, pre_norm=pre_norm, eps=eps,
                                   scale=scale)
        if x.device.type != "cuda":
            raise ValueError(f"mlp_block: unsupported device {x.device}")
        if x.dtype == torch.bfloat16:
            _check_bf16_layout(x, w1, w2)
        lib = _library()
        C = x.shape[-1]
        R = x.numel() // C
        Hd = w1.shape[0]
        sms = sm_count(_device_index(x))
        h_ln = torch.empty_like(x) if pre_norm else None
        hid = torch.empty((R, Hd), dtype=x.dtype, device=x.device)
        f = None if pre_norm else torch.empty_like(x)
        out = torch.empty_like(x)
        sp, rpf = _scale_args(scale, x)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mlp_block_fwd(
            x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), 0 if h_ln is None else h_ln.data_ptr(),
            hid.data_ptr(), 0 if f is None else f.data_ptr(), out.data_ptr(),
            R, C, Hd, int(pre_norm), _DTYPE_CODE[x.dtype], pick_tile(R, Hd, C, sms),
            pick_tile(R, C, Hd, sms), eps, sp, rpf, stream)
        if err != 0:
            raise RuntimeError(f"mlp_block kernel failed: CUDA error {err}")
        self.launches += 1
        return out


mlp_block = MlpBlock()
