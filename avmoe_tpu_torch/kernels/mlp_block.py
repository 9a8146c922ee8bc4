"""Swin MLP sub-block with its residual: x + [LN ->] fc1 -> GELU -> fc2 [-> LN].

Replaces the TPU kernel `_run_mlp_only` (experiments/pallas/fused_block.py
:315, inline `kernel` :340, reached from `fused_block_chain(part='mlp')`).
The CUDA kernels are `csrc/mlp_block.cu`; `mlp_block_plain` below is the
plain PyTorch version, taken only for tensors on the CPU.

Contract, per token row of x (..., C):
  pre_norm=True  (V1):  x + fc2(gelu(fc1(LN(x))))
  pre_norm=False (V2):  x + LN(fc2(gelu(fc1(x))))
  x, w1 (Hd, C), w2 (C, Hd)   one dtype, float32 or bfloat16, contiguous
                              (w1, w2 may also be float32 master weights of
                              a bf16 x, cast to x's dtype at the call)
  b1 (Hd,), b2 (C,), ln_w, ln_b (C,)   float32
GELU is the exact erf form. LayerNorm statistics are float32.
On the card, bfloat16 also needs C % 8 == 0 and x, w1, w2 on 16-byte
boundaries (a ValueError otherwise). Each bf16 product's output tile width
is `pick_tile`'s, from the card's SM count.

DropPath (train): an optional float32 per-frame `scale` s, one value per
entry of x's leading axis, gives out = x + s ⊙ branch.

Training. Where x or a weight needs a gradient, the call goes through an
autograd Function. Its forward keeps fc1's pre-activation h1 (fc1's
epilogue writes it beside gelu(h1)) and, on V2, fc2's output f; its
backward is K2b (`mlp_block_bwd` in the same CUDA source; plain version
`mlp_block_backward_plain`, which the Function runs on the CPU): dx from
those and the output's gradient, with no product of the forward run again.
K2b runs two products and one LayerNorm-backward row pass; in bf16 its
products run on the wgmma kernel (`csrc/gemm_wgmma.cuh`, TMA-fed and
persistent, output tiles 128 x `pick_wgmma_tile`'s width), since they, not
the bytes, bound K2b at most shapes. The backward products take the
transposed weights w1t = w1ᵀ (C, Hd) and w2t = w2ᵀ (Hd, C), which the
caller keeps for frozen weights (SwinBlock does, once per dtype).

Trainable weights (a trainable backbone). The forward also keeps fc1's
input a1 (LN(x) on V1, x on V2) and gelu(h1), which it computes anyway, and
K2b gives the six parameter gradients in float32: db1, db2, d ln_w and
d ln_b as column sums inside its own passes (per-tile partials summed in a
fixed order), dW1 = d_h1ᵀ a1 and dW2 = gᵀ gelu(h1) (V2: d_h2ᵀ gelu(h1)) as
two float32-output products over the rows, g = s ⊙ dy. Float32 master
weights go into the Function as they are: it casts them to x's dtype and
returns their gradients as float32 sums (a bf16 weight would round the sum
over the rows to bf16).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from avmoe_tpu_torch.kernels import _build
from avmoe_tpu_torch.ops.norm import layer_norm, layer_norm_backward, layer_norm_xhat, upcast

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _frame_scale(scale: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(frames,) scale -> broadcastable against x (frames, ..., C)."""
    return scale.reshape(-1, *([1] * (x.dim() - 1)))


def mlp_block_forward_plain(x, ln_w, ln_b, w1, b1, w2, b2, *, pre_norm: bool,
                           eps: float = 1e-5, scale=None, acts: bool = False):
    """Plain PyTorch version of the kernel's training forward (same
    contract), in x's dtype: (out, h1, f), with h1 (..., Hd) fc1's
    pre-activation and f (..., C) fc2's output, bias added, which K2b reads;
    with `acts` also (a1, gelu(h1)), a1 fc1's input (LN(x) on V1, x on V2),
    which the weight gradients read."""
    dt = x.dtype
    a1 = layer_norm(x, ln_w, ln_b, eps) if pre_norm else x
    h1 = torch.matmul(a1, w1.t()) + b1.to(dt)
    hid = F.gelu(h1, approximate="none")
    f = torch.matmul(hid, w2.t()) + b2.to(dt)
    h = f if pre_norm else layer_norm(f, ln_w, ln_b, eps)
    if scale is not None:
        h = h * _frame_scale(scale, x).to(dt)
    return (x + h, h1, f, a1, hid) if acts else (x + h, h1, f)


def mlp_block_plain(x, ln_w, ln_b, w1, b1, w2, b2, *, pre_norm: bool,
                    eps: float = 1e-5, scale=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same contract), in x's dtype."""
    return mlp_block_forward_plain(x, ln_w, ln_b, w1, b1, w2, b2, pre_norm=pre_norm, eps=eps,
                                   scale=scale)[0]


def gelu_grad(h: torch.Tensor) -> torch.Tensor:
    """d/dh of the exact-erf GELU."""
    cdf = 0.5 * (1.0 + torch.erf(h * 0.7071067811865476))
    return cdf + h * 0.3989422804014327 * torch.exp(-0.5 * h * h)


def mlp_block_backward_plain(dy, h1, src, ln_w, w1t, w2t, *, pre_norm: bool,
                             eps: float = 1e-5, scale=None, a1=None, hid=None):
    """Plain PyTorch version of K2b, by the kernel's formulas in float32
    (float64 for float64 dy): dx of mlp_block for the output gradient dy,
    from the forward's h1 and src (x on V1, f on V2), in dy's dtype. Given
    the forward's a1 and gelu(h1) (`mlp_block_forward_plain(..., acts=True)`),
    (dx, dW1, db1, dW2, db2, d ln_w, d ln_b), the parameter gradients in
    float32: with g = s ⊙ dy, d_f the gradient at fc2's output (g on V1,
    LN-backward(g; f) on V2) and d_n the one at the norm's output (d_h1 w1 on
    V1, g on V2), dW2 = d_fᵀ gelu(h1), db2 = Σ d_f, dW1 = d_h1ᵀ a1,
    db1 = Σ d_h1, d ln_w = Σ d_n ∘ n̂ (n̂ the normalized src), d ln_b = Σ d_n."""
    dyf = upcast(dy)
    f = lambda t: t.to(dyf.dtype)
    g = dyf if scale is None else dyf * f(_frame_scale(scale, dy))
    w1, w2, gelu_d = f(w1t).t(), f(w2t).t(), gelu_grad(f(h1))
    if pre_norm:
        d_f = g
        d_h1 = torch.matmul(g, w2) * gelu_d
        d_n = torch.matmul(d_h1, w1)
        dx = dyf + layer_norm_backward(d_n, src, ln_w, eps)
    else:
        d_n = g
        d_f = layer_norm_backward(g, src, ln_w, eps)
        d_h1 = torch.matmul(d_f, w2) * gelu_d
        dx = dyf + torch.matmul(d_h1, w1)
    if a1 is None:
        return dx.to(dy.dtype)
    rows = lambda t: t.reshape(-1, t.shape[-1])
    d_f, d_h1, d_n = rows(d_f), rows(d_h1), rows(d_n)
    return (dx.to(dy.dtype), d_h1.t() @ rows(f(a1)), d_h1.sum(0), d_f.t() @ rows(f(hid)),
            d_f.sum(0), (d_n * rows(layer_norm_xhat(src, eps))).sum(0), d_n.sum(0))


def _check(x, ln_w, ln_b, w1, b1, w2, b2) -> None:
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtype {x.dtype}; expected float32 or bfloat16")
    C = x.shape[-1]
    Hd = w1.shape[0]
    # the weights in x's dtype, or as float32 masters
    wdt = w1.dtype if w1.dtype == w2.dtype == torch.float32 else x.dtype
    want = {"w1": (w1, (Hd, C), wdt), "w2": (w2, (C, Hd), wdt),
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


# output tile widths of K2b's bf16 product kernel (csrc/gemm_wgmma.cuh),
# 128-row tiles walked by one persistent CTA an SM; what a tile costs on an
# H100 (tools/k2b_wgmma_variants.py, PERF.md), per column of its width: a
# 64-deep step of its products, and its epilogue, the d_h1 product's (its
# gelu'(h1)) or the dx product's; and per tile its barriers and hand-offs
WGMMA_WIDTHS = (256, 192, 128)
WGMMA_STEP_S = 3.3e-9
WGMMA_EPI_S = {True: 2e-8, False: 3e-9}
WGMMA_TILE_S = 5e-7


def wgmma_seconds(M: int, N: int, K: int, width: int, sms: int, gelu: bool = False) -> float:
    """Modelled time of an (M, N, K) product on the wgmma kernel at tile
    width `width`: the busiest SM's tiles, each of `width` columns (the
    columns past N computed all the same) through ceil(K / 64) steps and an
    epilogue (`gelu`: the d_h1 product's)."""
    per_tile = width * (math.ceil(K / 64) * WGMMA_STEP_S + WGMMA_EPI_S[gelu]) + WGMMA_TILE_S
    return busiest_sm_tiles(M, N, width, sms) * per_tile


def pick_wgmma_tile(M: int, N: int, K: int, sms: int, gelu: bool = False) -> int:
    """The wgmma kernel's output tile width for an (M, N, K) product on
    `sms` SMs (`gelu`: the d_h1 product): the least modelled time, the
    widest on a tie."""
    return min(WGMMA_WIDTHS, key=lambda w: (wgmma_seconds(M, N, K, w, sms, gelu), -w))


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("mlp_block")
    fn = lib.mlp_block_fwd
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.mlp_block_bwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 7 + [ctypes.c_float] + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    fn = lib.mlp_block_bwd_workspace
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    fn = lib.mlp_block_gemm_bf16
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.mlp_block_gemm_wgmma
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.mlp_block_ctas_per_sm.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.mlp_block_ctas_per_sm.restype = ctypes.c_int
    return lib


def _check_bf16_layout(C: int, **tensors) -> None:
    """What the bf16 kernels need beyond the contract: 16-byte rows."""
    if C % 8:
        raise ValueError(f"bfloat16 on the card needs C % 8 == 0, got C={C}")
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"bfloat16 on the card needs {name} on a 16-byte boundary")


# the product kernels' epilogues (csrc/mlp_block.cu kEpi*): the forward's
# + bias, GELU, + bias + resid and its DropPath form, fc1's GELU keeping its
# input (mma.sync, `product_bf16`); K2b's x gelu'(h1), + resid without a
# bias, none (wgmma, `product_wgmma`)
EPI_BIAS, EPI_GELU, EPI_RESID, EPI_RESID_SCALE = 0, 1, 2, 3
EPI_GELU_SAVE, EPI_GELU_GRAD, EPI_ADD, EPI_PLAIN = 4, 5, 6, 7


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def product_bf16(a, w, bias, *, epi: int, tile: int, resid=None, out2=None,
                 scale=None) -> torch.Tensor:
    """One bf16 product of the forward alone on the card, epi(a w^T + bias)
    with one of EPI_BIAS to EPI_GELU_SAVE, at output tile width `tile`: the
    mma.sync kernel `mlp_block` launches, to time the products apart from the
    row passes. `resid` is the residual, `out2` EPI_GELU_SAVE's second output,
    `scale` the per-frame scale (rows of a frame: M / len(scale)). Not on any
    path and not counted."""
    M, K = a.shape
    out = torch.empty((M, w.shape[0]), dtype=a.dtype, device=a.device)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    err = _library().mlp_block_gemm_bf16(
        a.data_ptr(), w.data_ptr(), ptr(bias), ptr(resid), out.data_ptr(), ptr(out2),
        ptr(scale), 1 if scale is None else M // scale.shape[0], M, w.shape[0], K, epi, tile,
        _stream(a))
    if err != 0:
        raise RuntimeError(f"mlp_block product failed: CUDA error {err}")
    return out


def product_wgmma(a, bt, *, epi: int, tile: int, aux=None, scale=None) -> torch.Tensor:
    """One bf16 product of K2b alone on the card, epi(a btᵀ, aux) on the
    wgmma kernel at output tile width `tile` (one of WGMMA_WIDTHS):
    EPI_GELU_GRAD (aux = h1; `scale` optional, rows of a frame M /
    len(scale)), EPI_ADD (aux the residual) or EPI_PLAIN (no aux). The
    kernel `mlp_block_bwd` launches, to time and test the products apart
    from the row pass. Not on any path and not counted."""
    M, K = a.shape
    out = torch.empty((M, bt.shape[0]), dtype=a.dtype, device=a.device)
    err = _library().mlp_block_gemm_wgmma(
        a.data_ptr(), bt.data_ptr(), 0 if aux is None else aux.data_ptr(), out.data_ptr(),
        0 if scale is None else scale.data_ptr(), 1 if scale is None else M // scale.shape[0],
        M, bt.shape[0], K, epi, tile, _stream(a))
    if err != 0:
        raise RuntimeError(f"mlp_block wgmma product failed: CUDA error {err}")
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
    """Callable wrapper of K2b: dx of the block for the gradient dy, from the
    forward's h1 and src (x on V1, f on V2); given the forward's a1 and hid =
    gelu(h1) (trainable weights), (dx, dW1, db1, dW2, db2, d ln_w, d ln_b),
    the six float32 (`mlp_block_backward_plain`'s contract). `launches`
    counts calls that launched it (two products and one row pass, and with
    the weight gradients their column sums and two products)."""

    def __init__(self):
        self.launches = 0

    def __call__(self, dy, h1, src, ln_w, w1t, w2t, *, pre_norm: bool, eps: float = 1e-5,
                 scale=None, a1=None, hid=None):
        if dy.dtype not in _DTYPE_CODE:
            raise ValueError(f"unsupported dtype {dy.dtype}; expected float32 or bfloat16")
        C, Hd = dy.shape[-1], w1t.shape[-1]
        for name, t, shape, dtype in (
                ("src", src, tuple(dy.shape), dy.dtype),
                ("h1", h1, (*dy.shape[:-1], Hd), dy.dtype),
                ("w1t", w1t, (C, Hd), dy.dtype), ("w2t", w2t, (Hd, C), dy.dtype),
                ("ln_w", ln_w, (C,), torch.float32)):
            if tuple(t.shape) != shape or t.dtype != dtype or t.device != dy.device:
                raise ValueError(f"{name} must be {dtype} {shape} on {dy.device}, got "
                                 f"{t.dtype} {tuple(t.shape)} on {t.device}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if not dy.is_contiguous():
            raise ValueError("dy must be contiguous")
        _check_scale(scale, dy)
        params = (a1 is not None) or (hid is not None)
        if params:
            for name, t, shape in (("a1", a1, tuple(dy.shape)), ("hid", hid, tuple(h1.shape))):
                if (t is None or tuple(t.shape) != shape or t.dtype != dy.dtype
                        or t.device != dy.device or not t.is_contiguous()):
                    raise ValueError(f"{name} must be contiguous {dy.dtype} {shape} on "
                                     f"{dy.device} beside the other one")
        if dy.device.type == "cpu":
            return mlp_block_backward_plain(dy, h1, src, ln_w, w1t, w2t, pre_norm=pre_norm,
                                            eps=eps, scale=scale, a1=a1, hid=hid)
        if dy.device.type != "cuda":
            raise ValueError(f"mlp_block_bwd: unsupported device {dy.device}")
        if dy.dtype == torch.bfloat16:
            _check_bf16_layout(C, dy=dy, h1=h1, src=src, w1t=w1t, w2t=w2t)
        R = dy.numel() // C
        lib = _library()
        hA = torch.empty((R, Hd), dtype=dy.dtype, device=dy.device)
        cA = torch.empty((R, C), dtype=dy.dtype, device=dy.device)
        dx = torch.empty_like(dy)
        sums = db1 = gs = ws = None
        if params:
            f32 = dict(dtype=torch.float32, device=dy.device)
            sums, db1 = torch.empty((3, C), **f32), torch.empty((Hd,), **f32)
            ws = torch.empty(lib.mlp_block_bwd_workspace(R, C, Hd, _DTYPE_CODE[dy.dtype]), **f32)
            if pre_norm and scale is not None:
                gs = torch.empty((R, C), dtype=dy.dtype, device=dy.device)
        sms = sm_count(_device_index(dy))
        sp, rpf = _scale_args(scale, dy)
        ptr = lambda t: 0 if t is None else t.data_ptr()
        err = lib.mlp_block_bwd(
            dy.data_ptr(), h1.data_ptr(), src.data_ptr(), ln_w.data_ptr(), w1t.data_ptr(),
            w2t.data_ptr(), sp, rpf, hA.data_ptr(), cA.data_ptr(), dx.data_ptr(), R, C, Hd,
            int(pre_norm), _DTYPE_CODE[dy.dtype], pick_wgmma_tile(R, Hd, C, sms, gelu=True),
            pick_wgmma_tile(R, C, Hd, sms), eps, ptr(sums), ptr(db1), ptr(gs), ptr(ws),
            _stream(dy))
        if err != 0:
            raise RuntimeError(f"mlp_block_bwd kernel failed: CUDA error {err}")
        self.launches += 1
        if not params:
            return dx
        # the two weight products over the R rows, float32 out: dW2 = d_fᵀ
        # gelu(h1) with d_f = g (V1; dy without a scale) or d_h2 (V2, in cA),
        # dW1 = d_h1ᵀ a1 (d_h1 in hA)
        d_f = cA if not pre_norm else (dy.reshape(R, C) if gs is None else gs)
        dw2 = _mm_f32(d_f.t(), hid.reshape(R, Hd))
        dw1 = _mm_f32(hA.t(), a1.reshape(R, C))
        return dx, dw1, db1, dw2, sums[2], sums[0], sums[1]


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a b with a float32 result: a bf16 product with float32 output, or a
    float32 product."""
    if a.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a, b)


mlp_block_bwd = MlpBlockBackward()


class _MlpBlockFn(torch.autograd.Function):
    """K2 forward keeping h1 (and f on V2), K2b backward (the plain versions
    on the CPU). Where a parameter needs a gradient the forward also keeps
    a1 and gelu(h1), and the backward gives all six parameter gradients;
    w1 and w2 may be float32 masters of a bf16 x (cast here; their
    gradients float32)."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w1, b1, w2, b2, scale, w1t, w2t, pre_norm, eps):
        params = any(ctx.needs_input_grad[1:7])
        W1, W2 = w1.to(x.dtype), w2.to(x.dtype)
        if params or w1t is None:
            w1t, w2t = W1.t().contiguous(), W2.t().contiguous()
        res = mlp_block.forward_only(x, ln_w, ln_b, W1, b1, W2, b2, pre_norm=pre_norm, eps=eps,
                                     scale=scale, keep=True, acts=params)
        out, h1, f = res[:3]
        ctx.save_for_backward(h1, x if pre_norm else f, ln_w, scale, w1t, w2t,
                              *(res[3:] if params else ()))
        ctx.pre_norm, ctx.eps, ctx.params = pre_norm, eps, params
        return out

    @staticmethod
    def backward(ctx, dy):
        h1, src, ln_w, scale, w1t, w2t, *acts = ctx.saved_tensors
        dy = dy.contiguous()
        if dy.data_ptr() % 16:     # a view off the bf16 kernel's 16-byte boundary
            dy = dy.clone()
        res = mlp_block_bwd(dy, h1, src, ln_w, w1t, w2t, pre_norm=ctx.pre_norm, eps=ctx.eps,
                            scale=scale, **(dict(a1=acts[0], hid=acts[1]) if ctx.params else {}))
        if not ctx.params:
            return (res,) + (None,) * 11
        dx, dw1, db1, dw2, db2, dln_w, dln_b = res
        return dx, dln_w, dln_b, dw1, db1, dw2, db2, None, None, None, None, None


class MlpBlock:
    """Callable wrapper of the kernels; `launches` counts calls that launched
    them (one call is one MLP sub-block: two products and one row pass).
    Where x or a parameter needs a gradient the call is differentiable
    through K2b; w1t and w2t (the transposed frozen weights) are then taken
    as given or made here."""

    def __init__(self):
        self.launches = 0

    def __call__(self, x, ln_w, ln_b, w1, b1, w2, b2, *, pre_norm: bool,
                 eps: float = 1e-5, scale=None, w1t=None, w2t=None) -> torch.Tensor:
        _check(x, ln_w, ln_b, w1, b1, w2, b2)
        _check_scale(scale, x)
        if not (torch.is_grad_enabled()
                and any(t.requires_grad for t in (x, ln_w, ln_b, w1, b1, w2, b2))):
            return self.forward_only(x, ln_w, ln_b, w1.to(x.dtype), b1, w2.to(x.dtype), b2,
                                     pre_norm=pre_norm, eps=eps, scale=scale)
        return _MlpBlockFn.apply(x, ln_w, ln_b, w1, b1, w2, b2, scale, w1t, w2t, pre_norm, eps)

    def forward_only(self, x, ln_w, ln_b, w1, b1, w2, b2, *, pre_norm: bool,
                     eps: float = 1e-5, scale=None, keep: bool = False, acts: bool = False):
        """The kernels (plain version on the CPU), no autograd. With `keep`
        (training) it returns (out, h1, f): fc1's pre-activation h1 (..., Hd)
        and fc2's output f (..., C), which K2b reads (f is None on the card
        for V1, whose fc2 adds the residual in its epilogue); with `acts` too
        (out, h1, f, a1, hid): fc1's input a1 (LN(x) on V1, x on V2) and
        gelu(h1) (..., Hd), which the weight gradients read."""
        if x.device.type == "cpu":
            res = mlp_block_forward_plain(x, ln_w, ln_b, w1, b1, w2, b2, pre_norm=pre_norm,
                                          eps=eps, scale=scale, acts=keep and acts)
            return res if keep else res[0]
        if x.device.type != "cuda":
            raise ValueError(f"mlp_block: unsupported device {x.device}")
        if x.dtype == torch.bfloat16:
            _check_bf16_layout(x.shape[-1], x=x, w1=w1, w2=w2)
        lib = _library()
        C = x.shape[-1]
        R = x.numel() // C
        Hd = w1.shape[0]
        sms = sm_count(_device_index(x))
        h_ln = torch.empty_like(x) if pre_norm else None
        hid = torch.empty((*x.shape[:-1], Hd), dtype=x.dtype, device=x.device)
        f = None if pre_norm else torch.empty_like(x)
        h1 = torch.empty((*x.shape[:-1], Hd), dtype=x.dtype, device=x.device) if keep else None
        out = torch.empty_like(x)
        sp, rpf = _scale_args(scale, x)
        ptr = lambda t: 0 if t is None else t.data_ptr()
        err = lib.mlp_block_fwd(
            x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), ptr(h_ln), hid.data_ptr(), ptr(f), out.data_ptr(),
            ptr(h1), R, C, Hd, int(pre_norm), _DTYPE_CODE[x.dtype], pick_tile(R, Hd, C, sms),
            pick_tile(R, C, Hd, sms), eps, sp, rpf, _stream(x))
        if err != 0:
            raise RuntimeError(f"mlp_block kernel failed: CUDA error {err}")
        self.launches += 1
        if keep and acts:
            return out, h1, f, x if h_ln is None else h_ln, hid
        return (out, h1, f) if keep else out


mlp_block = MlpBlock()
