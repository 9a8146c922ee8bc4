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
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from avmoe_tpu_torch.kernels import _build
from avmoe_tpu_torch.ops.norm import layer_norm

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def mlp_block_plain(x, ln_w, ln_b, w1, b1, w2, b2, *, pre_norm: bool,
                    eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same contract), in x's dtype."""
    dt = x.dtype
    h = layer_norm(x, ln_w, ln_b, eps) if pre_norm else x
    h = torch.matmul(h, w1.t()) + b1.to(dt)
    h = F.gelu(h, approximate="none")
    h = torch.matmul(h, w2.t()) + b2.to(dt)
    if not pre_norm:
        h = layer_norm(h, ln_w, ln_b, eps)
    return x + h


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
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.mlp_block_gemm_bf16
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.mlp_block_ctas_per_sm.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.mlp_block_ctas_per_sm.restype = ctypes.c_int
    return lib


def _check_bf16_layout(x, w1, w2) -> None:
    """What the bf16 kernel needs beyond the contract: 16-byte rows."""
    if x.shape[-1] % 8:
        raise ValueError(f"bfloat16 on the card needs C % 8 == 0, got C={x.shape[-1]}")
    for name, t in (("x", x), ("w1", w1), ("w2", w2)):
        if t.data_ptr() % 16:
            raise ValueError(f"bfloat16 on the card needs {name} on a 16-byte boundary")


def product_bf16(a, w, bias, *, epi: int, tile: int, resid=None) -> torch.Tensor:
    """One bf16 product of the block alone on the card, epi(a w^T + bias)
    with epi 0 (+ bias), 1 (exact GELU) or 2 (+ bias + resid), at output
    tile width `tile`: the kernel `mlp_block` launches, to time the products
    apart from the row passes. Not on any path and not counted."""
    M, K = a.shape
    out = torch.empty((M, w.shape[0]), dtype=a.dtype, device=a.device)
    err = _library().mlp_block_gemm_bf16(
        a.data_ptr(), w.data_ptr(), bias.data_ptr(), 0 if resid is None else resid.data_ptr(),
        out.data_ptr(), M, w.shape[0], K, epi, tile,
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


class MlpBlock:
    """Callable wrapper of the kernels; `launches` counts calls that launched
    them (one call is one MLP sub-block: two products and one row pass)."""

    def __init__(self):
        self.launches = 0

    def __call__(self, x, ln_w, ln_b, w1, b1, w2, b2, *, pre_norm: bool,
                 eps: float = 1e-5) -> torch.Tensor:
        _check(x, ln_w, ln_b, w1, b1, w2, b2)
        if x.device.type == "cpu":
            return mlp_block_plain(x, ln_w, ln_b, w1, b1, w2, b2, pre_norm=pre_norm, eps=eps)
        if x.device.type != "cuda":
            raise ValueError(f"mlp_block: unsupported device {x.device}")
        if x.dtype == torch.bfloat16:
            _check_bf16_layout(x, w1, w2)
        lib = _library()
        C = x.shape[-1]
        R = x.numel() // C
        Hd = w1.shape[0]
        sms = sm_count(x.device.index if x.device.index is not None
                       else torch.cuda.current_device())
        h_ln = torch.empty_like(x) if pre_norm else None
        hid = torch.empty((R, Hd), dtype=x.dtype, device=x.device)
        f = None if pre_norm else torch.empty_like(x)
        out = torch.empty_like(x)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mlp_block_fwd(
            x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), 0 if h_ln is None else h_ln.data_ptr(),
            hid.data_ptr(), 0 if f is None else f.data_ptr(), out.data_ptr(),
            R, C, Hd, int(pre_norm), _DTYPE_CODE[x.dtype], pick_tile(R, Hd, C, sms),
            pick_tile(R, C, Hd, sms), eps, stream)
        if err != 0:
            raise RuntimeError(f"mlp_block kernel failed: CUDA error {err}")
        self.launches += 1
        return out


mlp_block = MlpBlock()
