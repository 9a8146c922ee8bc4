"""Window-attention core: softmax(q kᵀ + bias[bw % nW]) v per (window, head).

Replaces the TPU kernel `fused_window_attention`
(experiments/pallas/window_attn.py:55, body `_attn_kernel` :30). The CUDA
kernel is `csrc/window_attention.cu`; `window_attention_plain` below is its
plain PyTorch version, taken only for tensors on the CPU.

Contract (that of the TPU kernel):
  q, k, v  (BW, H, N, D), all float32 or all bfloat16, contiguous; q already
           scaled (V1: D**-0.5; V2: row-normalized times the logit scale)
  bias     (nW, H, N, N) float32, contiguous; window bw uses bias[bw % nW]
  returns  (BW, H, N, D) in q's dtype; logits, softmax and the PV sum are
           float32 (in bf16 the kernel runs q kᵀ and p v on the tensor cores
           and rounds p to bf16 for p v, as the JAX package's XLA attention
           does)
"""

from __future__ import annotations

import ctypes

import torch

from avmoe_tpu_torch.kernels import _build

MAX_N = 256
MAX_D = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same contract)."""
    BW, H, N, D = q.shape
    nW = bias.shape[0]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    logits = (logits.reshape(BW // nW, nW, H, N, N) + bias.float()[None]).reshape(BW, H, N, N)
    p = torch.softmax(logits, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def _check(q, k, v, bias) -> None:
    if q.dim() != 4:
        raise ValueError(f"q must be (BW, H, N, D), got {tuple(q.shape)}")
    BW, H, N, D = q.shape
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} {t.device} does not "
                             f"match q {tuple(q.shape)} {q.dtype} {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtype {q.dtype}; expected float32 or bfloat16")
    if bias.dim() != 4 or bias.shape[1:] != (H, N, N) or bias.dtype != torch.float32:
        raise ValueError(f"bias must be float32 (nW, {H}, {N}, {N}), got "
                         f"{bias.dtype} {tuple(bias.shape)}")
    if bias.device != q.device:
        raise ValueError(f"bias on {bias.device}, q on {q.device}")
    nW = bias.shape[0]
    if nW < 1 or BW % nW:
        raise ValueError(f"BW={BW} is not a multiple of nW={nW}")
    if not (1 <= N <= MAX_N and 1 <= D <= MAX_D):
        raise ValueError(f"kernel takes N <= {MAX_N} and D <= {MAX_D}, got N={N}, D={D}")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _library() -> ctypes.CDLL:
    lib = _build.load("window_attention")
    fn = lib.window_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


class WindowAttention:
    """Callable wrapper of the kernel; `launches` counts kernel launches."""

    def __init__(self):
        self.launches = 0

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
        _check(q, k, v, bias)
        if q.device.type == "cpu":
            return window_attention_plain(q, k, v, bias)
        if q.device.type != "cuda":
            raise ValueError(f"window_attention: unsupported device {q.device}")
        lib = _library()
        BW, H, N, D = q.shape
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.window_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
            BW, H, N, D, bias.shape[0], _DTYPE_CODE[q.dtype], stream)
        if err != 0:
            raise RuntimeError(f"window_attention kernel failed: CUDA error {err}")
        self.launches += 1
        return out


window_attention = WindowAttention()
