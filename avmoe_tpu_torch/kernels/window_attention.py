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

Training. Where q, k, v or the bias needs a gradient, the call goes
through an autograd Function whose backward is K1b
(`csrc/window_attention_bwd.cu`; plain version
`window_attention_backward_plain`, which the Function runs on the CPU): dq,
dk and dv from q, k, v, the bias, the output and its gradient, P
recomputed in float32. In bf16 K1b runs its five products on the tensor
cores and rounds P and dS to bf16 as product operands (sums in float32); in
float32 it runs on the CUDA cores, exact within float32 rounding. Where the
bias needs a gradient (a trainable backbone's table or CPB MLP makes it),
K1b also gives dbias (nW, H, N, N) float32, dbias[w] = Σ_b dS[b·nW + w], from
the float32 dS, summed in a fixed order (the same bits every run). K1b
takes N <= 144 and D <= 64 (every main-path and tiny shape).
"""

from __future__ import annotations

import ctypes

import torch

from avmoe_tpu_torch.kernels import _build
from avmoe_tpu_torch.ops.norm import upcast

MAX_N = 256
MAX_D = 64
BWD_MAX_N = 144   # K1b holds a (window, head) in one CTA's shared memory
BWD_MAX_D = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _probs(q: torch.Tensor, k: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ + bias[bw % nW]) in float32 (float64 for float64 q)."""
    BW, H, N, D = q.shape
    nW = bias.shape[0]
    logits = torch.matmul(upcast(q), upcast(k).transpose(-1, -2))
    logits = (logits.reshape(BW // nW, nW, H, N, N) + upcast(bias)[None]).reshape(BW, H, N, N)
    return torch.softmax(logits, dim=-1)


def window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same contract; float64 inputs
    stay float64)."""
    return torch.matmul(_probs(q, k, bias), upcast(v)).to(q.dtype)


def window_attention_backward_plain(q, k, v, bias, out, dout, *, bias_grad: bool = False):
    """Plain PyTorch version of K1b, by the kernel's formulas in float32:
    P = softmax(q kᵀ + bias), D = rowsum(dO ∘ O), dv = Pᵀ dO, dP = dO vᵀ,
    dS = P ∘ (dP − D), dq = dS k, dk = dSᵀ q; returned in q's dtype (float64
    stays float64). With `bias_grad` also dbias (nW, H, N, N), dbias[w] =
    Σ_b dS[b·nW + w], in float32 (float64 for float64 q)."""
    qf, kf, vf, dof = upcast(q), upcast(k), upcast(v), upcast(dout)
    p = _probs(q, k, bias)
    d = (dof * upcast(out)).sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - d)
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    grads = dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)
    if not bias_grad:
        return grads
    nW = bias.shape[0]
    return grads + (ds.reshape(-1, nW, *ds.shape[1:]).sum(dim=0),)


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


def _bwd_library() -> ctypes.CDLL:
    lib = _build.load("window_attention_bwd")
    fn = lib.window_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.window_attention_bwd_workspace
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    return lib


def check_backward_shape(N: int, D: int) -> None:
    if not (1 <= N <= BWD_MAX_N and 1 <= D <= BWD_MAX_D):
        raise ValueError(f"the window-attention backward kernel takes N <= {BWD_MAX_N} and "
                         f"D <= {BWD_MAX_D}, got N={N}, D={D}")


class WindowAttentionBackward:
    """Callable wrapper of K1b: (q, k, v, bias, out, dout) -> (dq, dk, dv),
    and with `bias_grad` (dq, dk, dv, dbias), dbias float32; `launches`
    counts kernel launches."""

    def __init__(self):
        self.launches = 0

    def __call__(self, q, k, v, bias, out, dout, *, bias_grad: bool = False):
        _check(q, k, v, bias)
        for name, t in (("out", out), ("dout", dout)):
            if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
                raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} {t.device} does not "
                                 f"match q {tuple(q.shape)} {q.dtype} {q.device}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if q.device.type == "cpu":
            return window_attention_backward_plain(q, k, v, bias, out, dout, bias_grad=bias_grad)
        if q.device.type != "cuda":
            raise ValueError(f"window_attention_bwd: unsupported device {q.device}")
        BW, H, N, D = q.shape
        nW = bias.shape[0]
        check_backward_shape(N, D)
        lib = _bwd_library()
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        dbias = ws = None
        if bias_grad:
            dbias = torch.empty_like(bias)
            ws = torch.empty(lib.window_attention_bwd_workspace(BW, H, N, nW),
                             dtype=torch.float32, device=q.device)
        ptr = lambda t: 0 if t is None else t.data_ptr()
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.window_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), ptr(dbias), ptr(ws),
            BW, H, N, D, nW, _DTYPE_CODE[q.dtype], stream)
        if err != 0:
            raise RuntimeError(f"window_attention_bwd kernel failed: CUDA error {err}")
        self.launches += 1
        return (dq, dk, dv) if dbias is None else (dq, dk, dv, dbias)


window_attention_bwd = WindowAttentionBackward()


class _WindowAttentionFn(torch.autograd.Function):
    """K1 forward, K1b backward (the plain versions on the CPU); dbias where
    the bias needs a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        out = window_attention.forward_only(q, k, v, bias)
        ctx.save_for_backward(q, k, v, bias, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out = ctx.saved_tensors
        bias_grad = ctx.needs_input_grad[3]
        grads = window_attention_bwd(q, k, v, bias, out, dout.contiguous(), bias_grad=bias_grad)
        return grads if bias_grad else grads + (None,)


class WindowAttention:
    """Callable wrapper of the kernel; `launches` counts kernel launches.
    Where q, k, v or the bias needs a gradient the call is differentiable
    through K1b."""

    def __init__(self):
        self.launches = 0

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
        _check(q, k, v, bias)
        if not (torch.is_grad_enabled()
                and any(t.requires_grad for t in (q, k, v, bias))):
            return self.forward_only(q, k, v, bias)
        if q.device.type == "cuda":
            check_backward_shape(q.shape[2], q.shape[3])
        return _WindowAttentionFn.apply(q, k, v, bias)

    def forward_only(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
        """The kernel (plain version on the CPU), no autograd."""
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
