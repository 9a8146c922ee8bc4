"""The port's two kernels: plain versions vs the Pallas TPU kernels they
replace (interpret mode on the CPU) and the wrappers' checks. The CUDA
kernels themselves are tested in test_torch_cuda.py, on a card only.

K1 window attention  <- experiments/pallas/window_attn.py  fused_window_attention
                        (its backward K1b's plain version against jax.vjp of the
                        XLA reference there)
K2 MLP sub-block      <- experiments/pallas/fused_block.py  _run_mlp_only
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from torch_port_harness import attn_inputs, jax_variables, to_jax

from avmoe_tpu_torch.kernels.mlp_block import mlp_block, mlp_block_plain
from avmoe_tpu_torch.kernels.window_attention import (
    window_attention, window_attention_backward_plain, window_attention_bwd,
    window_attention_plain)

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
_PALLAS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                           "experiments", "pallas")


def _pallas(module: str):
    if _PALLAS_DIR not in sys.path:
        sys.path.insert(0, _PALLAS_DIR)
    return __import__(module)


@pytest.mark.parametrize("nW,B,H,N,D", [
    (1, 3, 2, 16, 8),     # unshifted, N a power of two
    (4, 2, 2, 16, 8),     # shifted, nW > 1
    (1, 2, 3, 9, 4),      # N = 9, not a power of two
    (3, 2, 2, 9, 4),      # N = 9, shifted, nW = 3
])
def test_window_attention_plain_matches_pallas(nW, B, H, N, D):
    wa = _pallas("window_attn")
    q, k, v, bias = attn_inputs(nW, B, H, N, D, seed=N + nW)
    jq, jk, jv, jb = map(jnp.asarray, (q, k, v, bias))
    pallas = wa.fused_window_attention(jq, jk, jv, jb, num_windows=nW, interpret=True)
    xla_ref = wa.reference_window_attention(jq, jk, jv, jb, num_windows=nW)

    before = window_attention.launches
    ours = window_attention(*map(torch.from_numpy, (q, k, v, bias)))
    assert window_attention.launches == before  # CPU tensors take the plain version
    assert ours.dtype == torch.float32 and tuple(ours.shape) == q.shape
    np.testing.assert_allclose(ours.numpy(), np.asarray(pallas), **KERNEL_TOL)
    np.testing.assert_allclose(ours.numpy(), np.asarray(xla_ref), **KERNEL_TOL)


@pytest.mark.parametrize("nW,B,H,N,D", [
    (1, 3, 2, 16, 8),
    (4, 2, 2, 16, 8),
    (1, 2, 3, 9, 4),
    (3, 2, 2, 9, 4),
    (4, 1, 2, 144, 32),   # Swin-V2-L's window, shifted, at a small batch
])
def test_window_attention_backward_plain_matches_jax_vjp(nW, B, H, N, D):
    # The Pallas kernel has no VJP (jax.vjp through it fails to linearize);
    # its XLA reference, which the forward test above ties to it, is the JAX
    # side.
    wa = _pallas("window_attn")
    q, k, v, bias = attn_inputs(nW, B, H, N, D, seed=N + nW + 1)
    dout = np.random.RandomState(N + 7).randn(*q.shape).astype(np.float32)
    jb = jnp.asarray(bias)
    _, vjp = jax.vjp(lambda a, b, c: wa.reference_window_attention(a, b, c, jb, num_windows=nW),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(dout))

    tq, tk, tv, tb, tdo = map(torch.from_numpy, (q, k, v, bias, dout))
    out = window_attention_plain(tq, tk, tv, tb)
    got = window_attention_backward_plain(tq, tk, tv, tb, out, tdo)
    before = window_attention_bwd.launches
    wrapped = window_attention_bwd(tq, tk, tv, tb, out, tdo)
    assert window_attention_bwd.launches == before  # CPU tensors take the plain version
    for ours, via_wrapper, ref in zip(got, wrapped, want):
        assert ours.dtype == torch.float32 and tuple(ours.shape) == q.shape
        assert torch.equal(ours, via_wrapper)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **KERNEL_TOL)


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_mlp_block_plain_matches_pallas(version):
    from avmoe_tpu.ops.swin import SwinBlock as JaxSwinBlock

    fb = _pallas("fused_block")
    blk = JaxSwinBlock(dim=16, input_resolution=(8, 8), num_heads=2, window_size=4,
                       shift_size=0, version=version, dtype=jnp.float32)
    rng = np.random.RandomState(7)
    x = rng.randn(3, 64, 16).astype(np.float32)     # 192 rows, a multiple of 8
    variables = jax_variables(blk, jnp.asarray(x), seed=3)
    bound = blk.bind(to_jax(variables))
    params, geom = fb.stack_chain([bound], part="mlp")
    pallas = fb.fused_block_chain(jnp.asarray(x), params, geom, interpret=True)

    p = variables["params"]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    ours = mlp_block(t(x), t(p["norm2"]["scale"]), t(p["norm2"]["bias"]),
                     t(p["mlp"]["fc1"]["kernel"].T), t(p["mlp"]["fc1"]["bias"]),
                     t(p["mlp"]["fc2"]["kernel"].T), t(p["mlp"]["fc2"]["bias"]),
                     pre_norm=version == "v1")
    np.testing.assert_allclose(ours.numpy(), np.asarray(pallas), **KERNEL_TOL)


def _mlp_args(R=24, C=8, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(R, C, generator=g).to(dtype)
    lw, lb = torch.ones(C), torch.zeros(C)
    w1 = torch.randn(4 * C, C, generator=g).to(dtype)
    w2 = torch.randn(C, 4 * C, generator=g).to(dtype)
    return x, lw, lb, w1, torch.zeros(4 * C), w2, torch.zeros(C)


def test_window_attention_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v, bias = map(torch.from_numpy, attn_inputs(2, 2, 2, 16, 8, seed=0))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        window_attention(q.half(), k.half(), v.half(), bias)
    with pytest.raises(ValueError, match="does not match q"):
        window_attention(q, k.bfloat16(), v, bias)
    with pytest.raises(ValueError, match="bias must be float32"):
        window_attention(q, k, v, bias.double())
    with pytest.raises(ValueError, match="multiple of nW"):
        window_attention(q, k, v, torch.zeros(3, 2, 16, 16))
    with pytest.raises(ValueError, match="contiguous"):
        window_attention(q.transpose(2, 3).contiguous().transpose(2, 3),
                         k, v, bias)
    big = torch.zeros(1, 1, 257, 8)
    with pytest.raises(ValueError, match="N <= 256"):
        window_attention(big, big, big, torch.zeros(1, 1, 257, 257))
    wide = torch.zeros(1, 1, 4, 65)
    with pytest.raises(ValueError, match="D <= 64"):
        window_attention(wide, wide, wide, torch.zeros(1, 1, 4, 4))
    m = [t.to("meta") for t in (q, k, v, bias)]
    with pytest.raises(ValueError, match="unsupported device"):
        window_attention(*m)


def test_mlp_block_wrapper_rejects_what_the_kernel_does_not_take():
    x, lw, lb, w1, b1, w2, b2 = _mlp_args()
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        mlp_block(x.double(), lw, lb, w1, b1, w2, b2, pre_norm=True)
    with pytest.raises(ValueError, match="w1 must be"):
        mlp_block(x, lw, lb, w1.bfloat16(), b1, w2, b2, pre_norm=True)
    with pytest.raises(ValueError, match="b2 must be"):
        mlp_block(x, lw, lb, w1, b1, w2, b2[:4], pre_norm=True)
    with pytest.raises(ValueError, match="contiguous"):
        mlp_block(x.t().contiguous().t(), lw, lb, w1, b1, w2, b2, pre_norm=False)
    m = [t.to("meta") for t in (x, lw, lb, w1, b1, w2, b2)]
    with pytest.raises(ValueError, match="unsupported device"):
        mlp_block(*m, pre_norm=True)


@pytest.mark.parametrize("pre_norm", [True, False])
def test_mlp_block_cpu_takes_plain_version(pre_norm):
    args = _mlp_args()
    before = mlp_block.launches
    out = mlp_block(*args, pre_norm=pre_norm)
    assert mlp_block.launches == before
    torch.testing.assert_close(out, mlp_block_plain(*args, pre_norm=pre_norm),
                               rtol=0, atol=0)
