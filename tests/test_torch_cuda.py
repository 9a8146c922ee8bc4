"""The port's CUDA kernels vs their plain versions, on an NVIDIA GPU only.

CUDA kernels have no CPU mode, so every test here is marked `cuda` and
skips when torch.cuda.is_available() is false. The file imports no JAX, so
it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: float32 rtol 1e-4, atol 1e-5 (sums in another order; the
block chain, several blocks deep, atol 1e-4); bfloat16 |d| <= 2e-2 (1 + |ref|)
against the float32 plain version of the same bf16 inputs (one bf16 rounding
of the output and of the MLP's hidden activations), 4e-2 (1 + |ref|) for the
block chain, whose chains round the inputs of four products per block and
whose V2 post-norm rescales each sub-block's output to unit size.
"""

from __future__ import annotations

import pytest
import torch
from torch_port_harness import attn_inputs

from avmoe_tpu_torch.kernels.block_chain import (
    block_chain, block_chain_plain, chain_groups, stack_chain)
from avmoe_tpu_torch.kernels.mlp_block import mlp_block, mlp_block_plain
from avmoe_tpu_torch.models.ave import init_parameters
from avmoe_tpu_torch.ops.swin import SwinBlock, partition_windows
from avmoe_tpu_torch.kernels.window_attention import window_attention, window_attention_plain

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _mlp_args(R, C):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(R, C, generator=g)
    lw, lb = 1 + 0.1 * torch.randn(C, generator=g), 0.1 * torch.randn(C, generator=g)
    w1 = torch.randn(4 * C, C, generator=g) / C ** 0.5
    w2 = torch.randn(C, 4 * C, generator=g) / (4 * C) ** 0.5
    return x, lw, lb, w1, 0.1 * torch.randn(4 * C, generator=g), w2, 0.1 * torch.randn(C, generator=g)


def _check(out, ref, dtype, bf16_tol=2e-2):
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
    else:
        assert bool(((out.float() - ref).abs() <= bf16_tol * (1 + ref.abs())).all())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_window_attention_matches_plain(cuda_device, dtype):
    q, k, v, bias = (torch.from_numpy(a).to(cuda_device)
                     for a in attn_inputs(16, 3, 6, 144, 32, seed=1))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    before = window_attention.launches
    out = window_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert window_attention.launches == before + 1
    _check(out, window_attention_plain(q.float(), k.float(), v.float(), bias), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pre_norm", [True, False])
def test_cuda_mlp_block_matches_plain(cuda_device, dtype, pre_norm):
    x, lw, lb, w1, b1, w2, b2 = (t.to(cuda_device) for t in _mlp_args(R=1000, C=96))
    before = mlp_block.launches
    out = mlp_block(x.to(dtype), lw, lb, w1.to(dtype), b1, w2.to(dtype), b2,
                    pre_norm=pre_norm)
    torch.cuda.synchronize()
    assert mlp_block.launches == before + 1
    ref = mlp_block_plain(x.to(dtype).float(), lw, lb, w1.to(dtype).float(), b1,
                          w2.to(dtype).float(), b2, pre_norm=pre_norm)
    _check(out, ref, dtype)


@pytest.mark.cuda
def test_cuda_wrappers_raise_instead_of_falling_back(cuda_device):
    q = torch.zeros(1, 1, 300, 8, device=cuda_device)
    with pytest.raises(ValueError, match="N <= 256"):
        window_attention(q, q, q, torch.zeros(1, 1, 300, 300, device=cuda_device))
    x, lw, lb, w1, b1, w2, b2 = (t.to(cuda_device) for t in _mlp_args(R=8, C=16))
    with pytest.raises(ValueError, match="on cpu"):
        mlp_block(x, lw.cpu(), lb, w1, b1, w2, b2, pre_norm=True)


def _chain_blocks(version, res, window, depth, device):
    """Seeded SwinBlocks of one stage on `device`; biases and norms noised."""
    C, heads = (96, 3) if version == "v2" else (96, 4)
    kw = dict(pretrained_window=window) if version == "v2" else {}
    blocks = torch.nn.ModuleList(
        SwinBlock(C, (res, res), heads, window, 0 if i % 2 == 0 else window // 2,
                  version=version, **kw) for i in range(depth)).to(device)
    g = torch.Generator(device=device).manual_seed(3)
    init_parameters(blocks, g)
    with torch.no_grad():
        for p in blocks.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=g, device=device))
    return list(blocks)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("version,res,window,part", [
    ("v2", 24, 12, "full"),   # N=144, a K=1 chain then a shifted one
    ("v2", 12, 12, "full"),   # one window per frame, a K=2 chain
    ("v2", 24, 12, "attn"),
    ("v1", 16, 8, "full"),    # N=64, HTS-AT's pre-norm blocks
    ("v1", 8, 8, "attn"),
])
def test_cuda_block_chain_matches_plain(cuda_device, dtype, version, res, window, part):
    blocks = _chain_blocks(version, res, window, 2, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.randn(5, res * res, blocks[0].dim, generator=g, device=cuda_device)
    for grp in chain_groups(blocks):
        ops, geom = stack_chain(grp, part, dtype)
        xw = partition_windows(x, geom.H, geom.W, geom.window, geom.shifts[0]).to(dtype)
        before = block_chain.launches
        out = block_chain.windows(xw, ops, geom)
        torch.cuda.synchronize()
        assert block_chain.launches == before + 1
        ref = block_chain_plain(xw.float(), {k: v.float() for k, v in ops.items()}, geom)
        if dtype == torch.float32:
            torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
        else:
            _check(out, ref, dtype, bf16_tol=4e-2)


@pytest.mark.cuda
def test_cuda_block_chain_raises_instead_of_falling_back(cuda_device):
    blocks = _chain_blocks("v1", 8, 8, 1, cuda_device)
    ops, geom = stack_chain(blocks)
    x = torch.zeros(2, 64, 96, device=cuda_device)
    with pytest.raises(ValueError, match="on cpu"):
        block_chain(x, dict(ops, fc1_bias=ops["fc1_bias"].cpu()), geom)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        block_chain(x.half(), ops, geom)
