"""The port's CUDA kernels vs their plain versions, on an NVIDIA GPU only.

CUDA kernels have no CPU mode, so every test here is marked `cuda` and
skips when torch.cuda.is_available() is false. The file imports no JAX, so
it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: float32 rtol 1e-4, atol 1e-5 (sums in another order; the
block chain, several blocks deep, atol 1e-4); bfloat16 |d| <= 2e-2 (1 + |ref|)
against the float32 plain version of the same bf16 inputs (one bf16 rounding
of the output, of the attention probabilities and of the MLP's hidden
activations), 4e-2 (1 + |ref|) (chip_smoke.K3_BF16_TOL) for the block chain,
whose chains round the inputs of four products per block, run attention on
TF32 operands, and whose V2 post-norm rescales each sub-block's output to
unit size. The backward kernels K1b and K2b are held the same way against
the plain versions' autograd (float32 of the same bf16 inputs for bf16).
Their parameter gradients (K1b's dbias, K2b's dW1, db1, dW2, db2, d ln_w,
d ln_b), sums over many windows or rows, are held as chip_smoke.py holds
them: float32 |d| <= 1e-5 sqrt(terms) + 1e-4 |ref| (terms: the frames a
window's bias sums, or the rows), bf16 max |d| <= 2e-2 (1 + max |ref|), and
bit-identical across two calls.
"""

from __future__ import annotations

import pytest
import torch
from torch_port_harness import attn_inputs

from avmoe_tpu_torch.kernels.block_chain import (
    block_chain, block_chain_plain, chain_groups, stack_chain)
from avmoe_tpu_torch.kernels.mlp_block import (
    EPI_ADD, EPI_GELU_GRAD, EPI_PLAIN, TILE_WIDTHS, WGMMA_WIDTHS, gelu_grad, mlp_block,
    mlp_block_bwd, mlp_block_plain, pick_tile, pick_wgmma_tile, product_bf16, product_wgmma)
from avmoe_tpu_torch.models.ave import init_parameters
from avmoe_tpu_torch.ops.swin import SwinBlock, partition_windows
from avmoe_tpu_torch.kernels.window_attention import (
    window_attention, window_attention_bwd, window_attention_plain)

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
@pytest.mark.parametrize("nW,B,H,N,D", [
    (16, 3, 6, 144, 32),
    # the main path's (N, D) and the contract's largest, with 7 windows of
    # one class or 3 in each of 4: the bf16 kernel's runs of windows per
    # block, and its heads, do not come out even
    *((nW, B, H, N, D) for N, D in ((144, 32), (36, 32), (64, 24), (256, 64))
      for nW, B, H in ((1, 7, 5), (4, 3, 3))),
])
def test_cuda_window_attention_matches_plain(cuda_device, dtype, nW, B, H, N, D):
    q, k, v, bias = (torch.from_numpy(a).to(cuda_device)
                     for a in attn_inputs(nW, B, H, N, D, seed=1))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    before = window_attention.launches
    out = window_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert window_attention.launches == before + 1
    _check(out, window_attention_plain(q.float(), k.float(), v.float(), bias), dtype)


# (R, C): every main-path width with R not a multiple of the 128-row tile;
# (1450, 1536) is full depth (K = 6144 in fc2) at about Swin-V2 stage 3's
# batch-4 rows; (777, 200) a width whose K is no multiple of the 32-deep step
_MLP_CASES = [(1000, 96), (2900, 192), (1700, 384), (700, 768), (300, 1536), (1450, 1536),
              (777, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pre_norm", [True, False])
@pytest.mark.parametrize("R,C", _MLP_CASES)
def test_cuda_mlp_block_matches_plain(cuda_device, dtype, pre_norm, R, C):
    x, lw, lb, w1, b1, w2, b2 = (t.to(cuda_device) for t in _mlp_args(R=R, C=C))
    before = mlp_block.launches
    out = mlp_block(x.to(dtype), lw, lb, w1.to(dtype), b1, w2.to(dtype), b2,
                    pre_norm=pre_norm)
    torch.cuda.synchronize()
    assert mlp_block.launches == before + 1
    ref = mlp_block_plain(x.to(dtype).float(), lw, lb, w1.to(dtype).float(), b1,
                          w2.to(dtype).float(), b2, pre_norm=pre_norm)
    _check(out, ref, dtype)


def test_mlp_block_cases_reach_every_tile_width():
    # on an H100's 132 SMs the picks of test_cuda_mlp_block_matches_plain's
    # cases (fc1: N = 4C, fc2: N = C) take every width the kernel has
    picked = {pick_tile(R, n, k, 132) for R, C in _MLP_CASES
              for n, k in ((4 * C, C), (C, 4 * C))}
    assert picked == set(TILE_WIDTHS)


@pytest.mark.cuda
@pytest.mark.parametrize("epi", [0, 1, 2])
@pytest.mark.parametrize("width", TILE_WIDTHS)
def test_cuda_mlp_product_matches_plain_at_every_tile_width(cuda_device, width, epi):
    # M, N and K ragged against the 128-row tile, every width and the
    # 32-deep step
    g = torch.Generator().manual_seed(8)
    M, N, K = 1000, 200, 392
    a = torch.randn(M, K, generator=g).bfloat16().to(cuda_device)
    w = (torch.randn(N, K, generator=g) / K ** 0.5).bfloat16().to(cuda_device)
    bias = (0.1 * torch.randn(N, generator=g)).to(cuda_device)
    resid = torch.randn(M, N, generator=g).bfloat16().to(cuda_device)
    out = product_bf16(a, w, bias, epi=epi, tile=width, resid=resid if epi == 2 else None)
    torch.cuda.synchronize()
    ref = a.float() @ w.float().t() + bias
    if epi == 1:
        ref = torch.nn.functional.gelu(ref, approximate="none")
    if epi == 2:
        ref = ref + resid.float()
    _check(out, ref, torch.bfloat16)


@pytest.mark.cuda
def test_cuda_wrappers_raise_instead_of_falling_back(cuda_device):
    q = torch.zeros(1, 1, 300, 8, device=cuda_device)
    with pytest.raises(ValueError, match="N <= 256"):
        window_attention(q, q, q, torch.zeros(1, 1, 300, 300, device=cuda_device))
    x, lw, lb, w1, b1, w2, b2 = (t.to(cuda_device) for t in _mlp_args(R=8, C=16))
    with pytest.raises(ValueError, match="on cpu"):
        mlp_block(x, lw.cpu(), lb, w1, b1, w2, b2, pre_norm=True)


@pytest.mark.cuda
@pytest.mark.parametrize("pre_norm", [True, False])
def test_cuda_mlp_block_bf16_raises_on_rows_the_kernel_cannot_load(cuda_device, pre_norm):
    # the bf16 kernel loads 16-byte chunks: C % 8 != 0, or x off a 16-byte
    # boundary, is refused with a ValueError and runs nothing else
    bf = torch.bfloat16
    x, lw, lb, w1, b1, w2, b2 = (t.to(cuda_device) for t in _mlp_args(R=8, C=12))
    before = mlp_block.launches
    with pytest.raises(ValueError, match="C % 8"):
        mlp_block(x.to(bf), lw, lb, w1.to(bf), b1, w2.to(bf), b2, pre_norm=pre_norm)
    x, lw, lb, w1, b1, w2, b2 = (t.to(cuda_device) for t in _mlp_args(R=8, C=16))
    flat = torch.zeros(8 * 16 + 1, dtype=bf, device=cuda_device)
    shifted = flat[1:].view(8, 16)               # contiguous, 2 bytes off the boundary
    shifted.copy_(x.to(bf))
    with pytest.raises(ValueError, match="16-byte"):
        mlp_block(shifted, lw, lb, w1.to(bf), b1, w2.to(bf), b2, pre_norm=pre_norm)
    assert mlp_block.launches == before


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("version,res,window,frames,cluster_windows", [
    ("v2", 18, 6, 1, 4),      # N=36, 9 windows a frame: clusters of 4, 4, 1; shifts 0 and 3
    ("v1", 8, 8, 5, 2),       # N=64, G=5: clusters of 2, 2, 1
    ("v1", 24, 8, 1, 2),      # N=64, 9 windows a frame: clusters of 2 x 4, 1; shifts 0 and 4
])
def test_cuda_block_chain_several_windows_per_cluster(cuda_device, dtype, version, res, window,
                                                      frames, cluster_windows):
    blocks = _chain_blocks(version, res, window, 2, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn(frames, res * res, blocks[0].dim, generator=g, device=cuda_device)
    groups = chain_groups(blocks)
    assert len(groups) == 2 or res == window      # an unshifted and a shifted chain
    for grp in groups:
        ops, geom = stack_chain(grp, "full", dtype)
        xw = partition_windows(x, geom.H, geom.W, geom.window, geom.shifts[0]).to(dtype)
        assert xw.shape[0] % cluster_windows               # the last cluster is ragged
        ref = block_chain_plain(xw.float(), {k: v.float() for k, v in ops.items()}, geom)
        for w in (cluster_windows, 0):                     # forced, and the kernel's pick
            out = block_chain.windows(xw, ops, geom, cluster_windows=w)
            torch.cuda.synchronize()
            if dtype == torch.float32:
                torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
            else:
                _check(out, ref, dtype, bf16_tol=4e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_block_chain_swin_v2_stage3_g10(cuda_device, dtype):
    # Swin-V2-L stage 3 at batch 1 (10 frames, one 6 x 6 window each, C=1536):
    # four windows a cluster leave a last cluster of two
    blocks = [SwinBlock(1536, (6, 6), 48, 6, 0, version="v2", pretrained_window=6)
              for _ in range(2)]
    blocks = torch.nn.ModuleList(blocks).to(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(6)
    init_parameters(blocks, g)
    ops, geom = stack_chain(list(blocks), "full", dtype)
    xw = torch.randn(10, 36, 1536, generator=g, device=cuda_device).to(dtype)
    ref = block_chain_plain(xw.float(), {k: v.float() for k, v in ops.items()}, geom)
    out = block_chain.windows(xw, ops, geom, cluster_windows=4)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    else:
        _check(out, ref, dtype, bf16_tol=4e-2)


@pytest.mark.cuda
def test_cuda_block_chain_bf16_error_within_chip_smoke_budget(cuda_device):
    # the K=2 chains (Swin-V2 stages 2 and 3, HTS-AT stage 3) at full width
    # and two frames, seeded as chip_smoke.py seeds them
    import chip_smoke

    gen = torch.Generator(device="cuda").manual_seed(7)
    for geom, _ in chip_smoke.k3_shapes():
        if geom.K < 2:
            continue
        blocks = chip_smoke._chain_blocks(geom, gen)
        ops, _ = stack_chain(blocks, geom.part, torch.bfloat16)
        xw = torch.randn(2 * geom.nW, geom.N, geom.C, device="cuda", generator=gen).bfloat16()
        ref = block_chain_plain(xw.float(), {k: v.float() for k, v in ops.items()}, geom)
        out = block_chain.windows(xw, ops, geom)
        rel = ((out.float() - ref).abs() / (1.0 + ref.abs())).max().item()
        assert rel <= chip_smoke.K3_BF16_TOL, (geom, rel)


@pytest.mark.cuda
def test_cuda_block_chain_raises_instead_of_falling_back(cuda_device):
    blocks = _chain_blocks("v1", 8, 8, 1, cuda_device)
    ops, geom = stack_chain(blocks)
    x = torch.zeros(2, 64, 96, device=cuda_device)
    with pytest.raises(ValueError, match="on cpu"):
        block_chain(x, dict(ops, fc1_bias=ops["fc1_bias"].cpu()), geom)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        block_chain(x.half(), ops, geom)
    xw = partition_windows(x, geom.H, geom.W, geom.window, 0)
    with pytest.raises(ValueError, match="cluster_windows"):
        block_chain.windows(xw, ops, geom, cluster_windows=-1)


# ---------------------------------------------------------------------------
# Train: K2's DropPath scale, K1b and K2b against the plain versions' autograd
# ---------------------------------------------------------------------------


def _grads(fn, inputs, dout):
    """fn's output and the gradients of its inputs for the output gradient dout."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    return out, torch.autograd.grad(out, leaves, dout)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nW,B,H,N,D", [
    (16, 2, 6, 144, 32),      # Swin-V2-L stage 1, shifted
    (1, 5, 24, 144, 32),      # stage 3
    (1, 4, 48, 36, 32),       # stage 4 (6 x 6)
    (64, 2, 4, 64, 24),       # HTS-AT stage 1, shifted
    (4, 3, 2, 16, 8),         # the tiny config's windows
    (1, 3, 2, 4, 64),         # the tiny config's last stage
    (3, 2, 3, 50, 20),        # odd N and D
    (4, 2, 3, 144, 64),       # the contract's corner, shifted
])
def test_cuda_window_attention_backward_matches_plain_autograd(cuda_device, dtype, nW, B, H,
                                                               N, D):
    q, k, v, bias = (torch.from_numpy(a).to(cuda_device)
                     for a in attn_inputs(nW, B, H, N, D, seed=2))
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(3)).to(cuda_device)
    inputs = [t.to(dtype) for t in (q, k, v)]
    before = window_attention_bwd.launches
    out, got = _grads(lambda a, b, c: window_attention(a, b, c, bias), inputs, dout.to(dtype))
    torch.cuda.synchronize()
    assert window_attention_bwd.launches == before + 1
    _, ref = _grads(lambda a, b, c: window_attention_plain(a, b, c, bias),
                    [t.float() for t in inputs], dout.to(dtype).float())
    for a, b in zip(got, ref):
        assert a.dtype == dtype
        _check(a, b, dtype)


def _bf16_attn(nW, B, H, N, D, seed, device):
    q, k, v, bias = (torch.from_numpy(a).to(device) for a in attn_inputs(nW, B, H, N, D, seed))
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(seed + 1)).to(device)
    return [t.bfloat16() for t in (q, k, v)], bias, dout.bfloat16()


@pytest.mark.cuda
def test_cuda_window_attention_backward_bf16_finite_behind_the_mask(cuda_device):
    # window class 1 masks every query row from half its keys, on top of
    # attn_inputs' shifted-window mask: their probabilities underflow to 0
    (q, k, v), bias, dout = _bf16_attn(4, 2, 3, 144, 32, seed=4, device=cuda_device)
    bias[1, :, :, 72:] -= 100.0
    _, got = _grads(lambda a, b, c: window_attention(a, b, c, bias), (q, k, v), dout)
    _, ref = _grads(lambda a, b, c: window_attention_plain(a, b, c, bias),
                    [t.float() for t in (q, k, v)], dout.float())
    for a, b in zip(got, ref):
        assert bool(torch.isfinite(a).all())
        _check(a, b, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("nW,B,H,N,D", [(16, 2, 6, 144, 32), (64, 2, 4, 64, 24),
                                        (1, 4, 48, 36, 32), (3, 2, 3, 50, 20)])
def test_cuda_window_attention_backward_bf16_is_bitwise_deterministic(cuda_device, nW, B, H,
                                                                      N, D):
    (q, k, v), bias, dout = _bf16_attn(nW, B, H, N, D, seed=5, device=cuda_device)
    out = window_attention.forward_only(q, k, v, bias)
    first = window_attention_bwd(q, k, v, bias, out, dout)
    second = window_attention_bwd(q, k, v, bias, out, dout)
    # a dO off 16-byte alignment takes the kernel's element-wise loads: the
    # same sums, so the same bits
    flat = torch.empty(dout.numel() + 1, dtype=dout.dtype, device=cuda_device)
    shifted = flat[1:].view(dout.shape)
    shifted.copy_(dout)
    third = window_attention_bwd(q, k, v, bias, out, shifted)
    for a, b, c in zip(first, second, third):
        assert torch.equal(a, b) and torch.equal(a, c)


_MLP_BWD_CASES = [(4, 2304, 192, False), (5, 144, 768, False), (3, 36, 1536, False),
                  (4, 1024, 96, True), (3, 64, 768, True), (2, 16, 16, True), (3, 25, 200, False),
                  (4, 2560, 384, True), (8, 1024, 512, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_scale", [False, True])
@pytest.mark.parametrize("frames,L,C,pre_norm", _MLP_BWD_CASES)
def test_cuda_mlp_block_forward_and_backward_with_droppath_match_plain(
        cuda_device, dtype, with_scale, frames, L, C, pre_norm):
    x, lw, lb, w1, b1, w2, b2 = (t.to(cuda_device) for t in _mlp_args(R=frames * L, C=C))
    x = x.reshape(frames, L, C)
    scale = (torch.tensor([0.0] + [1 / 0.9] * (frames - 1), device=cuda_device)
             if with_scale else None)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(9)).to(cuda_device)
    W1, W2 = w1.to(dtype), w2.to(dtype)
    before = (mlp_block.launches, mlp_block_bwd.launches)
    out, (dx,) = _grads(lambda t: mlp_block(t, lw, lb, W1, b1, W2, b2, pre_norm=pre_norm,
                                            scale=scale), [x.to(dtype)], dy.to(dtype))
    torch.cuda.synchronize()
    assert (mlp_block.launches, mlp_block_bwd.launches) == (before[0] + 1, before[1] + 1)
    ref, (dx_ref,) = _grads(lambda t: mlp_block_plain(t, lw, lb, W1.float(), b1, W2.float(), b2,
                                                      pre_norm=pre_norm, scale=scale),
                            [x.to(dtype).float()], dy.to(dtype).float())
    _check(out, ref, dtype)
    _check(dx, dx_ref, dtype)
    if with_scale:    # the dropped frame: out = x, dx = dy
        assert torch.equal(out[0], x.to(dtype)[0]) and torch.equal(dx[0], dy.to(dtype)[0])


@pytest.mark.cuda
def test_cuda_mlp_block_without_scale_is_unchanged_by_a_unit_scale(cuda_device):
    x, lw, lb, w1, b1, w2, b2 = (t.to(cuda_device) for t in _mlp_args(R=4 * 144, C=384))
    x = x.reshape(4, 144, 384).bfloat16()
    W1, W2 = w1.bfloat16(), w2.bfloat16()
    for pre_norm in (True, False):
        plain = mlp_block(x, lw, lb, W1, b1, W2, b2, pre_norm=pre_norm)
        ones = mlp_block(x, lw, lb, W1, b1, W2, b2, pre_norm=pre_norm,
                         scale=torch.ones(4, device=cuda_device))
        assert torch.equal(plain, ones)


def _check_param(a, b, dtype, terms):
    """A parameter gradient summed over `terms` windows or rows, kernel (a)
    against the float32 plain autograd (b)."""
    assert a.shape == b.shape and a.dtype == torch.float32
    d = (a - b).abs()
    if dtype == torch.float32:
        assert bool((d <= 1e-5 * terms ** 0.5 + 1e-4 * b.abs()).all()), d.max().item()
    else:
        assert d.max().item() <= 2e-2 * (1 + b.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nW,B,H,N,D", [
    (64, 3, 4, 64, 24),       # HTS-AT stage 0, shifted
    (1, 40, 4, 64, 24),       # HTS-AT stage 0, unshifted: 40 windows into one slab
    (1, 3, 32, 64, 24),       # HTS-AT stage 3 (one window a frame)
    (16, 2, 6, 144, 32),      # Swin-V2-L stage 1, shifted
    (3, 2, 3, 50, 20),        # odd N and D
])
def test_cuda_window_attention_backward_bias_gradient(cuda_device, dtype, nW, B, H, N, D):
    q, k, v, bias = (torch.from_numpy(a).to(cuda_device)
                     for a in attn_inputs(nW, B, H, N, D, seed=6))
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(7)).to(cuda_device)
    inputs = [t.to(dtype) for t in (q, k, v)]
    before = window_attention_bwd.launches
    out, got = _grads(window_attention, inputs + [bias], dout.to(dtype))
    torch.cuda.synchronize()
    assert window_attention_bwd.launches == before + 1
    _, ref = _grads(window_attention_plain, [t.float() for t in inputs] + [bias],
                    dout.to(dtype).float())
    for a, b in zip(got[:3], ref[:3]):
        _check(a, b, dtype)
    _check_param(got[3], ref[3], dtype, B)
    again = window_attention_bwd(*inputs, bias, out.detach(), dout.to(dtype), bias_grad=True)
    assert torch.equal(again[3], got[3])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_scale", [False, True])
@pytest.mark.parametrize("frames,L,C,pre_norm", _MLP_BWD_CASES)
def test_cuda_mlp_block_parameter_gradients_match_plain(cuda_device, dtype, with_scale, frames,
                                                        L, C, pre_norm):
    """Trainable weights as float32 masters: K2 and K2b give dx and the six
    parameter gradients, float32, as plain autograd of the plain version of
    the same (rounded) inputs does."""
    x, *params = (t.to(cuda_device) for t in _mlp_args(R=frames * L, C=C))
    x = x.reshape(frames, L, C).to(dtype)
    scale = (torch.tensor([0.0] + [1 / 0.9] * (frames - 1), device=cuda_device)
             if with_scale else None)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(9)).to(cuda_device)
    dy = dy.to(dtype)
    before = mlp_block_bwd.launches
    out, got = _grads(lambda t, *w: mlp_block(t, *w, pre_norm=pre_norm, scale=scale),
                      [x] + params, dy)
    torch.cuda.synchronize()
    assert mlp_block_bwd.launches == before + 1
    rounded = [w.to(dtype).float() if i in (2, 4) else w for i, w in enumerate(params)]
    ref, want = _grads(lambda t, *w: mlp_block_plain(t, *w, pre_norm=pre_norm, scale=scale),
                       [x.float()] + rounded, dy.float())
    _check(out, ref, dtype)
    _check(got[0], want[0], dtype)
    for a, b in zip(got[1:], want[1:]):
        _check_param(a, b, dtype, frames * L)
    _, again = _grads(lambda t, *w: mlp_block(t, *w, pre_norm=pre_norm, scale=scale),
                      [x] + params, dy)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_cuda_backward_wrappers_raise_instead_of_falling_back(cuda_device):
    # a bias that needs a gradient (a trainable backbone) gets it from K1b
    q = torch.randn(2, 1, 16, 8, device=cuda_device)
    bias = torch.randn(1, 1, 16, 16, device=cuda_device)
    _, got = _grads(window_attention, (q, q, q, bias), q)
    _, ref = _grads(window_attention_plain, (q, q, q, bias), q)
    _check_param(got[3], ref[3], torch.float32, 2)
    # K1b holds N <= 144: a differentiable call above it is refused up front
    q = torch.randn(1, 1, 196, 8, device=cuda_device, requires_grad=True)
    with pytest.raises(ValueError, match="N <= 144"):
        window_attention(q, q, q, torch.zeros(1, 1, 196, 196, device=cuda_device))
    with pytest.raises(ValueError, match="N <= 144"):
        window_attention_bwd(*(q.detach(),) * 3, torch.zeros(1, 1, 196, 196, device=cuda_device),
                             q.detach(), q.detach())
    # weights that need a gradient get theirs from K2b
    x, *params = (t.to(cuda_device) for t in _mlp_args(R=8, C=16))
    _, got = _grads(lambda t, *w: mlp_block(t, *w, pre_norm=True), [x] + params, x)
    _, ref = _grads(lambda t, *w: mlp_block_plain(t, *w, pre_norm=True), [x] + params, x)
    for a, b in zip(got[1:], ref[1:]):
        _check_param(a, b, torch.float32, 8)
    # bf16 rows the kernel cannot load
    bf = torch.bfloat16
    x, lw, lb, w1, b1, w2, b2 = (t.to(cuda_device) for t in _mlp_args(R=8, C=16))
    flat = torch.zeros(8 * 16 + 1, dtype=bf, device=cuda_device)
    dy = flat[1:].view(8, 16)
    h1 = torch.zeros(8, 64, dtype=bf, device=cuda_device)
    w1t, w2t = w1.to(bf).t().contiguous(), w2.to(bf).t().contiguous()
    with pytest.raises(ValueError, match="16-byte"):
        mlp_block_bwd(dy, h1, x.to(bf), lw, w1t, w2t, pre_norm=True)
    h1_off = torch.zeros(8 * 64 + 1, dtype=bf, device=cuda_device)[1:].view(8, 64)
    with pytest.raises(ValueError, match="h1 on a 16-byte"):
        mlp_block_bwd(x.to(bf), h1_off, x.to(bf), lw, w1t, w2t, pre_norm=False)


@pytest.mark.cuda
@pytest.mark.parametrize("epi", [3, 4])
@pytest.mark.parametrize("width", TILE_WIDTHS)
def test_cuda_mlp_product_train_epilogues_match_plain(cuda_device, width, epi):
    # the forward's train epilogues on the mma.sync kernel, DropPath (3) and
    # fc1 keeping h1 (4); ragged M, N and K as above
    g = torch.Generator().manual_seed(10)
    M, N, K = 1000, 200, 392
    a = torch.randn(M, K, generator=g).bfloat16().to(cuda_device)
    w = (torch.randn(N, K, generator=g) / K ** 0.5).bfloat16().to(cuda_device)
    bias = (0.1 * torch.randn(N, generator=g)).to(cuda_device)
    resid = torch.randn(M, N, generator=g).bfloat16().to(cuda_device)
    scale = torch.tensor([0.0, 1.25, 0.5, 1.0] * 2, device=cuda_device)   # 125 rows a frame
    rows = scale.repeat_interleave(M // 8)[:, None]
    out2 = torch.empty_like(resid) if epi == 4 else None
    out = product_bf16(a, w, bias, epi=epi, tile=width, resid=resid if epi == 3 else None,
                       out2=out2, scale=scale if epi == 3 else None)
    torch.cuda.synchronize()
    v = a.float() @ w.float().t()
    ref = {3: rows * (v + bias) + resid.float(),
           4: torch.nn.functional.gelu(v + bias, approximate="none")}[epi]
    _check(out, ref, torch.bfloat16)
    if epi == 4:
        _check(out2, v + bias, torch.bfloat16)


# K2b's wgmma product: M, N and K ragged against the 128-row tile, every
# width and the 64-deep step (M = 1440, N = 96, K = 96: one 64-deep step and
# a half-empty one), and 16384 rows with N = 200, K = 392
_WGMMA_CASES = [(1440, 96, 96), (16384, 200, 392)]
_WGMMA_EPIS = [(EPI_GELU_GRAD, False), (EPI_GELU_GRAD, True), (EPI_ADD, False),
               (EPI_PLAIN, False)]


def _wgmma_operands(M, N, K, device, seed=11):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(M, K, generator=g).bfloat16().to(device)
    bt = (torch.randn(N, K, generator=g) / K ** 0.5).bfloat16().to(device)
    aux = torch.randn(M, N, generator=g).bfloat16().to(device)
    # 8 frames: 180 or 2048 rows a frame, a dropped one among them
    scale = torch.tensor([0.0, 1.25, 0.5, 1.0] * 2, device=device)
    return a, bt, aux, scale


@pytest.mark.cuda
@pytest.mark.parametrize("epi,scaled", _WGMMA_EPIS)
@pytest.mark.parametrize("width", WGMMA_WIDTHS)
@pytest.mark.parametrize("M,N,K", _WGMMA_CASES)
def test_cuda_wgmma_product_matches_matmul(cuda_device, M, N, K, width, epi, scaled):
    """The wgmma product and each K2b epilogue against torch.matmul in float32
    on the same bf16 operands: one bf16 rounding of the output, so |d| <=
    4e-3 |ref| + 1e-3; and two calls give the same bits."""
    a, bt, aux, scale = _wgmma_operands(M, N, K, cuda_device)
    kw = dict(epi=epi, tile=width, aux=None if epi == EPI_PLAIN else aux,
              scale=scale if scaled else None)
    out = product_wgmma(a, bt, **kw)
    torch.cuda.synchronize()
    v = a.float() @ bt.float().t()
    rows = scale.repeat_interleave(M // 8)[:, None] if scaled else 1.0
    ref = {EPI_GELU_GRAD: v * gelu_grad(aux.float()) * rows, EPI_ADD: v + aux.float(),
           EPI_PLAIN: v}[epi]
    d = (out.float() - ref).abs()
    assert bool((d <= 4e-3 * ref.abs() + 1e-3).all()), f"max |d| {d.max().item():.3e}"
    assert torch.equal(out, product_wgmma(a, bt, **kw))


@pytest.mark.cuda
def test_cuda_wgmma_product_raises_on_what_it_does_not_take(cuda_device):
    a, bt, aux, _ = _wgmma_operands(256, 96, 96, cuda_device)
    with pytest.raises(RuntimeError, match="CUDA error"):
        product_wgmma(a, bt, epi=EPI_PLAIN, tile=64)          # no such width
    with pytest.raises(RuntimeError, match="CUDA error"):
        product_wgmma(a[:, :90], bt[:, :90], epi=EPI_PLAIN, tile=128)  # K % 8
    with pytest.raises(RuntimeError, match="CUDA error"):
        product_wgmma(a, bt, epi=EPI_ADD, tile=128)           # EPI_ADD without aux


def test_mlp_block_bwd_cases_reach_every_wgmma_width():
    # on an H100's 132 SMs the picks of the K2b cases above (d_h1: N = 4C,
    # K = C; dx: N = C, K = 4C) take every width the wgmma kernel has, for
    # either product
    for gelu, (n, k) in ((True, (4, 1)), (False, (1, 4))):
        picked = {pick_wgmma_tile(f * L, n * C, k * C, 132, gelu=gelu)
                  for f, L, C, _ in _MLP_BWD_CASES}
        assert picked == set(WGMMA_WIDTHS), (gelu, picked)


@pytest.mark.cuda
@pytest.mark.parametrize("pre_norm", [True, False])
def test_cuda_mlp_block_train_forward_keeps_h1_and_f_bit_for_bit(cuda_device, pre_norm):
    """A train forward (keep=True) gives the eval forward's bits and keeps
    fc1's pre-activation h1: on V2 the EPI_BIAS product of x and w1, and f the
    EPI_BIAS product of the hidden activations and w2, bit for bit."""
    from avmoe_tpu_torch.kernels.mlp_block import EPI_BIAS, EPI_GELU, sm_count

    R, C = 2900, 192
    x, lw, lb, w1, b1, w2, b2 = (t.to(cuda_device) for t in _mlp_args(R=R, C=C))
    x, w1, w2 = x.bfloat16(), w1.bfloat16(), w2.bfloat16()
    out, h1, f = mlp_block.forward_only(x, lw, lb, w1, b1, w2, b2, pre_norm=pre_norm, keep=True)
    torch.cuda.synchronize()
    assert torch.equal(out, mlp_block(x, lw, lb, w1, b1, w2, b2, pre_norm=pre_norm))
    assert tuple(h1.shape) == (R, 4 * C) and (f is None) == pre_norm
    if not pre_norm:
        sms = sm_count(cuda_device.index or 0)
        t1, t2 = pick_tile(R, 4 * C, C, sms), pick_tile(R, C, 4 * C, sms)
        assert torch.equal(h1, product_bf16(x, w1, b1, epi=EPI_BIAS, tile=t1))
        hid = product_bf16(x, w1, b1, epi=EPI_GELU, tile=t1)
        assert torch.equal(f, product_bf16(hid, w2, b2, epi=EPI_BIAS, tile=t2))


@pytest.mark.cuda
@pytest.mark.parametrize("N,C", [(4096, 96), (576, 384), (37, 24)])
def test_cuda_bmm_expert_logits_of_bf16_match_the_upcast_product(cuda_device, N, C):
    """The bmm expert's float32 logits of a bf16 x (one bf16 product that
    accumulates in float32) against the float32 product of the upcast values,
    and their backward against the upcast product's autograd."""
    from avmoe_tpu_torch.moe.adapter import _gram_f32

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = (torch.randn(3, N, C, device=cuda_device, generator=gen) * 0.3).bfloat16()
    dz = torch.randn(3, N, N, device=cuda_device, generator=gen)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    out = _gram_f32(xa)
    ref = torch.matmul(xb.float(), xb.float().transpose(1, 2))
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
    (dx,), (dref,) = torch.autograd.grad(out, [xa], dz), torch.autograd.grad(ref, [xb], dz)
    assert dx.dtype == torch.bfloat16
    assert (dx.float() - dref.float()).abs().max() <= 2e-2 * (1 + dref.float().abs()).max()


# AVQA's frozen negative pass runs each Swin-V2-L stage as K3 chains
# (`moe/injection.py` swin_chain_calls): the geometries the AVE chain path
# does not run are stage 0's whole blocks (48 x 48, C=192) and stage 2's 18
# blocks as one chain (12 x 12, C=768)
def _negative_pass_geoms():
    import chip_smoke
    from avmoe_tpu_torch.config import AVQAConfig
    from avmoe_tpu_torch.moe.injection import swin_chain_calls

    ave = {g for g, _ in chip_smoke.k3_shapes()}
    return [c.geom for c in swin_chain_calls(AVQAConfig().swin) if c.geom not in ave]


def test_negative_pass_cases_are_the_new_chain_geometries():
    geoms = _negative_pass_geoms()
    assert [(g.H, g.C, g.K, g.shifts[0]) for g in geoms] == [
        (48, 192, 1, 0), (48, 192, 1, 6), (12, 768, 18, 0)]
    assert all(g.part == "full" for g in geoms)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("index", range(3))
def test_cuda_block_chain_negative_pass_geometries(cuda_device, dtype, index):
    """K3 at full width over two frames, seeded as chip_smoke.py seeds its
    chains: float32 rtol 1e-4, atol 1e-4; bf16 within
    chip_smoke.k3_bf16_budget (K3_BF16_TOL, and for the 18-block chain
    K3_BF16_TOL sqrt(K / 2) or the plain version's bf16 rounding, whichever
    is tighter)."""
    import chip_smoke

    geom = _negative_pass_geoms()[index]
    gen = torch.Generator(device="cuda").manual_seed(8 + index)
    blocks = chip_smoke._chain_blocks(geom, gen)
    ops, _ = stack_chain(blocks, geom.part, dtype)
    xw = torch.randn(2 * geom.nW, geom.N, geom.C, device="cuda", generator=gen).to(dtype)
    ref = block_chain_plain(xw.float(), {k: v.float() for k, v in ops.items()}, geom)
    before = block_chain.launches
    out = block_chain.windows(xw, ops, geom)
    torch.cuda.synchronize()
    assert block_chain.launches == before + 1
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    else:
        rel_plain = ((block_chain_plain(xw, ops, geom).float() - ref).abs()
                     / (1.0 + ref.abs())).max().item()
        _check(out, ref, dtype, bf16_tol=chip_smoke.k3_bf16_budget(geom, rel_plain))


# ---------------------------------------------------------------------------
# the rest of AVE and its driver on the card
# ---------------------------------------------------------------------------


class _Items:
    def __len__(self):
        return 10

    def __getitem__(self, i):
        return {"idx": torch.tensor([i]).numpy(), "x": torch.full((3, 5), float(i)).numpy()}


@pytest.mark.cuda
def test_cuda_batch_loader_copies_pinned_batches_to_the_card(cuda_device):
    from avmoe_tpu_torch.data.loader import BatchLoader

    cpu = list(BatchLoader(_Items(), 4, shuffle=True, seed=3, drop_last=False))
    gpu = BatchLoader(_Items(), 4, shuffle=True, seed=3, drop_last=False, device=cuda_device)
    assert gpu._collate([0, 1])["x"].is_pinned()
    got = list(gpu)
    assert len(got) == len(cpu) == 3
    for a, b in zip(got, cpu):
        for k in b:
            assert a[k].device.type == "cuda" and a[k].dtype == b[k].dtype
            torch.testing.assert_close(a[k].cpu(), b[k], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("head", [{"is_inter_in_cmbs": True}, {"is_temporal_att": False},
                                  {"is_cmbs": False}])
def test_cuda_ave_head_settings_match_cpu(cuda_device, head):
    import dataclasses

    from avmoe_tpu_torch.config import tiny_ave_config
    from avmoe_tpu_torch.models.ave import AVEModel

    cfg = dataclasses.replace(tiny_ave_config(), **head)
    cpu = AVEModel(cfg, device="cpu", seed=0)
    g = torch.Generator().manual_seed(1)
    wave = 0.1 * torch.randn(2, 2, cfg.audio_len, generator=g)
    imgs = torch.rand(2, 2, 64, 64, 3, generator=g)
    gpu = AVEModel(cfg, device=cuda_device, seed=None)
    gpu.load_state_dict(cpu.state_dict())
    ref, out = cpu(wave, imgs), gpu(wave.to(cuda_device), imgs.to(cuda_device))
    keys = ["segment_probs"] if not cfg.is_cmbs else ["is_event_logits", "event_logits",
                                                      "av_score"]
    for k in keys:
        torch.testing.assert_close(out[k].cpu(), ref[k], rtol=1e-3, atol=1e-4)


@pytest.mark.cuda
def test_cuda_tiny_cli_trains_tests_and_resumes(cuda_device, tmp_path):
    import json

    from avmoe_tpu_torch.cli import train_ave

    argv = ["--tiny", "--synthetic", "--batch_size", "2", "--accum_itr", "2",
            "--num_workers", "2", "--model_save_dir", str(tmp_path)]
    best = train_ave.main(argv + ["--epochs", "1"])
    with open(tmp_path / "best.json") as f:
        assert json.load(f) == {"step": 8, "metric": best}
    assert train_ave.main(argv + ["--mode", "test"]) == best
    train_ave.main(argv + ["--resume", "--epochs", "2"])
    assert (tmp_path / "8").is_dir()
