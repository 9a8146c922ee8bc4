"""K3, the block chain: the port's plain version and run_chain vs the Pallas
TPU kernel they replace (interpret mode on the CPU), the stacked operands vs
the JAX stack_chain, the chain plan of AVEConfig(), the wrapper's checks and
the build hash. The CUDA kernel itself is tested in test_torch_cuda.py, on
a card only.

K3 block chain  <- experiments/pallas/fused_block.py  fused_block_chain

Geometry of experiments/pallas/test_fused_block.py: dim 16, 2 heads,
window 4 on an 8x8 grid (block 0 unshifted, block 1 shifted by 2, so
run_chain makes two K=1 chains, the second one shifted), and a 4x4 grid
under a window of 8 (the window shrinks to the grid: one window, no shift,
one K=2 chain). One pair of JAX block lists per version (module-scoped).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from torch_port_harness import jax_variables, to_jax

from avmoe_tpu_torch.convert import load_jax_variables
from avmoe_tpu_torch.kernels import _build
from avmoe_tpu_torch.kernels.block_chain import (
    OPERANDS, ChainGeom, block_chain, block_chain_plain, chain_groups, run_chain, stack_chain)
from avmoe_tpu_torch.ops.swin import SwinBlock, partition_windows

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

CHAIN_TOL = dict(rtol=2e-5, atol=2e-5)
_PALLAS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                           "experiments", "pallas")


def _fused_block():
    if _PALLAS_DIR not in sys.path:
        sys.path.insert(0, _PALLAS_DIR)
    import fused_block
    return fused_block


def _blocks(version: str, res: int, window: int, depth: int, seed: int):
    """Bound JAX SwinBlocks and the port's SwinBlocks on the same seeded noise."""
    from flax import linen as nn

    from avmoe_tpu.ops.swin import SwinBlock as JSwinBlock

    kw = dict(pretrained_window=window) if version == "v2" else {}
    shift = lambda i: 0 if i % 2 == 0 else window // 2

    class Chain(nn.Module):
        def setup(self):
            self.blocks = [JSwinBlock(dim=16, input_resolution=(res, res), num_heads=2,
                                      window_size=window, shift_size=shift(i), version=version,
                                      dtype=jnp.float32, name=f"b{i}", **kw)
                           for i in range(depth)]

        def __call__(self, x):
            for b in self.blocks:
                x = b(x, False)
            return x

    x = np.random.RandomState(seed).randn(3, res * res, 16).astype(np.float32)
    variables = jax_variables(Chain(), jnp.asarray(x), seed=seed + 10)
    jblocks = Chain().bind(to_jax(variables)).blocks
    pblocks = []
    for i in range(depth):
        pb = SwinBlock(16, (res, res), 2, window, shift(i), version=version, **kw)
        load_jax_variables(pb, {"params": variables["params"][f"b{i}"]})
        pblocks.append(pb)
    return jblocks, pblocks, x


@pytest.fixture(scope="module", params=["v1", "v2"])
def shifted(request):
    """Two blocks on an 8x8 grid, window 4: a K=1 chain, then a shifted K=1 chain."""
    return _blocks(request.param, res=8, window=4, depth=2, seed=0)


@pytest.mark.parametrize("part", ["full", "attn", "mlp"])
def test_run_chain_matches_pallas(shifted, part):
    fb = _fused_block()
    jblocks, pblocks, x = shifted
    assert [len(g) for g in chain_groups(pblocks)] == [1, 1]
    ref = np.asarray(fb.run_chain(jblocks, jnp.asarray(x), part=part, interpret=True))

    before = block_chain.launches
    out = run_chain(pblocks, torch.from_numpy(x), part)
    assert block_chain.launches == before      # CPU tensors take the plain version
    np.testing.assert_allclose(out.numpy(), ref, **CHAIN_TOL)


@pytest.mark.parametrize("part", ["full", "attn", "mlp"])
def test_plain_shifted_chain_matches_pallas_kernel(shifted, part):
    """block_chain_plain on windowed tokens vs one fused_block_chain call of
    the shifted block."""
    fb = _fused_block()
    jblocks, pblocks, x = shifted
    jops, jgeom = fb.stack_chain(jblocks[1:], part=part)
    ref = np.array(fb.fused_block_chain(jnp.asarray(x), jops, jgeom, interpret=True))

    ops, geom = stack_chain(pblocks[1:], part)
    assert geom == ChainGeom(**vars(jgeom)) and geom.shifts == (2,)
    xw = partition_windows(torch.from_numpy(x), geom.H, geom.W, geom.window, 2)
    want = partition_windows(torch.from_numpy(ref), geom.H, geom.W, geom.window, 2)
    np.testing.assert_allclose(block_chain_plain(xw, ops, geom).numpy(), want.numpy(),
                               **CHAIN_TOL)


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_single_window_chain_matches_pallas(version):
    """A 4x4 grid under a window of 8: one window, no shift, one K=2 chain."""
    fb = _fused_block()
    jblocks, pblocks, x = _blocks(version, res=4, window=8, depth=2, seed=1)
    groups = chain_groups(pblocks)
    assert [len(g) for g in groups] == [2]
    ops, geom = stack_chain(groups[0])
    assert (geom.window, geom.shifts, geom.nW, geom.K) == (4, (0, 0), 1, 2)
    ref = np.asarray(fb.run_chain(jblocks, jnp.asarray(x), interpret=True))

    out = run_chain(pblocks, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref, **CHAIN_TOL)
    # one window per frame: windowed tokens are the flat tokens
    np.testing.assert_allclose(block_chain_plain(torch.from_numpy(x), ops, geom).numpy(), ref,
                               **CHAIN_TOL)


def test_stack_chain_matches_jax(shifted):
    fb = _fused_block()
    jblocks, pblocks, _ = shifted
    for k in (slice(0, 1), slice(1, 2)):
        jops, jgeom = fb.stack_chain(jblocks[k])
        ops, geom = stack_chain(pblocks[k])
        assert geom == ChainGeom(**vars(jgeom))
        assert set(ops) == set(jops) == set(OPERANDS)
        for name in OPERANDS:
            assert ops[name].dtype == torch.float32
            np.testing.assert_allclose(ops[name].numpy(), np.asarray(jops[name]),
                                       rtol=1e-6, atol=1e-6, err_msg=name)
    # the shifted chain carries the -100 mask, the unshifted one zeros
    assert float(ops["mask"].min()) == -100.0
    assert not stack_chain(pblocks[:1])[0]["mask"].any()


def test_chain_plan_of_ave_config():
    """The chain path's K3 calls for AVEConfig(), computed without a model."""
    from avmoe_tpu_torch.config import AVEConfig
    from avmoe_tpu_torch.moe.injection import chain_calls, kernel_launches

    cfg = AVEConfig()
    calls = chain_calls(cfg.swin, cfg.htsat, cfg.injection)
    frames = 4 * cfg.num_segments
    rows = {}
    for c in calls:
        g = c.geom
        key = (c.backbone, c.stage, g.part, g.K, g.N, g.C, g.num_heads, frames * g.nW)
        rows.setdefault(key, set()).add(g.shifts[0])
        assert g.mlp_hidden == 4 * g.C
        assert g.version == ("v2" if c.backbone == "swin" else "v1")
    count = lambda key: sum(
        1 for c in calls if (c.backbone, c.stage, c.geom.part, c.geom.K) == key)
    # (backbone, stage, part, K, N, C, heads, windows at batch 4) -> shifts
    assert rows == {
        ("swin", 0, "attn", 1, 144, 192, 6, 640): {0, 6},
        ("swin", 1, "full", 1, 144, 384, 12, 160): {0, 6},
        ("swin", 2, "full", 2, 144, 768, 24, 40): {0},
        ("swin", 2, "attn", 1, 144, 768, 24, 40): {0},
        ("swin", 3, "full", 2, 36, 1536, 48, 40): {0},
        ("htsat", 0, "full", 1, 64, 96, 4, 2560): {0, 4},
        ("htsat", 1, "full", 1, 64, 192, 8, 640): {0, 4},
        ("htsat", 2, "full", 1, 64, 384, 16, 160): {0, 4},
        ("htsat", 3, "full", 2, 64, 768, 32, 40): {0},
    }
    assert [count(k) for k in (("swin", 0, "attn", 1), ("swin", 1, "full", 1),
                               ("swin", 2, "full", 2), ("swin", 2, "attn", 1),
                               ("swin", 3, "full", 2), ("htsat", 0, "full", 1),
                               ("htsat", 1, "full", 1), ("htsat", 2, "full", 1),
                               ("htsat", 3, "full", 2))] == [2, 2, 6, 6, 1, 2, 2, 6, 1]
    # the chains cover every block once, the sites' visual MLP halves aside
    for backbone, depths in (("swin", cfg.swin.depths), ("htsat", cfg.htsat.depths)):
        covered = sorted(i for c in calls if c.backbone == backbone for i in c.blocks)
        assert covered == list(range(sum(depths)))
    assert kernel_launches(cfg.swin, cfg.htsat, cfg.injection, True) == {
        "K1": 0, "K2": 8, "K3": 28}
    assert kernel_launches(cfg.swin, cfg.htsat, cfg.injection, False) == {
        "K1": 36, "K2": 36, "K3": 0}


@pytest.mark.parametrize("preset", ["AVEConfig", "tiny_ave_config"])
def test_injection_plan_matches_jax(preset):
    """The sites both paths walk (plan_stages) are the JAX plan_injection's."""
    import dataclasses

    from avmoe_tpu import config as jc
    from avmoe_tpu.moe.injection import plan_injection as jax_plan

    from avmoe_tpu_torch import config as pc
    from avmoe_tpu_torch.moe.injection import plan_injection, plan_stages

    jcfg, cfg = getattr(jc, preset)(), getattr(pc, preset)()
    ours = [dataclasses.asdict(s) for s in plan_injection(cfg.swin, cfg.htsat, cfg.injection)]
    ref = [dataclasses.asdict(s) for s in jax_plan(jcfg.swin, jcfg.htsat, jcfg.injection)]
    assert ours == ref and len(ours) == 8
    steps = [st for stage in plan_stages(cfg.swin, cfg.htsat, cfg.injection) for st in stage]
    assert [st.site for st in steps if st.kind == "site"] == list(range(8))
    # every block of both backbones is walked once, in order
    for attr, depths in (("vis", cfg.swin.depths), ("aud", cfg.htsat.depths)):
        assert [i for st in steps for i in getattr(st, attr)] == list(range(sum(depths)))


def test_block_chain_wrapper_rejects_what_the_kernel_does_not_take(shifted):
    _, pblocks, x = shifted
    ops, geom = stack_chain(pblocks[1:])
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        block_chain(xt.double(), ops, geom)
    with pytest.raises(ValueError, match=r"x must be \(B, 64, 16\)"):
        block_chain(xt[:, :32], ops, geom)
    with pytest.raises(ValueError, match="qkv_kernel must be"):
        block_chain(xt, dict(ops, qkv_kernel=ops["qkv_kernel"].bfloat16()), geom)
    with pytest.raises(ValueError, match="logit_scale must be torch.float32"):
        block_chain(xt.bfloat16(), {k: v.bfloat16() for k, v in ops.items()}, geom)
    with pytest.raises(ValueError, match="fc1_kernel must be contiguous"):
        bad = ops["fc1_kernel"].transpose(1, 2).contiguous().transpose(1, 2)
        block_chain(xt, dict(ops, fc1_kernel=bad), geom)
    with pytest.raises(ValueError, match="one shift"):
        block_chain(xt, ops, ChainGeom(**dict(vars(geom), shifts=(0, 2))))
    with pytest.raises(ValueError, match="part must be"):
        block_chain(xt, ops, ChainGeom(**dict(vars(geom), part="both")))
    with pytest.raises(ValueError, match="N <= 144"):
        big = ChainGeom(**dict(vars(geom), H=26, W=26, window=13))
        block_chain(torch.zeros(1, 26 * 26, 16), ops, big)
    with pytest.raises(ValueError, match="multiples of 4"):
        odd = ChainGeom(**dict(vars(geom), H=9, W=9, window=3))
        block_chain(torch.zeros(1, 81, 16), ops, odd)
    with pytest.raises(ValueError, match="part 'mlp' runs on flat tokens"):
        block_chain.windows(xt, ops, ChainGeom(**dict(vars(geom), part="mlp")))
    with pytest.raises(ValueError, match="unsupported device"):
        block_chain(xt.to("meta"), {k: v.to("meta") for k, v in ops.items()}, geom)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_chain_cpu_takes_plain_version(shifted, dtype):
    _, pblocks, x = shifted
    ops, geom = stack_chain(pblocks[1:], dtype=dtype)
    xw = partition_windows(torch.from_numpy(x).to(dtype), geom.H, geom.W, geom.window, 2)
    before = block_chain.launches
    out = block_chain.windows(xw, ops, geom)
    assert block_chain.launches == before
    assert out.dtype == dtype
    torch.testing.assert_close(out, block_chain_plain(xw, ops, geom), rtol=0, atol=0)


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda_runtime.h>\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    assert sorted(p.name for p in _build.sources("k")) == ["a.cuh", "b.cuh", "k.cu"]
    first = _build.library_path("k")
    assert _build.library_path("k") == first
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    second = _build.library_path("k")
    assert second != first and second.name.startswith("libk-")
    monkeypatch.undo()
    for name in ("block_chain", "mlp_block", "window_attention"):
        assert "common.cuh" in [p.name for p in _build.sources(name)]
