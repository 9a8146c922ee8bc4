"""chip_smoke.py's per-shape plans add up to the launches the injection plan
gives one forward, so the per-forward kernel totals it reports (and PERF.md
quotes) cannot drift from the model; the AVVP launch plan (adapters in all
four stages) and its sites against the JAX package's plan; K2's output-tile
pick at those shapes; the ptxas report that K1b's spill check reads. CPU
only, no kernel is built."""

from __future__ import annotations

import dataclasses
import math

import pytest

import chip_smoke
from avmoe_tpu_torch.config import AVEConfig, AVVPConfig
from avmoe_tpu_torch.kernels.mlp_block import (
    TILE_ROWS, TILE_WIDTHS, busiest_sm_tiles, pick_tile, product_seconds)
from avmoe_tpu_torch.moe.injection import backward_launches, kernel_launches, plan_injection

_FRAMES = chip_smoke.BATCH * 10


@pytest.mark.parametrize("kernel,chains,calls,want", [
    ("K1", False, lambda: [s[-1] for s in chip_smoke.k1_shapes(_FRAMES)], 36),
    ("K2", False, lambda: [s[-1] for s in chip_smoke.k2_shapes(_FRAMES)], 36),
    ("K3", True, lambda: [n for _, n in chip_smoke.k3_shapes()], 28),
])
def test_chip_smoke_shapes_sum_to_the_planned_launches(kernel, chains, calls, want):
    cfg = AVEConfig()
    planned = kernel_launches(cfg.swin, cfg.htsat, cfg.injection, chains)[kernel]
    assert sum(calls()) == planned == want


@pytest.mark.parametrize("kernel,calls,want", [
    ("K1b", lambda: [s[-1] for s in chip_smoke.k1b_shapes(_FRAMES)], 34),
    ("K2b", lambda: [s[-1] for s in chip_smoke.k2b_shapes(_FRAMES)], 35),
])
def test_chip_smoke_train_shapes_sum_to_the_planned_backward_launches(kernel, calls, want):
    cfg = AVEConfig()
    assert sum(calls()) == backward_launches(cfg.swin, cfg.htsat, cfg.injection)[kernel] == want
    # every shape of the forward is also a shape of the backward
    fwd = chip_smoke.k1_shapes(_FRAMES) if kernel == "K1b" else chip_smoke.k2_shapes(_FRAMES)
    shapes = chip_smoke.k1b_shapes(_FRAMES) if kernel == "K1b" else chip_smoke.k2b_shapes(
        _FRAMES)
    assert {s[:-1] for s in fwd} == {s[:-1] for s in shapes}


# AVVPConfig(): num_skip=1, so every stage has its sites; the kernels' calls
# per forward stay those of the backbones, the chain path's split moves
AVVP_PLAN = {"sites": 12, "adapter calls": 48, "K1": 36, "K2": 36, "K3": 0,
             "chain K2": 12, "chain K3": 30, "K1b": 34, "K2b": 35}


@pytest.mark.parametrize("what", sorted(AVVP_PLAN))
def test_avvp_launch_plan(what):
    cfg = AVVPConfig()
    sites = plan_injection(cfg.swin, cfg.htsat, cfg.injection)
    kinds = 4 if cfg.injection.audio_adapter_p1 and cfg.injection.audio_adapter_p2 else 2
    got = {"sites": len(sites), "adapter calls": kinds * len(sites),
           **kernel_launches(cfg.swin, cfg.htsat, cfg.injection, False),
           **{f"chain {k}": v for k, v in kernel_launches(cfg.swin, cfg.htsat, cfg.injection,
                                                            True).items()},
           **backward_launches(cfg.swin, cfg.htsat, cfg.injection)}
    assert got[what] == AVVP_PLAN[what]
    assert got["chain K1"] == 0


def test_avvp_sites_match_the_jax_plan():
    pytest.importorskip("jax")
    from avmoe_tpu.config import AVVPConfig as JAVVPConfig
    from avmoe_tpu.moe.injection import plan_injection as j_plan

    cfg, jcfg = AVVPConfig(), JAVVPConfig()
    ours = [dataclasses.astuple(s) for s in plan_injection(cfg.swin, cfg.htsat, cfg.injection)]
    ref = [dataclasses.astuple(s) for s in j_plan(jcfg.swin, jcfg.htsat, jcfg.injection)]
    assert ours == ref
    by_stage = {}
    for s in plan_injection(cfg.swin, cfg.htsat, cfg.injection):
        by_stage.setdefault(s.stage, []).append(s)
    assert [len(v) for _, v in sorted(by_stage.items())] == [2, 2, 6, 2]
    # the widths of the sites AVE has not: stages 1 and 3
    s1, s3 = by_stage[1][0], by_stage[3][0]
    assert (s1.vis_tokens, s1.vis_dim, s1.aud_tokens, s1.aud_dim) == (576, 384, 1024, 192)
    assert (s3.vis_tokens, s3.vis_dim, s3.aud_tokens, s3.aud_dim) == (36, 1536, 64, 768)
    # AVE keeps its 8 sites in stages 0 and 2
    ave = AVEConfig()
    assert [s.stage for s in plan_injection(ave.swin, ave.htsat, ave.injection)] == [0] * 2 + [2] * 6


@pytest.mark.parametrize("sms", [132, 114])
def test_k2_tile_pick_covers_the_output_and_loads_no_sm_more_than_128_wide_tiles(sms):
    # every bf16 product of the main path (fc1: N = 4C, K = C; fc2: N = C,
    # K = 4C) on an H100 SXM (132 SMs) and PCIe (114 SMs)
    for R, C, _, _ in chip_smoke.k2_shapes(_FRAMES):
        for N, K in ((4 * C, C), (C, 4 * C)):
            w = pick_tile(R, N, K, sms)
            assert w in TILE_WIDTHS
            rows, cols = math.ceil(R / TILE_ROWS), math.ceil(N / w)
            assert rows * TILE_ROWS >= R and cols * w >= N
            assert (rows - 1) * TILE_ROWS < R and (cols - 1) * w < N
            # the output columns the busiest SM computes
            assert (busiest_sm_tiles(R, N, w, sms) * w
                    <= busiest_sm_tiles(R, N, 128, sms) * 128), (R, N, w)
            assert (product_seconds(R, N, K, w, sms)
                    <= product_seconds(R, N, K, 128, sms)), (R, N, K, w)


_PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_131window_attention_bwd_mma_kernelILi9ELi2EEEvPK13__nv_bfloat16S3_S3_PKfS3_S3_PS1_S6_S6_iiiib' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_131window_attention_bwd_mma_kernelILi9ELi2EEEvPK13__nv_bfloat16S3_S3_PKfS3_S3_PS1_S6_S6_iiiib
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 112 registers, used 1 barriers, 428 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_127window_attention_bwd_kernelILi5EEEvPKfS2_S2_S2_S2_S2_PfS3_S3_iiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_127window_attention_bwd_kernelILi5EEEvPKfS2_S2_S2_S2_S2_PfS3_S3_iiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 424 bytes cmem[0]
"""


def test_ptxas_report_reads_registers_and_spills_per_entry_function(tmp_path):
    # the spill check of K1b's bf16 instantiations reads this report; no
    # cu++filt here, so the names stay mangled
    rows = chip_smoke.ptxas_report(_PTXAS_LOG, tmp_path / "cu++filt")
    assert [r[1:] for r in rows] == [[112, 8, 4], [40, 0, 0]]
    assert "window_attention_bwd_mma_kernel" in rows[0][0]
    assert "window_attention_bwd_mma_kernel" not in rows[1][0]
