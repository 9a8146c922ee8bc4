"""chip_smoke.py's per-shape plans add up to the launches the injection plan
gives one forward, so the per-forward kernel totals it reports (and PERF.md
quotes) cannot drift from the model. CPU only, no kernel is built."""

from __future__ import annotations

import pytest

import chip_smoke
from avmoe_tpu_torch.config import AVEConfig
from avmoe_tpu_torch.moe.injection import kernel_launches

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
