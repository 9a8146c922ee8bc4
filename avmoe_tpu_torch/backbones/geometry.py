"""Static Swin stage/block geometry shared by the backbones and the MoE wiring.

Counterpart of `avmoe_tpu/backbones/geometry.py`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple


@dataclass(frozen=True)
class BlockSpec:
    stage: int
    index_in_stage: int
    dim: int
    resolution: Tuple[int, int]
    num_heads: int
    window_size: int
    shift_size: int
    drop_path: float
    pretrained_window: int = 0

    @property
    def num_tokens(self) -> int:
        return self.resolution[0] * self.resolution[1]

    @property
    def window_shift(self) -> Tuple[int, int]:
        return effective_window(self.resolution, self.window_size, self.shift_size)


def effective_window(resolution: Tuple[int, int], window: int, shift: int) -> Tuple[int, int]:
    """(window, shift) a Swin block uses: the window shrinks to the grid, and
    the shift drops to 0, when the grid is not larger than the window."""
    if min(resolution) <= window:
        return min(resolution), 0
    return window, shift


def swin_stage_specs(
    embed_dim: int,
    depths: Sequence[int],
    num_heads: Sequence[int],
    patches_resolution: Tuple[int, int],
    window_size: int,
    drop_path_rate: float = 0.0,
    pretrained_window_sizes: Sequence[int] = (),
) -> List[BlockSpec]:
    """Flat per-block specs: dim doubles and resolution halves per stage,
    stochastic depth decays linearly, shift alternates 0 / window//2."""
    total = sum(depths)
    dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
    specs: List[BlockSpec] = []
    k = 0
    for stage, depth in enumerate(depths):
        dim = int(embed_dim * 2**stage)
        res = (patches_resolution[0] // 2**stage, patches_resolution[1] // 2**stage)
        pw = pretrained_window_sizes[stage] if stage < len(pretrained_window_sizes) else 0
        for i in range(depth):
            specs.append(BlockSpec(
                stage=stage, index_in_stage=i, dim=dim, resolution=res,
                num_heads=num_heads[stage], window_size=window_size,
                shift_size=0 if i % 2 == 0 else window_size // 2,
                drop_path=dpr[k], pretrained_window=pw,
            ))
            k += 1
    return specs


def stage_boundaries(depths: Sequence[int]) -> List[Tuple[int, int]]:
    """[(start, end), ...] flat-index ranges per stage."""
    out = []
    start = 0
    for d in depths:
        out.append((start, start + d))
        start += d
    return out
