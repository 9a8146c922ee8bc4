"""Expert-routing telemetry: per-site activation counts and gate statistics.

Counterpart of `avmoe_tpu/telemetry/experts.py`: per-site argmax counts
and mean gating probabilities accumulated over the eval batches and written
as `.npy` files. `update` takes a model's telemetry dict of tensors and
reads them back to the host once per batch (`to_host`, then `add`);
`lb_loss` and `stage_tokens` are not routing statistics and are skipped.
Only rank 0 of a process group saves.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np
import torch

from avmoe_tpu_torch.parallel.mesh import is_main

SKIPPED = ("lb_loss", "stage_tokens")


class ExpertUsageTracker:
    """Accumulates (site, batch, expert) gating-prob stacks across eval steps."""

    def __init__(self, num_experts: int):
        self.num_experts = num_experts
        self.counts: Dict[str, np.ndarray] = {}
        self.prob_sums: Dict[str, np.ndarray] = {}
        self.n_samples: Dict[str, int] = {}

    def update(self, telemetry: Mapping) -> None:
        """telemetry: {'audio_p1': (S, B, E), 'video_p1': ..., ...} tensors."""
        self.add(self.to_host(telemetry))

    @staticmethod
    def to_host(telemetry: Mapping) -> Dict[str, np.ndarray]:
        """The routing stacks of a model's telemetry as host float32 arrays,
        in one device-to-host copy: what `add` takes, and what a data-parallel
        eval gathers from the ranks (`parallel/mesh.py` `gather_ordered`)."""
        stacks = {k: v for k, v in telemetry.items()
                  if k not in SKIPPED and v.dim() == 3 and v.shape[0] > 0}
        if not stacks:
            return {}
        flat = torch.cat([v.detach().float().reshape(-1) for v in stacks.values()])
        host = np.split(flat.cpu().numpy(), np.cumsum([v.numel() for v in stacks.values()])[:-1])
        return {key: probs.reshape(v.shape) for (key, v), probs in zip(stacks.items(), host)}

    def add(self, stacks: Mapping[str, np.ndarray]) -> None:
        """Accumulate one batch's host stacks (`to_host`)."""
        for key, probs in stacks.items():
            S, B, E = probs.shape
            onehot = np.eye(E, dtype=np.int64)[probs.argmax(-1)]  # (S, B, E)
            if key not in self.counts:
                self.counts[key] = np.zeros((S, E), dtype=np.int64)
                self.prob_sums[key] = np.zeros((S, E), dtype=np.float64)
                self.n_samples[key] = 0
            self.counts[key] += onehot.sum(axis=1)
            self.prob_sums[key] += probs.sum(axis=1)
            self.n_samples[key] += B

    def summary(self) -> Dict[str, Dict[str, np.ndarray]]:
        out = {}
        for key in self.counts:
            n = max(self.n_samples[key], 1)
            out[key] = {"activation_counts": self.counts[key],
                        "activation_fraction": self.counts[key] / n,
                        "mean_gating_probs": self.prob_sums[key] / n}
        return out

    def save(self, directory: str, prefix: str = "expert_stats") -> None:
        """Write each stream's statistics as `{prefix}_{key}_{stat}.npy` (on
        rank 0 only, under a process group)."""
        if not is_main():
            return
        os.makedirs(directory, exist_ok=True)
        for key, stats in self.summary().items():
            for stat_name, arr in stats.items():
                np.save(os.path.join(directory, f"{prefix}_{key}_{stat_name}.npy"), arr)

    def reset(self) -> None:
        self.counts.clear()
        self.prob_sums.clear()
        self.n_samples.clear()
