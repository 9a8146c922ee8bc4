"""Command lines: training, one a task, each with its JAX counterpart's flags
and `add_port_flags`' two; and the data-prep tools `compute_audio_stats`
(with `--device`) and `preprocess` (host code).

The training CLIs run as one process, or as one process a device under
`torchrun` (`parallel/mesh.py` `launch`): the global batch is sharded over
the ranks, every rank holds the state, and rank 0 writes. They read the JAX
package's fused-combine switches from the same environment variables
(`fused_switches`)."""

from __future__ import annotations

import argparse
import os


def add_port_flags(p: argparse.ArgumentParser) -> None:
    """The port's flags beside a JAX CLI's: the compute dtype and the device."""
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=True,
                   help="backbones in bfloat16 (default); --no-bf16 for float32")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")


FUSED_SWITCHES = {"fused_moe": "AVMOE_FUSED_MOE", "fused_moe_train": "AVMOE_FUSED_MOE_TRAIN"}


def fused_switches() -> dict:
    """The task models' fused-combine arguments that the JAX package's
    environment variables turn on: AVMOE_FUSED_MOE=1 (eval) and
    AVMOE_FUSED_MOE_TRAIN=1 (train). Both are off by default, and an unset
    one is left out (the model's default, off)."""
    return {arg: True for arg, var in FUSED_SWITCHES.items() if os.environ.get(var) == "1"}
