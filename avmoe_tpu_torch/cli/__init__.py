"""Command lines: training, one a task, each with its JAX counterpart's flags
and `add_port_flags`' two; and the data-prep tools `compute_audio_stats`
(with `--device`) and `preprocess` (host code)."""

from __future__ import annotations

import argparse


def add_port_flags(p: argparse.ArgumentParser) -> None:
    """The port's flags beside a JAX CLI's: the compute dtype and the device."""
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=True,
                   help="backbones in bfloat16 (default); --no-bf16 for float32")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
