"""Runtime switches shared by the port's modules.

Counterpart of the part of `avmoe_tpu/utils/runtime.py` that the train path
reads; the port keeps its own copy and reads the same environment variable.
"""

from __future__ import annotations

import os


def dropout_det(train: bool) -> bool:
    """Deterministic flag of every dropout site (and SpecAugment): eval is
    always deterministic; train goes deterministic under
    AVMOE_DETERMINISTIC_TRAIN=1, the switch that makes the port and the JAX
    package agree step by step (their random masks cannot match). DropPath
    does not read it: only its rate turns it off, as in the JAX package."""
    return (not train) or os.environ.get("AVMOE_DETERMINISTIC_TRAIN", "0") == "1"
