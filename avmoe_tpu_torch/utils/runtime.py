"""Runtime helpers shared by the port's modules.

Counterpart of the device-neutral part of `avmoe_tpu/utils/runtime.py`:
the dropout switch the train path reads (the same environment variable)
and `pipelined`, the deferred-readback iterator of the test loop.
"""

from __future__ import annotations

import os
from collections import deque


def dropout_det(train: bool) -> bool:
    """Deterministic flag of every dropout site (and SpecAugment): eval is
    always deterministic; train goes deterministic under
    AVMOE_DETERMINISTIC_TRAIN=1, the switch that makes the port and the JAX
    package agree step by step (their random masks cannot match). DropPath
    does not read it: only its rate turns it off, as in the JAX package."""
    return (not train) or os.environ.get("AVMOE_DETERMINISTIC_TRAIN", "0") == "1"


def pipelined(fn, iterable, depth: int = 2):
    """Iterate `(item, fn(item))` pairs with up to depth + 1 calls in flight.

    `fn` must only enqueue device work (return tensors without reading them
    on the host). Item i is yielded after item i + depth has been
    dispatched, so the consumer's host readback of item i overlaps the
    device's work on the items still in flight."""
    q = deque()
    for item in iterable:
        q.append((item, fn(item)))
        if len(q) > depth:
            yield q.popleft()
    while q:
        yield q.popleft()
