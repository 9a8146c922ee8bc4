"""Runtime helpers shared by the port's modules.

Counterpart of the device-neutral part of `avmoe_tpu/utils/runtime.py`:
the dropout switch the train path reads (the same environment variable),
`pipelined`, the deferred-readback iterator of the test loop,
`archive_sources`, the snapshot of the sources a run was made with, and
`profiler_trace`, a torch.profiler trace scope.
"""

from __future__ import annotations

import contextlib
import os
import shutil
from collections import deque
from typing import Optional

PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the Python modules and the CUDA sources the kernels are built from
SOURCE_SUFFIXES = (".py", ".cu", ".cuh")


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


def archive_sources(dst_dir: str, root: Optional[str] = None) -> int:
    """Copy the package's sources (default: this package, `csrc/` included;
    not the kernels' build directory) to `<dst_dir>/sources/`, keeping their
    paths under the package. Returns the number of files copied (none off
    rank 0 of a process group, which alone writes)."""
    from avmoe_tpu_torch.parallel.mesh import is_main

    if not is_main():
        return 0
    root = root or PACKAGE_ROOT
    count = 0
    for dirpath, dirnames, files in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d not in ("__pycache__", "_build"))
        for f in sorted(files):
            if f.endswith(SOURCE_SUFFIXES):
                src = os.path.join(dirpath, f)
                out = os.path.join(dst_dir, "sources", os.path.relpath(src, root))
                os.makedirs(os.path.dirname(out), exist_ok=True)
                shutil.copyfile(src, out)
                count += 1
    return count


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """torch.profiler scope over the host and, where there is a card, the
    device; on exit it writes a Chrome trace (`<worker>.<time>.pt.trace.json`)
    under `logdir`, which TensorBoard's profiler plugin and Perfetto read.
    Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof
