"""Epoch-based training loop: train -> eval -> save-if-best -> early stop.

Counterpart of `avmoe_tpu/train/loop.py`, with its log lines and meters.
The metrics of a step are read back to the host three steps later (a
deque of the last three steps' device tensors), so the host never waits on
the step it has just enqueued; the eval loop defers its readback the same
way. Every train step takes the same `torch.Generator` (on the model's
device, seeded from `seed`), whose state advances with each draw, where the
JAX loop splits a PRNG key per step. Under a process group only rank 0
saves checkpoints and writes logs, and the eval metrics are those of every
rank's batches in batch order (`evaluate_batches`).
"""

from __future__ import annotations

import logging
import math
from collections import deque
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from avmoe_tpu_torch.parallel.mesh import gather_ordered, is_main, step_seed
from avmoe_tpu_torch.telemetry.experts import ExpertUsageTracker
from avmoe_tpu_torch.telemetry.meters import AverageMeter, Timer

log = logging.getLogger("avmoe_tpu_torch")

READBACK_DEPTH = 3


def _scalars(metrics) -> dict:
    """The 0-d entries as floats (a device tensor's read waits for its step)."""
    return {k: float(v) for k, v in metrics.items() if np.ndim(v) == 0}


def step_generator(seed: int, device) -> torch.Generator:
    """The train steps' generator: on `device`, seeded from `seed` (on rank
    r of a process group from seed + r, `parallel/mesh.py` `step_seed`)."""
    generator = torch.Generator(device=device)
    generator.manual_seed(step_seed(seed))
    return generator


def resume_latest(checkpoints, state, train_loader) -> int:
    """Restore the latest checkpoint's whole state into `state` and set the
    train loader's epoch counter after it (its shuffle seeds follow);
    returns the epoch to continue at (1 where there is no checkpoint)."""
    if checkpoints.latest_step() is None:
        return 1
    checkpoints.restore(state)
    start_epoch = state.step // max(len(train_loader), 1) + 1
    train_loader.epoch = start_epoch - 1
    log.info("resumed from step %d", state.step)
    return start_epoch


def train_epoch(state, train_step: Callable, train_loader, generator: torch.Generator,
                epoch: int, log_every: int = 50):
    """One pass over `train_loader` (any iterable of batches): a train step a
    batch, each step's metrics read back READBACK_DEPTH steps later. Returns
    (state, the meter of the epoch's scalar metrics)."""
    meter = AverageMeter()
    pending = deque()
    drained = -1  # index of the newest step whose metrics are in the meter
    for i, batch in enumerate(train_loader):
        state, metrics = train_step(state, batch, generator)
        pending.append(metrics)
        if len(pending) > READBACK_DEPTH:
            meter.add(**_scalars(pending.popleft()))
            drained = i - READBACK_DEPTH
        if i % log_every == 0 and meter.count("loss"):
            # the average lags the dispatch frontier by the queue depth
            log.info("epoch %d step %d loss %.4f (thru step %d)",
                     epoch, i, meter.get("loss"), drained)
    for m in pending:
        meter.add(**_scalars(m))
    return state, meter


def evaluate_batches(eval_step: Callable, state, eval_loader) -> List[Tuple[dict, dict]]:
    """(scalar metrics, host routing stacks) of every eval batch, in batch
    order, each read back READBACK_DEPTH batches after its dispatch. Under
    a process group each rank runs its own batches (`split="batches"`) and
    every rank gets all of them (`gather_ordered`)."""
    records, pending = [], deque()

    def drain(m):
        telemetry = m.pop("telemetry", None)
        records.append((_scalars(m), ExpertUsageTracker.to_host(telemetry or {})))

    for batch in eval_loader:
        pending.append(eval_step(state, batch))
        if len(pending) > READBACK_DEPTH:
            drain(pending.popleft())
    for m in pending:
        drain(m)
    return gather_ordered(records)


def train_and_evaluate(*, state, train_step: Callable, eval_step: Callable, train_loader,
                       eval_loader, epochs: int, seed: int = 0, early_stop: int = 0,
                       metric_key: str = "accuracy", checkpoints=None,
                       expert_tracker: Optional[ExpertUsageTracker] = None,
                       log_every: int = 50, writer=None, start_epoch: int = 1,
                       device=None):
    """Run epochs start_epoch..epochs; returns (state, best validation
    metric). `device` is where the step generator lives (default: the
    model's). A resumed run passes the epoch after the restored one as
    `start_epoch`."""
    if device is None:
        device = next(state.model.parameters()).device
    generator = step_generator(seed, device)
    best = -math.inf
    stall = 0
    timer = Timer()

    for epoch in range(start_epoch, epochs + 1):
        state, meter = train_epoch(state, train_step, train_loader, generator, epoch,
                                   log_every)

        eval_meter = AverageMeter()
        if expert_tracker is not None:
            expert_tracker.reset()
        for scalars, stacks in evaluate_batches(eval_step, state, eval_loader):
            eval_meter.add(**scalars)
            if expert_tracker is not None:
                expert_tracker.add(stacks)

        val = eval_meter.get(metric_key)
        train_loss = meter.get("loss")
        log.info("epoch %d done in %.1fs: train_loss %.4f val_%s %.4f",
                 epoch, timer.lap(), train_loss, metric_key, val)
        if writer is not None and is_main():
            writer.log({"epoch": epoch, "train_loss": train_loss, f"val_{metric_key}": val})

        stall += 1
        if val >= best:
            best = val
            stall = 0
            if checkpoints is not None:
                checkpoints.save_if_best(int(state.step), state, val)
        if early_stop and stall >= early_stop:
            log.info("early stop at epoch %d (best %.4f)", epoch, best)
            break
    return state, best
