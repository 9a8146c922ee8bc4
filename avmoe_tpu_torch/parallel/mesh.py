"""Data parallelism over torch.distributed: one process a device.

Counterpart of `avmoe_tpu/parallel/mesh.py`. The JAX package shards each
batch over a 'data' mesh axis and replicates its state; XLA then makes
every reduction over the batch axis a reduction over the global batch. The
port runs one process per device, as `torchrun` launches them, and makes
the same reductions global by hand:

  * `make_mesh` joins the process group named by RANK / WORLD_SIZE /
    LOCAL_RANK (NCCL on the card, gloo on the CPU); without them it returns
    None and everything below is the identity, so one process runs as
    before;
  * `replicate` broadcasts rank 0's parameters and buffers and checks
    that every rank holds them;
  * `global_sum` and `gather_batch` are the differentiable all-reduce and
    all-gather that the train path's batch reductions use: BatchNorm's
    batch statistics, the fused combine's moments of z, the load-balance
    loss's mean gate, the 'mha' expert's attention across the frames and
    the audio mixup's flipped partner;
  * `average_gradients` all-reduces the trainable gradients (their mean
    over the ranks, which is the gradient of the global batch's mean loss
    when the local batches are equal);
  * `gather_ordered` collects each rank's per-batch eval results in the
    global batch order. Evaluation hands whole batches to the ranks in
    turn (`BatchLoader(..., split="batches")`), so every eval batch is the
    batch one process would see and the metrics are one process's.

The batch sharding itself is the loader's: `BatchLoader(process_index=,
process_count=)` collates each rank's contiguous slice of every global
batch, which is what `shard_batch` / `shard_batch_per_host` do.
`expert_sharding` (the JAX package's model-axis layout of the stacked
experts) is not ported.
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import os
from dataclasses import dataclass
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

# gradient all-reduces made by `average_gradients` in this process, so that a
# caller can show that a train step went through the data-parallel path
GRAD_ALLREDUCES = 0


@dataclass(frozen=True)
class Mesh:
    """This process's place in the process group."""
    rank: int
    world_size: int
    device: torch.device
    created: bool      # this call made the group (and `close` ends it)

    def close(self) -> None:
        """End the group if `make_mesh` made it."""
        if self.created:
            shutdown()


def data_parallel() -> bool:
    """True when a process group is up: the batch reductions go global."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if data_parallel() else 1


def rank() -> int:
    return dist.get_rank() if data_parallel() else 0


def is_main() -> bool:
    """Rank 0, the only process that writes: `CheckpointManager.save_if_best`,
    `ExpertUsageTracker.save`, `archive_sources` and `save_mask` do nothing
    on the other ranks."""
    return rank() == 0


def make_mesh(device="cuda") -> Optional[Mesh]:
    """Join the process group that RANK / WORLD_SIZE / LOCAL_RANK (and
    MASTER_ADDR / MASTER_PORT) describe, as torchrun sets them: NCCL where
    `device` is the card, each rank on its LOCAL_RANK-th device; gloo on
    the CPU. Returns None where WORLD_SIZE is not set (one process, no
    group). Idempotent: a group already up is described, not re-made."""
    if "WORLD_SIZE" not in os.environ and not data_parallel():
        return None
    dev = torch.device(device)
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: device 'cuda' asked for and no card is visible")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    created = not data_parallel()
    if created:
        kw = dict(backend=backend, timeout=datetime.timedelta(minutes=10))
        if backend == "nccl":
            kw["device_id"] = dev
        dist.init_process_group(**kw)
    return Mesh(dist.get_rank(), dist.get_world_size(), dev, created)


@contextlib.contextmanager
def launch(device) -> Iterator[Tuple[Optional[Mesh], torch.device]]:
    """A CLI's run scope: yields (the mesh or None, the device to run on)
    and ends the group on exit if it made it. Under a process group the
    device is this rank's and ranks other than 0 log warnings only;
    without one, `device` as `resolve_device` gives it."""
    from avmoe_tpu_torch import resolve_device

    mesh = make_mesh(resolve_device(device))
    if mesh is None:
        yield None, resolve_device(device)
        return
    if mesh.rank != 0:
        logging.getLogger().setLevel(logging.WARNING)
    try:
        yield mesh, mesh.device
    finally:
        mesh.close()


def loader_kw(mesh: Optional[Mesh], split: str = "rows") -> dict:
    """BatchLoader's process arguments for this rank: its slice of every
    batch (split="rows", the train loaders) or every world_size-th whole
    batch (split="batches", the eval loaders); none without a mesh."""
    if mesh is None:
        return {}
    return dict(process_index=mesh.rank, process_count=mesh.world_size, split=split)


def shutdown() -> None:
    """Leave the process group, if one is up."""
    if data_parallel():
        dist.destroy_process_group()


def replicate(module: nn.Module) -> None:
    """Broadcast rank 0's parameters and buffers to every rank, in place,
    then check that all ranks hold the same bytes (a checksum a tensor)."""
    if not data_parallel():
        return
    tensors = list(module.parameters()) + list(module.buffers())
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=0)
        sums = torch.stack([t.detach().double().sum() for t in tensors]) if tensors else None
    if sums is None:
        return
    lo, hi = sums.clone(), sums.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    if not torch.equal(lo, hi):
        bad = int((lo != hi).nonzero()[0])
        raise RuntimeError(f"replicate: tensor {bad} differs across the ranks after the broadcast")


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the gradient of each rank's input is the sum of
    every rank's output gradient (each rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        y = x.detach().clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        g = g.detach().clone()
        dist.all_reduce(g)
        return g


class _AllGather(torch.autograd.Function):
    """Concatenate equal-sized tensors of the ranks along dim 0; the
    gradient of a rank's piece is its slice of the summed output gradients."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        ws, r = dist.get_world_size(), dist.get_rank()
        parts = [torch.empty_like(x) for _ in range(ws)]
        dist.all_gather(parts, x.detach().contiguous())
        ctx.n, ctx.r = x.shape[0], r
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        g = g.detach().clone()
        dist.all_reduce(g)
        return g[ctx.r * ctx.n:(ctx.r + 1) * ctx.n]


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the ranks (differentiable); x itself in one process."""
    return _AllReduceSum.apply(x) if data_parallel() else x


def gather_batch(x: torch.Tensor) -> torch.Tensor:
    """The ranks' equal local batches concatenated along dim 0, in rank
    order: the global batch (differentiable); x itself in one process."""
    return _AllGather.apply(x) if data_parallel() else x


def broadcast_from_main(x: torch.Tensor) -> torch.Tensor:
    """Rank 0's x on every rank (a copy); x itself in one process."""
    if not data_parallel():
        return x
    x = x.clone()
    dist.broadcast(x, src=0)
    return x


def local_slice(x: torch.Tensor, n: int) -> torch.Tensor:
    """This rank's n rows of a gathered (global) tensor."""
    r = rank()
    return x[r * n:(r + 1) * n]


def average_gradients(grads: Sequence[Optional[torch.Tensor]]
                      ) -> List[Optional[torch.Tensor]]:
    """The trainable gradients averaged over the ranks, as one flat
    all-reduce per dtype (a None gradient is a zero one on every rank, and
    stays None). Runs whenever a process group is up, at world size 1 too,
    and counts itself in GRAD_ALLREDUCES."""
    global GRAD_ALLREDUCES
    if not data_parallel():
        return list(grads)
    ws = dist.get_world_size()
    out: List[Optional[torch.Tensor]] = list(grads)
    by_dtype = {}
    for i, g in enumerate(grads):
        if g is not None:
            by_dtype.setdefault(g.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        dist.all_reduce(flat)
        flat = flat / ws
        off = 0
        for i in idx:
            n = grads[i].numel()
            out[i] = flat[off:off + n].view_as(grads[i])
            off += n
    GRAD_ALLREDUCES += 1
    return out


def mean_scalars(metrics: dict) -> dict:
    """The 0-d tensors of `metrics` averaged over the ranks (one
    all-reduce); other entries pass through."""
    if not data_parallel():
        return metrics
    keys = [k for k, v in metrics.items() if torch.is_tensor(v) and v.dim() == 0]
    if not keys:
        return metrics
    stacked = torch.stack([metrics[k].detach().float() for k in keys])
    dist.all_reduce(stacked)
    stacked = stacked / dist.get_world_size()
    return {**metrics, **{k: stacked[i] for i, k in enumerate(keys)}}


def gather_ordered(items: List[Any]) -> List[Any]:
    """Every rank's per-batch results in global batch order, on every rank.
    Rank r holds the results of batches r, r + W, r + 2W, ... (W ranks,
    `BatchLoader(..., split="batches")`), in that order; the items must be
    picklable (numpy arrays, CPU tensors, numbers)."""
    if not data_parallel():
        return items
    parts: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(parts, items)
    out = []
    for i in range(max(len(p) for p in parts)):
        out.extend(p[i] for p in parts if i < len(p))
    return out


def step_seed(seed: int) -> int:
    """The seed of this rank's train-step generator: `seed` on rank 0 (so
    one process draws as before) and seed + rank elsewhere, so that the
    ranks' masks and noise are independent draws."""
    return seed + rank()
