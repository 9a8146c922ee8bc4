"""Multi-process dry run of the data-parallel train and eval paths.

Counterpart of `__graft_entry__.py` `dryrun_multichip`: N tiny train steps
(loss, adapter gradients, Adam, BatchNorm updates) on `world_size`
processes over one global batch, against the same steps in one process at
the same global batch; then an eval pass with expert telemetry, every
batch of the eval set run by one of the ranks and gathered. Sharding is an
implementation detail, not a numerics change. Two float32 trajectories
part after Adam's first, sign-like update, so the free-running loss curve
is held to rtol 1e-5 at its first step and 1e-3 after it (the card at
world size 1 read 1.5e-4 at the third), and each step is also held from
the one process's state before it, as the parity tests hold the port
against JAX: the loss (rtol 1e-5), the BN running statistics (rtol 1e-4,
atol 1e-6), every leaf's gradient, the trainable weights and the eval
telemetry agree with the one process within float32 rounding (the sums
over the batch are taken in another order). A gradient is held per leaf,
each element within 2e-2 of that leaf's own largest entry plus 2e-5 of
the largest entry of any leaf: the second term is the rounding floor (a
leaf whose exact gradient is zero, an attention key bias, keeps noise at
1e-8 of the largest), the first the conditioning of the tiny models at
this init (the AVVP model's live leaves part by up to 1.4e-2 of their
own largest, the AVE model's by 4e-3; the largest are one-element gates,
sums with cancellation). Each live leaf, of two or more elements and with
a largest entry of at least 1e-4 of the largest of any leaf, is also held
as a whole: its cosine with the one process's gradient is at least 0.9999
(the card's gradient gates; the CPU runs read 1 - 2.4e-5 at worst, AVVP's
router). The weights are held within rtol
1e-4 / atol 1e-6 plus 0.1 lr where the element's reference gradient
exceeds that bound; elsewhere the gradient's sign is not resolved and
Adam, which moves a weight by about lr whatever its gradient's size, may
part them by up to 2 lr.

The random draws are turned off as the parity tests turn them off
(AVMOE_DETERMINISTIC_TRAIN=1: dropout and SpecAugment; AVVP's Gumbel noise
zero and its DropPath rate 0); the mixup weights are drawn, one draw over
the global batch (`audio/frontend.py` `get_mix_lambda`), and the audio
mixup pairs rows across the ranks. Each process runs torch on one thread.

    python -m avmoe_tpu_torch.parallel.dryrun --world_size 2 --device cpu
    python -m avmoe_tpu_torch.parallel.dryrun --world_size 1 --device cuda   # NCCL

`spawn` runs any function, a CLI's `main` for one, under a process group.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import pickle
import socket
import tempfile
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

KINDS = ("ave", "avvp")
DEPTHS = (2, 2, 2, 2)
GLOBAL_BATCH = 4
EVAL_BATCHES = 3          # an odd count: the ranks run uneven numbers of batches
LOSS_RTOL = 1e-5
CURVE_RTOL = 1e-3
STATE_TOL = dict(rtol=1e-4, atol=1e-6)
# a gradient element: rtol of its leaf's largest entry + atol of the largest of any leaf
GRAD_TOL = dict(rtol=2e-2, atol=2e-5)
WEIGHT_LR = 0.1           # lr multiple added to STATE_TOL on the weights
# a live leaf (2+ elements, largest entry >= LIVE of the largest of any leaf):
# its gradient's cosine with the one process's
LIVE = 1e-4
GRAD_COS = 0.9999


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def single_rank_env():
    """RANK / WORLD_SIZE / LOCAL_RANK / MASTER_ADDR / MASTER_PORT of a
    one-rank process group, as torchrun sets them, inside the block (the
    old values back after it): code that calls `make_mesh` there makes a
    group of world size 1 in this process."""
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(free_port())}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _worker(rank: int, world_size: int, port: int, fn: Callable, args: tuple,
            out_dir: str, env: Dict[str, str]) -> None:
    os.environ.update(env)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world_size),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    result = fn(*args)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn(fn: Callable, world_size: int, *args, env: Optional[Dict[str, str]] = None
          ) -> List:
    """fn(*args) in `world_size` fresh processes, each with RANK / WORLD_SIZE /
    LOCAL_RANK / MASTER_ADDR / MASTER_PORT set as torchrun sets them (and
    `env`), torch on one thread; returns every rank's result. fn must be a
    module-level function (the processes are spawned) that makes its own
    process group (`parallel/mesh.py` `make_mesh`)."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as out_dir:
        mp.start_processes(_worker, args=(world_size, free_port(), fn, args, out_dir,
                                          dict(env or {})),
                           nprocs=world_size, start_method="spawn", join=True)
        results = []
        for r in range(world_size):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


def _cut(cfg):
    return dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin, depths=DEPTHS),
                               htsat=dataclasses.replace(cfg.htsat, depths=DEPTHS))


def _kit(kind: str, device, fused: bool):
    """(model, loss closure, train dataset, eval dataset, eval forward)."""
    from avmoe_tpu_torch.config import tiny_ave_config, tiny_avvp_config

    fused_kw = dict(fused_moe=fused, fused_moe_train=fused)
    if kind == "ave":
        from avmoe_tpu_torch.data.ave import SyntheticAVEDataset
        from avmoe_tpu_torch.models.ave import AVEModel, make_ave_loss_fn

        cfg = _cut(tiny_ave_config())
        geo = dict(num_segments=cfg.num_segments, audio_len=cfg.audio_len,
                   img_size=cfg.swin.img_size, num_classes=cfg.num_classes)
        model = AVEModel(cfg, device=device, seed=0, **fused_kw)
        data = lambda n, seed: SyntheticAVEDataset(length=n, seed=seed, **geo)
        loss_fn = make_ave_loss_fn(model)
        forward = lambda b: model(b["wave"], b["images"])
    elif kind == "avvp":
        from avmoe_tpu_torch.data.avvp import SyntheticAVVPDataset
        from avmoe_tpu_torch.heads import grouping
        from avmoe_tpu_torch.models.avvp import MGNModel, make_avvp_loss_fn

        cfg = _cut(tiny_avvp_config())
        geo = dict(num_segments=cfg.num_segments, audio_len=cfg.audio_len,
                   img_size=cfg.swin.img_size, st_dim=cfg.st_dim)
        model = MGNModel(cfg, device=device, seed=0, **fused_kw)
        for m in model.modules():
            if isinstance(m, grouping.AttnBlock):
                m.drop_path = 0.0
        data = lambda n, seed: SyntheticAVVPDataset(length=n, seed=seed, **geo)
        loss_fn = make_avvp_loss_fn(model)
        forward = lambda b: model(b["wave"], b["images"], b["video_st"])
    else:
        raise ValueError(f"kind={kind!r}, want one of {KINDS}")
    # the init's adapter gates are zero, which would leave every expert's
    # gradient zero: seeded noise around 0.5 makes them all live
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith(("gate", "gate_av", "gate_self")):
                p.copy_(0.5 + 0.2 * torch.randn(p.shape, generator=gen))
    return model, loss_fn, data(GLOBAL_BATCH * 8, 0), data(GLOBAL_BATCH * EVAL_BATCHES, 1), \
        forward


@contextlib.contextmanager
def _draws_off():
    """Inside the block: AVMOE_DETERMINISTIC_TRAIN=1 (dropout, SpecAugment
    off) and AVVP's Gumbel noise zero; both restored after it."""
    from avmoe_tpu_torch.heads import grouping

    old_env, old_noise = os.environ.get("AVMOE_DETERMINISTIC_TRAIN"), grouping.gumbel_noise
    os.environ["AVMOE_DETERMINISTIC_TRAIN"] = "1"
    grouping.gumbel_noise = lambda shape, generator, dev, dtype: torch.zeros(
        shape, device=dev, dtype=dtype)
    try:
        yield
    finally:
        grouping.gumbel_noise = old_noise
        if old_env is None:
            os.environ.pop("AVMOE_DETERMINISTIC_TRAIN", None)
        else:
            os.environ["AVMOE_DETERMINISTIC_TRAIN"] = old_env


def _record_gradients(state) -> List:
    """Make `state.apply_gradients` keep, in the returned list, a host copy
    of the gradients it is handed (after the data-parallel average), so
    that a step's gradients can be compared leaf by leaf."""
    seen: List = []
    apply = state.apply_gradients

    def recording(grads):
        seen[:] = [None if g is None else g.detach().cpu().numpy().copy() for g in grads]
        apply(grads)

    state.apply_gradients = recording
    return seen


def _snapshot(state, loss: float, grads: List) -> Dict:
    """A step's loss and gradients, and the BN running statistics and the
    trainable weights after it, on the host."""
    with torch.no_grad():
        return dict(
            loss=loss,
            grads={n: g for n, g in zip(state.trainable, grads) if g is not None},
            stats={n: b.cpu().numpy().copy() for n, b in state.batch_stats.items()},
            weights={n: p.detach().cpu().numpy().copy() for n, p in state.trainable.items()},
            lr=max(g["lr"] for g in state.optimizer.param_groups))


def session(kind: str = "ave", steps: int = 3, device: str = "cpu", fused: bool = False,
            save_dir: Optional[str] = None, held_dir: Optional[str] = None) -> Dict:
    """One process's run: under a process group if WORLD_SIZE is set (its
    rank's slice of each global batch), else alone on the whole batch.

    Counts the gradient all-reduces it made (`GRAD_ALLREDUCES` is the
    process's). `steps` free-running train steps give the loss curve; with `save_dir`
    the state before and after each step is saved there (the reference).
    With `held_dir`, each step k is then taken again from the state saved
    there after step k - 1 (the reference's), so that a step's results
    compare with the reference's same step from the same state. The eval
    pass runs on the last held state (or the free run's). Returns the curve,
    the per-step snapshots (held, or the free run's), the eval telemetry
    summary and the gradient all-reduces made."""
    from avmoe_tpu_torch.parallel import mesh as pm

    with pm.launch(device) as (mesh, dev), _draws_off():
        return _session(kind, steps, fused, save_dir, held_dir, mesh, dev)


def _session(kind, steps, fused, save_dir, held_dir, mesh, dev) -> Dict:
    from avmoe_tpu_torch.checkpoint.manager import CheckpointManager
    from avmoe_tpu_torch.config import TrainConfig
    from avmoe_tpu_torch.data.loader import BatchLoader
    from avmoe_tpu_torch.parallel import mesh as pm
    from avmoe_tpu_torch.telemetry.experts import ExpertUsageTracker
    from avmoe_tpu_torch.train.loop import step_generator
    from avmoe_tpu_torch.train.state import create_train_state
    from avmoe_tpu_torch.train.steps import make_train_step

    reduces = pm.GRAD_ALLREDUCES
    model, loss_fn, train_ds, eval_ds, forward = _kit(kind, dev, fused)
    pm.replicate(model)
    loader = BatchLoader(train_ds, GLOBAL_BATCH, num_workers=1, device=dev,
                         **pm.loader_kw(mesh))
    batches = [b for _, b in zip(range(steps), loader)]
    state = create_train_state(model, TrainConfig(batch_size=GLOBAL_BATCH, accum_steps=1),
                               steps_per_epoch=len(loader))
    train_step = make_train_step(loss_fn)
    grads = _record_gradients(state)
    save = CheckpointManager(save_dir, max_to_keep=steps + 1) if save_dir else None
    if save:
        save.save(0, state)
    generator = step_generator(0, dev)
    curve, snaps = [], []
    for k, batch in enumerate(batches, start=1):
        state, metrics = train_step(state, batch, generator)
        curve.append(float(metrics["loss"]))
        snaps.append(_snapshot(state, curve[-1], grads))
        if save:
            save.save(k, state)
    if held_dir:
        held, snaps = CheckpointManager(held_dir), []
        # the free run's draws again (λ is the only draw of a step here)
        generator = step_generator(0, dev)
        for k, batch in enumerate(batches, start=1):
            held.restore(state, step=k - 1)
            state, metrics = train_step(state, batch, generator)
            snaps.append(_snapshot(state, float(metrics["loss"]), grads))
        held.restore(state, step=steps)
    eval_loader = BatchLoader(eval_ds, GLOBAL_BATCH, drop_last=False, num_workers=1,
                              device=dev, **pm.loader_kw(mesh, "batches"))
    records = []
    with torch.no_grad():
        for batch in eval_loader:
            records.append(ExpertUsageTracker.to_host(forward(batch)["telemetry"]))
    tracker = ExpertUsageTracker(model.cfg.moe.num_experts)
    for stacks in pm.gather_ordered(records):
        tracker.add(stacks)
    return dict(curve=curve, steps=snaps, telemetry=tracker.summary(),
                world_size=pm.world_size(), grad_allreduces=pm.GRAD_ALLREDUCES - reduces,
                eval_batches=len(records))


def compare(dp: Dict, ref: Dict) -> Dict[str, float]:
    """Raise unless a data-parallel session matches the one-process one
    (the free-running loss curve, each held step, the eval telemetry);
    returns the largest differences (of the gradients and weights, as a
    share of their bound)."""
    # the first loss comes from the same state; after it the free-running
    # trajectories part with Adam's sign-like updates of rounding-level
    # gradients, so the curve is held to CURVE_RTOL and each step, from the
    # same state, below
    np.testing.assert_allclose(dp["curve"][0], ref["curve"][0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(dp["curve"], ref["curve"], rtol=CURVE_RTOL)
    worst = {"curve": float(np.max(np.abs(np.subtract(dp["curve"], ref["curve"])))),
             "stats": 0.0, "grads": 0.0, "cos": 1.0, "weights": 0.0}
    for k, (a, b) in enumerate(zip(dp["steps"], ref["steps"]), start=1):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=LOSS_RTOL, err_msg=f"step {k}")
        for key in ("stats", "grads", "weights"):
            assert a[key].keys() == b[key].keys(), (k, key)
        for n, r in b["stats"].items():
            np.testing.assert_allclose(a["stats"][n], r, err_msg=f"step {k} {n}", **STATE_TOL)
            worst["stats"] = max(worst["stats"], float(np.abs(a["stats"][n] - r).max()))
        top = max(float(np.abs(g).max()) for g in b["grads"].values())
        for n, g in b["grads"].items():
            bound = GRAD_TOL["rtol"] * float(np.abs(g).max()) + GRAD_TOL["atol"] * top
            share = float(np.abs(a["grads"][n] - g).max()) / bound
            assert share <= 1.0, (k, "grads", n, share)
            if g.size > 1 and np.abs(g).max() >= LIVE * top:
                x, y = a["grads"][n].ravel().astype(np.float64), g.ravel().astype(np.float64)
                cos = float(x @ y / (np.linalg.norm(x) * np.linalg.norm(y)))
                assert cos >= GRAD_COS, (k, "grads cosine", n, cos)
                worst["cos"] = min(worst["cos"], cos)
            # where the gradient is resolved, the same Adam update
            live = np.abs(g) > bound
            w = b["weights"][n][live]
            diff = np.abs(a["weights"][n][live] - w)
            wbound = STATE_TOL["atol"] + STATE_TOL["rtol"] * np.abs(w) + WEIGHT_LR * b["lr"]
            wshare = float((diff / wbound).max()) if live.any() else 0.0
            assert wshare <= 1.0, (k, "weights", n, wshare)
            worst["grads"] = max(worst["grads"], share)
            worst["weights"] = max(worst["weights"], wshare)
    assert dp["telemetry"].keys() == ref["telemetry"].keys()
    worst["telemetry"] = 0.0
    for site, stats in ref["telemetry"].items():
        np.testing.assert_array_equal(dp["telemetry"][site]["activation_counts"],
                                      stats["activation_counts"])
        np.testing.assert_allclose(dp["telemetry"][site]["mean_gating_probs"],
                                   stats["mean_gating_probs"], **STATE_TOL)
        worst["telemetry"] = max(worst["telemetry"], float(np.abs(
            dp["telemetry"][site]["mean_gating_probs"] - stats["mean_gating_probs"]).max()))
    return worst


def held_sessions(kinds: Sequence[str], steps: int, device: str, fused: bool,
                  held_dirs: Dict[str, str]) -> Dict[str, Dict]:
    """`session` of each kind under one process group (made here from the
    environment, or the one already up), each held from the states saved
    under held_dirs[kind]."""
    from avmoe_tpu_torch.parallel import mesh as pm

    with pm.launch(device):
        return {k: session(k, steps, device, fused, None, held_dirs[k]) for k in kinds}


def dryrun(world_size: int = 2, kinds: Sequence[str] = ("ave",), steps: int = 3,
           device: str = "cpu", fused: bool = False) -> Dict[str, Dict]:
    """`session` of each kind alone in this process (which must have no
    process group), saving its states, then every kind in one spawn of
    `world_size` processes (world size 1: a group of one in this process),
    holding each step from those states; raises on a mismatch. Returns, per
    kind, the ranks' results, the reference and the largest differences."""
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {k: os.path.join(tmp, k) for k in kinds}
        refs = {k: session(k, steps, device, fused, save_dir=dirs[k]) for k in kinds}
        if world_size == 1:   # no process to spawn: a group of one in this process
            with single_rank_env():
                ranks = [held_sessions(kinds, steps, device, fused, dirs)]
        else:
            ranks = spawn(held_sessions, world_size, kinds, steps, device, fused, dirs)
    return {k: dict(ranks=[r[k] for r in ranks], reference=refs[k],
                    worst=check_ranks([r[k] for r in ranks], refs[k], steps))
            for k in kinds}


def check_ranks(ranks: List[Dict], ref: Dict, steps: int) -> Dict[str, float]:
    """Raise unless the ranks hold the same weights, each made one gradient
    all-reduce a step (free and held) and rank 0 matches the one process
    (`compare`); returns the largest differences."""
    for r in ranks[1:]:
        for a, b in zip(r["steps"], ranks[0]["steps"]):
            for n, w in b["weights"].items():
                np.testing.assert_array_equal(a["weights"][n], w, err_msg=n)
    assert all(r["grad_allreduces"] == 2 * steps for r in ranks)
    return compare(ranks[0], ref)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--world_size", type=int, default=2)
    p.add_argument("--kind", choices=KINDS, nargs="+", default=["ave"])
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--device", default="cuda")
    p.add_argument("--fused", action="store_true", help="both fused-combine switches on")
    args = p.parse_args(argv)
    for kind, out in dryrun(args.world_size, args.kind, args.steps, args.device,
                            args.fused).items():
        print(f"dryrun({args.world_size}, {kind}): losses {out['ranks'][0]['curve']} "
              f"one process {out['reference']['curve']} largest differences {out['worst']}")


if __name__ == "__main__":
    main()
