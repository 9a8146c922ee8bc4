"""Data parallelism over torch.distributed: two gloo processes on the CPU
against one process at the same global batch.

These hold the port's data-parallel runs against the port's one-process
runs. Those one-process runs are held against JAX by the existing model,
train-curve and CLI tests; JAX's own multi-device curve
(`tests/test_multidevice.py`) costs the suite minutes, so no JAX runs here.
Each spawned process runs torch on one thread (`parallel/dryrun.py` `spawn`).

Every two-rank run of the file is made in one spawn of two processes
sharing one process group (the `runs` fixture), and the one-process runs
in this process beside it.

  * The dry run (`parallel/dryrun.py`): 3 tiny AVE train steps (backbones
    at depths 2-2-2-2, noised adapter gates, mixup λ drawn over the global
    batch) on two ranks of two clips each: the free-running loss curve
    (rtol 1e-5 at the first step, 1e-3 after it: the trajectories part after
    Adam's sign-like first update), and each step held from the one
    process's state before it: the loss (rtol 1e-5), the BN running
    statistics (rtol 1e-4, atol 1e-6), every leaf's gradient (2e-2 of the
    leaf's largest entry plus 2e-5 of the largest of any leaf; each live
    leaf's cosine at least 0.9999), the weights where their gradient exceeds that bound (rtol 1e-4 / atol 1e-6
    plus 0.1 lr), and the expert telemetry of an eval pass of 3 batches
    over the two ranks. The same for tiny AVVP (load-balance loss on).
  * One adapter of every global reduction ('mha' expert across the frames,
    bn1 / bn2 batch statistics, the fused moments, the load-balance mean
    gate), on each route: the ranks' outputs and running statistics against
    one process's
    (rtol 1e-5, atol 1e-6), the gradients within rtol 1e-5 and 1e-5 of
    the largest gradient entry (sums over the batch).
  * The AVE CLI at --tiny --synthetic, one epoch, at world size 2 against
    one process: the same best.json metric, the same expert routing counts
    and mean gates within 1e-3 (two free-running float32 trajectories, 8
    Adam updates on), one checkpoint written, by rank 0.
  * The loader's eval split and `gather_ordered`'s batch order.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from avmoe_tpu_torch.parallel import dryrun

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)
KINDS = ("ave", "avvp")
STEPS = 3
CLI_ARGV = ["--tiny", "--synthetic", "--device", "cpu", "--no-bf16", "--epochs", "1",
            "--batch_size", "2", "--accum_itr", "1", "--num_workers", "1"]


def _adapter_run():
    """One train forward / backward of a stacked-expert adapter with every
    global reduction on, on this process's rows of an 4-frame batch, on
    the materialized (False) and the fused (True) route."""
    from avmoe_tpu_torch.config import AdapterConfig, MoEConfig
    from avmoe_tpu_torch.moe.adapter import MoEAdapter
    from avmoe_tpu_torch.parallel import mesh as pm

    cfg = MoEConfig(num_multimodal_experts=1, num_singlemodal_experts=2,
                    load_balance_loss=True,
                    adapter=AdapterConfig(downsample=4, num_conv_group=2, num_tokens=4,
                                          self_attention="mha"))
    results = {}
    for fused in (False, True):
        torch.manual_seed(0)
        m = MoEAdapter(32, 48, 24, 16, cfg, fused_moe_train=fused)
        with torch.no_grad():
            for n, p in m.named_parameters():
                p.copy_(0.5 + 0.2 * torch.randn(p.shape) if n.endswith("gate")
                        else 0.2 * torch.randn(p.shape))
        rng = np.random.RandomState(1)
        x = torch.from_numpy(rng.randn(4, 24, 32).astype(np.float32))
        other = torch.from_numpy(rng.randn(4, 16, 48).astype(np.float32))
        n = 4 // pm.world_size()
        lo = pm.rank() * n
        y, aux = m(x[lo:lo + n], other[lo:lo + n], train=True)
        w = torch.linspace(-1.0, 1.0, 4 * 24 * 32).reshape(4, 24, 32)[lo:lo + n]
        # the mean over the global batch of a weighted readout, plus the
        # load-balance loss: each rank's part of it, then the mean
        loss = (y * w).sum() / 4 * pm.world_size() + aux["lb_loss"]
        grads = torch.autograd.grad(loss, list(m.parameters()))
        grads = pm.average_gradients(grads)
        results[fused] = dict(
            y=y.detach().numpy(), lb=float(aux["lb_loss"].detach()),
            grads={k: g.numpy() for (k, _), g in zip(m.named_parameters(), grads)},
            stats={k: b.numpy().copy() for k, b in m.named_buffers()})
    return results


def _cli(save_dir):
    """The AVE CLI's best metric and the gradient all-reduces it made."""
    from avmoe_tpu_torch.cli import train_ave
    from avmoe_tpu_torch.parallel import mesh as pm

    before = pm.GRAD_ALLREDUCES
    best = train_ave.main(CLI_ARGV + ["--model_save_dir", save_dir])
    return best, pm.GRAD_ALLREDUCES - before


def _rank(held_dirs, cli_dir):
    """A rank's share of every run of the file, under one process group."""
    from avmoe_tpu_torch.parallel import mesh as pm

    with pm.launch("cpu"):
        out = dryrun.held_sessions(KINDS, STEPS, "cpu", False, held_dirs)
        out["adapter"] = _adapter_run()
        out["cli"] = _cli(cli_dir)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(directory, the one-process runs, the two ranks' runs)."""
    tmp = tmp_path_factory.mktemp("dp")
    dirs = {k: str(tmp / k) for k in KINDS}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AVMOE_DETERMINISTIC_TRAIN", "1")
        one = {k: dryrun.session(k, STEPS, "cpu", False, save_dir=dirs[k]) for k in KINDS}
        one["adapter"] = _adapter_run()
        one["cli"] = _cli(str(tmp / "one"))
    ranks = dryrun.spawn(_rank, 2, dirs, str(tmp / "dp"),
                         env={"AVMOE_DETERMINISTIC_TRAIN": "1"})
    return tmp, one, ranks


@pytest.mark.parametrize("kind", KINDS)
def test_dryrun_matches_one_process(runs, kind):
    _, one, ranks = runs
    dp = [r[kind] for r in ranks]
    dryrun.check_ranks(dp, one[kind], STEPS)
    assert [r["world_size"] for r in dp] == [2, 2]
    # the eval set's 3 batches went to the ranks in turn: 2 and 1
    assert [r["eval_batches"] for r in dp] == [2, 1]
    assert one[kind]["eval_batches"] == 3


@pytest.mark.parametrize("fused", [False, True], ids=["materialized", "fused"])
def test_adapter_global_reductions_match_one_process(runs, fused):
    _, one, ranks = runs
    ref = one["adapter"][fused]
    ys = np.concatenate([r["adapter"][fused]["y"] for r in ranks])
    np.testing.assert_allclose(ys, ref["y"], **TOL)
    # a gradient is a sum over the batch: its rounding is relative to the
    # largest gradient (a leaf whose exact gradient is zero keeps noise)
    top = max(np.abs(g).max() for g in ref["grads"].values())
    for r in ranks:
        got = r["adapter"][fused]
        np.testing.assert_allclose(got["lb"], ref["lb"], **TOL)
        for k, g in ref["grads"].items():
            np.testing.assert_allclose(got["grads"][k], g, err_msg=k, rtol=1e-5,
                                       atol=1e-5 * top)
        for k, b in ref["stats"].items():
            np.testing.assert_allclose(got["stats"][k], b, err_msg=k, **TOL)
    if fused:
        # the fused route's statistics and gradients are the materialized one's
        for k, g in one["adapter"][False]["grads"].items():
            np.testing.assert_allclose(ref["grads"][k], g, rtol=2e-4, atol=2e-5, err_msg=k)


def test_ave_cli_at_world_size_2_matches_one_process(runs):
    tmp, one, ranks = runs
    dp_dir, one_dir = tmp / "dp", tmp / "one"
    best = one["cli"][0]
    # the synthetic train set is 8 global batches of 2: 8 steps, each rank one clip
    assert [r["cli"][1] for r in ranks] == [8, 8]
    assert [r["cli"][0] for r in ranks] == [best, best]
    assert json.loads((dp_dir / "best.json").read_text()) == json.loads(
        (one_dir / "best.json").read_text())
    assert sorted(os.listdir(dp_dir / "8")) == ["metrics.json", "state.pt"]
    assert [d for d in os.listdir(dp_dir) if not d.endswith((".json", ".npy"))] == ["8"]
    stats = sorted(f for f in os.listdir(one_dir) if f.endswith(".npy"))
    assert stats and stats == sorted(f for f in os.listdir(dp_dir) if f.endswith(".npy"))
    for f in stats:
        # the routing counts exactly; the mean gates of two free-running
        # float32 trajectories, 8 Adam updates on, within 1e-3
        tol = dict(rtol=0, atol=0) if "counts" in f else dict(rtol=0, atol=1e-3)
        np.testing.assert_allclose(np.load(dp_dir / f), np.load(one_dir / f), err_msg=f, **tol)


def test_eval_split_and_gather_order():
    from avmoe_tpu_torch.data.loader import BatchLoader
    from avmoe_tpu_torch.parallel.mesh import gather_ordered

    class Rows:
        def __len__(self):
            return 7

        def __getitem__(self, i):
            return {"i": np.asarray(i)}

    kw = dict(batch_size=2, drop_last=False, num_workers=1, split="batches", process_count=3)
    seen = [[b["i"].tolist() for b in BatchLoader(Rows(), process_index=r, **kw)]
            for r in range(3)]
    assert seen == [[[0, 1], [6]], [[2, 3]], [[4, 5]]]
    assert [len(BatchLoader(Rows(), process_index=r, **kw)) for r in range(3)] == [2, 1, 1]
    # without a process group the list is returned as it is
    assert gather_ordered(seen[0]) == seen[0]
    with pytest.raises(ValueError):
        BatchLoader(Rows(), 2, drop_last=False, process_count=2)
