"""The port's AVS MS3 train step against the JAX package's, on the CPU.

The tiny AVS config in its MS3 form (the 'token' unimodal expert, gamma
0.1, the KL masked audio-visual loss at lambda 0.5 over all four stages, the
load-balance loss at 0.01), both backbones cut to depths 1-1-1-1 (4 adapter
sites: the JAX step over the ~1700 trainable leaves of depths 2-2-2-2 takes
over twice as long to trace and compile), 80-px frames and the pyramid at
(24, 12, 6, 3) as in `tests/test_torch_avs.py`, float32, the same seeded
weights (non-zero gates, gate_self and W_z_bn scales) and the same three
batches:
`make_train_step` with `make_avs_loss_fn` against the JAX package's jitted
`make_train_step(make_avs_loss_fn(model))` + `create_train_state`, both
backbones frozen, lr_mlp = lr. The random draws are handed in:
AVMOE_DETERMINISTIC_TRAIN=1 on both sides (dropout, SpecAugment), the mixup
λ in the batch, and the router noise given (the JAX package's
`jax.random.normal` and the port's `moe/adapter.py` `router_noise` return
the same (B', E) noise at every site). AVMOE_FUSED_MOE_TRAIN unset.

As `tests/test_torch_avqa_train.py`, two comparisons: the loss curve
free-running, and every step from JAX's state before it (parameters, batch
stats, Adam's moments), since two float32 trajectories part after Adam's
sign-like first step. Tolerances as there: losses rtol 5e-3; the trainable
parameters after a step within 1e-6 + 2e-3 |ref| for all but a 1e-3 share
of the elements, the update cosine >= 0.999 (>= 0.98 per live leaf), the
Adam first moments' cosine >= 0.995 per live leaf; the running stats
(HTS-AT's bn0 and TPAVI's W_z_bn) after each step rtol 2e-3, atol 1e-4.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from torch_port_harness import FWD_TOL, port_variables, to_jax
from torch_train_harness import (LIVE, adam_moment, cos, flat, live, load_jax_state, outside,
                                 port_mu)

from avmoe_tpu_torch.convert import export_jax_variables, load_jax_variables

torch.set_num_threads(2)

STEPS = 3
LR = 2e-4
SWIN_DEPTHS = HTSAT_DEPTHS = (1, 1, 1, 1)
FRAME = 80


def _ms3(cfg):
    """The MS3 recipe as the JAX CLI's build_config sets it."""
    return dataclasses.replace(
        cfg, setting="ms3", temporal_gamma=0.1, lb_loss_weight=0.01, sa_loss_flag=True,
        lambda_1=0.5, sa_loss_kind="kl", sa_norm_fea=False, sa_threshold=False,
        sa_loss_stages=(0, 1, 2, 3), pyramid_sizes=(24, 12, 6, 3), mask_size=96,
        swin=dataclasses.replace(cfg.swin, depths=SWIN_DEPTHS),
        htsat=dataclasses.replace(cfg.htsat, depths=HTSAT_DEPTHS),
        moe=dataclasses.replace(cfg.moe, adapter=dataclasses.replace(
            cfg.moe.adapter, self_attention="token")))


def _batches(cfg, seed=0):
    rng = np.random.RandomState(seed)
    B, T = 2, cfg.num_segments
    return [dict(
        images=rng.rand(B, T, FRAME, FRAME, 3).astype(np.float32),
        wave=rng.randn(B, T, cfg.audio_len).astype(np.float32) * 0.1,
        mask=(rng.rand(B, T, 96, 96) > 0.6).astype(np.float32),
        mixup_lambda=rng.uniform(0.3, 0.7, size=B * T).astype(np.float32))
        for _ in range(STEPS)]


@pytest.fixture(scope="module")
def curves():
    from avmoe_tpu import config as jc
    from avmoe_tpu.models.avs import AVSModel as JAVS, make_avs_loss_fn as j_loss_fn
    from avmoe_tpu.train.freeze import param_report as j_param_report
    from avmoe_tpu.train.state import create_train_state as j_create_state
    from avmoe_tpu.train.steps import make_train_step as j_make_step

    import avmoe_tpu_torch.moe.adapter as adapter
    from avmoe_tpu_torch import config as pc
    from avmoe_tpu_torch.models.avs import AVSModel, make_avs_loss_fn
    from avmoe_tpu_torch.train.freeze import param_report
    from avmoe_tpu_torch.train.state import create_train_state
    from avmoe_tpu_torch.train.steps import make_train_step

    jcfg = _ms3(jc.tiny_avs_config())
    batches = _batches(jcfg)
    noise = np.random.RandomState(9).randn(2 * jcfg.num_segments, 2).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AVMOE_DETERMINISTIC_TRAIN", "1")
        mp.delenv("AVMOE_FUSED_MOE_TRAIN", raising=False)
        jm = JAVS(jcfg)
        pm = AVSModel(_ms3(pc.tiny_avs_config()), device="cpu", seed=None)
        variables = port_variables(pm, seed=3)     # the tree test_torch_avs.py holds equal
        tcfg = dict(accum_steps=1, lr=LR, lr_mlp=LR, decay=0.5, decay_epoch=1)
        jstate = j_create_state(jm, to_jax(variables), jc.TrainConfig(**tcfg),
                                steps_per_epoch=2, frozen_scopes=("swin", "htsat"))
        jstep = j_make_step(j_loss_fn(jm), donate=False)
        mp.setattr(jax.random, "normal", lambda key, shape, *a, **k: jnp.asarray(noise))
        jstates, j_losses, j_aux = [jstate], [], []
        for i, b in enumerate(batches):
            jstate, met = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                                jax.random.PRNGKey(i))
            jstates.append(jstate)
            j_losses.append(float(met["loss"]))
            j_aux.append({k: float(v) for k, v in met.items()})
        jax.block_until_ready(jstate.trainable)

        mp.setattr(adapter, "router_noise",
                   lambda shape, generator, device: torch.from_numpy(noise).to(device))
        load_jax_variables(pm, variables)
        report = (param_report(pm), j_param_report(variables["params"]))
        state = create_train_state(pm, pc.TrainConfig(**tcfg), steps_per_epoch=2)
        step = make_train_step(make_avs_loss_fn(pm))
        tbatches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
        gen = torch.Generator().manual_seed(0)
        losses, aux = [], []
        for b in tbatches:                       # free-running: the loss curve
            state, met = step(state, b, gen)
            losses.append(float(met["loss"]))
            aux.append({k: float(v) for k, v in met.items()})
        updates = state.updates
        steps = []                               # each step from JAX's state before it
        for i, b in enumerate(tbatches):
            load_jax_state(pm, state, jstates[i], i)
            state, met = step(state, b, gen)
            before, after = jstates[i], jstates[i + 1]
            steps.append(dict(
                loss=float(met["loss"]), j_loss=j_losses[i],
                start=flat(jax.tree_util.tree_map(np.asarray, before.trainable)),
                params=flat(export_jax_variables(pm, trainable_only=True)["params"]),
                j_params=flat(jax.tree_util.tree_map(np.asarray, after.trainable)),
                stats=flat(export_jax_variables(pm)["batch_stats"]),
                j_stats=flat(jax.tree_util.tree_map(np.asarray, after.batch_stats)),
                mu=port_mu(pm, state), j_mu=adam_moment(after.opt_state, "mu")))
    return dict(losses=np.array(losses), j_losses=np.array(j_losses), aux=aux, j_aux=j_aux,
                steps=steps, report=report, updates=updates, model=pm)


def test_avs_ms3_loss_curve_matches_jax(curves):
    np.testing.assert_allclose(curves["losses"], curves["j_losses"], rtol=5e-3)
    assert curves["updates"] == STEPS
    assert abs(curves["losses"][-1] - curves["losses"][0]) > 1e-3
    # each term: the IoU-BCE, the masked audio-visual KL and the LB loss
    for ours, ref in zip(curves["aux"], curves["j_aux"]):
        assert set(ours) == set(ref) == {"loss", "iou_loss", "sa_loss", "loss_lb"}
        for k in ref:
            assert ours[k] == pytest.approx(ref[k], rel=5e-3), k
    np.testing.assert_allclose([s["loss"] for s in curves["steps"]], curves["j_losses"],
                               rtol=5e-3)


@pytest.mark.parametrize("i", range(1, STEPS))
def test_avs_ms3_trainable_params_after_the_steps_match_jax(curves, i):
    s = curves["steps"][i]
    ours, ref, start = s["params"], s["j_params"], s["start"]
    assert set(ours) == set(ref) and len(ref) > 100
    out = np.concatenate([outside(ours[k], ref[k]).ravel() for k in ref])
    assert np.mean(out) <= 1e-3
    upd = np.concatenate([(ours[k] - start[k]).ravel() for k in ref])
    upd_ref = np.concatenate([(ref[k] - start[k]).ravel() for k in ref])
    assert cos(upd, upd_ref) >= 0.999
    for k in ref:
        assert np.abs(ref[k] - start[k]).max() > 0, k
        assert np.abs(ours[k] - start[k]).max() > 0, k


@pytest.mark.parametrize("i", range(1, STEPS))
def test_avs_ms3_each_live_leaf_update_matches_jax(curves, i):
    s = curves["steps"][i]
    ours, ref, start = s["params"], s["j_params"], s["start"]
    alive, _ = live(s["j_mu"])
    assert len(alive) > 0.9 * len(ref)
    share = {k: np.mean(outside(ours[k], ref[k])) for k in alive}
    assert all(v <= 1e-3 for v in share.values()), max(share.items(), key=lambda kv: kv[1])
    c = {k: cos(ours[k] - start[k], ref[k] - start[k]) for k in alive}
    assert all(v >= 0.98 for v in c.values()), min(c.items(), key=lambda kv: kv[1])


@pytest.mark.parametrize("i", range(STEPS))
def test_avs_ms3_each_trainable_leaf_gradient_matches_jax(curves, i):
    s = curves["steps"][i]
    ours, ref = s["mu"], s["j_mu"]
    assert set(ours) == set(ref) == set(s["j_params"])
    alive, top = live(ref)
    c = {k: cos(ours[k], ref[k]) for k in alive}
    assert all(v >= 0.995 for v in c.values()), min(c.items(), key=lambda kv: kv[1])
    for k in set(ref) - alive:
        assert np.sqrt(np.mean(ours[k] ** 2)) <= LIVE * top, k


@pytest.mark.parametrize("i", range(STEPS))
def test_avs_ms3_running_stats_after_each_step_match_jax(curves, i):
    """HTS-AT's bn0 and TPAVI's W_z_bn update their running stats in train,
    as flax does (momentum 0.9 on the batch stats)."""
    s = curves["steps"][i]
    assert set(s["stats"]) == set(s["j_stats"])
    assert {p[0] for p in s["stats"]} == {"encoder", "tpavi_b1", "tpavi_b2", "tpavi_b3",
                                          "tpavi_b4"}
    for k, ref in s["j_stats"].items():
        np.testing.assert_allclose(s["stats"][k], ref, err_msg="/".join(k), **FWD_TOL)


def test_avs_ms3_freeze_trains_the_adapters_and_the_decoder(curves):
    trainable = {tuple(n.split(".")) for n, p in curves["model"].named_parameters()
                 if p.requires_grad}
    frozen = {tuple(n.split(".")) for n, p in curves["model"].named_parameters()
              if not p.requires_grad}
    assert frozen and all(p[1] in ("swin", "htsat") for p in frozen)
    assert all(p[0] != "encoder" or "moe" in p[1] for p in trainable)
    assert {p[0] for p in trainable} == {
        "encoder", "stage_proj_0", "stage_proj_1", "stage_proj_2", "stage_proj_3",
        "audio_linear", "temporal_attn", "tpavi_b1", "tpavi_b2", "tpavi_b3", "tpavi_b4",
        "path_0", "path_1", "path_2", "path_3", "out_conv1", "out_conv2", "out_conv3"}
    assert any(p[-1] == "gate_self" for p in trainable)


@pytest.mark.parametrize("key", ["trainable", "frozen", "total"])
def test_avs_ms3_param_report_counts_match_jax(curves, key):
    ours, ref = curves["report"]
    assert ours[key] == ref[key] > 0
