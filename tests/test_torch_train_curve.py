"""The port's train step against the JAX package's, on the CPU.

The tiny AVE model with both backbones cut to depths 2-2-2-2 (at the tiny
widths), float32, the same seeded weights (non-zero adapter gates) and the
same four batches with mixup λ handed in: four steps of
`avmoe_tpu_torch.train.steps.make_train_step` against four of the JAX
package's jitted `make_train_step` + `create_train_state` (2 epochs of 2
steps, decay_epoch 1, lr_mlp != lr). AVMOE_DETERMINISTIC_TRAIN=1 is set on
both sides (dropout and SpecAugment off) and AVMOE_FUSED_MOE_TRAIN unset (the
JAX package's materialized adapter path, the one the port has). The JAX
step is compiled once for the file (a module-scoped fixture); its variables
come from `jax.eval_shape`, not an init.

Tolerances: losses rtol 5e-3 (the JAX suite's loss-curve tolerance). The
parameters after the steps: Adam moves each by about lr a step whatever the
gradient's size, so a component whose gradient is at rounding level in both
packages may move either way, and which components those are moves with
the order of the sums: in one run of seven here the port's float32 sums
came out in another order (the same code, the same process otherwise), and
the share below went from 7.4e-4 to 1.0e-2 of the 1.5e6 elements. So:
|d| <= 2e-6 + 1e-3 |ref| for all but a 3e-2 share of the elements, <= 4
(lr + lr_mlp) for every one (measured: 7.8e-4), and the cosine of the two
packages' parameter updates >= 0.99 (measured: 0.99988). The running stats
of steps 2 to 4 are statistics of adapters whose weights carry that drift:
atol 1e-3, rtol 1e-3 (measured max |d| 2.3e-4 to 3.8e-4). Measured loss
agreement: 2e-6 relative (4e-5 in the run whose sums moved). Per leaf, the
gradient's direction: Adam's first moments of the two packages, cosine
>= 0.995 on every leaf whose gradient is above rounding level.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from torch_port_harness import jax_variables, to_jax

from torch_train_harness import adam_moment, flat, port_mu

from avmoe_tpu_torch.convert import export_jax_variables, load_jax_variables

torch.set_num_threads(2)

STEPS = 4
LR, LR_MLP = 2e-4, 1e-4
DEPTHS = (2, 2, 2, 2)


def _cut(cfg):
    return dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin, depths=DEPTHS),
                               htsat=dataclasses.replace(cfg.htsat, depths=DEPTHS))


def _batches(cfg, seed=0):
    rng = np.random.RandomState(seed)
    B, T = 2, cfg.num_segments
    out = []
    for _ in range(STEPS):
        labels = np.zeros((B, T, cfg.num_classes + 1), np.float32)
        cls = rng.randint(0, cfg.num_classes, size=B)
        for b in range(B):
            fg = rng.rand(T) < 0.7
            labels[b, fg, cls[b]] = 1.0
            labels[b, ~fg, -1] = 1.0
        out.append(dict(
            wave=rng.randn(B, T, cfg.audio_len).astype(np.float32) * 0.1,
            images=rng.rand(B, T, cfg.swin.img_size, cfg.swin.img_size, 3).astype(np.float32),
            labels=labels,
            mixup_lambda=rng.uniform(0.3, 0.7, size=B * T).astype(np.float32)))
    return out


@pytest.fixture(scope="module")
def curves():
    from avmoe_tpu.config import TrainConfig as JTrainConfig, tiny_ave_config as jax_tiny
    from avmoe_tpu.models.ave import AVEModel as JAVE, make_ave_loss_fn as j_loss_fn
    from avmoe_tpu.train.freeze import param_report as j_param_report
    from avmoe_tpu.train.state import create_train_state as j_create_state
    from avmoe_tpu.train.steps import make_train_step as j_make_step

    from avmoe_tpu_torch.config import TrainConfig, tiny_ave_config
    from avmoe_tpu_torch.models.ave import AVEModel, make_ave_loss_fn
    from avmoe_tpu_torch.train.freeze import param_report
    from avmoe_tpu_torch.train.state import create_train_state
    from avmoe_tpu_torch.train.steps import make_train_step

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AVMOE_DETERMINISTIC_TRAIN", "1")
        mp.delenv("AVMOE_FUSED_MOE_TRAIN", raising=False)
        jcfg = _cut(jax_tiny())
        batches = _batches(jcfg)
        jm = JAVE(jcfg)
        variables = jax_variables(jm, jnp.asarray(batches[0]["wave"]),
                                  jnp.asarray(batches[0]["images"]), seed=3)
        tcfg = dict(accum_steps=1, lr=LR, lr_mlp=LR_MLP, decay=0.5, decay_epoch=1)
        jstate = j_create_state(jm, to_jax(variables), JTrainConfig(**tcfg), steps_per_epoch=2)
        jstep = j_make_step(j_loss_fn(jm), donate=False)
        j_losses = []
        for i, b in enumerate(batches):
            jstate, met = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                                jax.random.PRNGKey(i))
            j_losses.append(float(met["loss"]))
        jax.block_until_ready(jstate.trainable)

        pm = AVEModel(_cut(tiny_ave_config()), device="cpu", seed=None)
        load_jax_variables(pm, variables)
        report = (param_report(pm), j_param_report(variables["params"]))
        state = create_train_state(pm, TrainConfig(**tcfg), steps_per_epoch=2)
        step = make_train_step(make_ave_loss_fn(pm))
        gen = torch.Generator().manual_seed(0)
        losses = []
        for b in batches:
            state, met = step(state, {k: torch.from_numpy(v) for k, v in b.items()}, gen)
            losses.append(float(met["loss"]))
    return dict(losses=np.array(losses), j_losses=np.array(j_losses),
                state=export_jax_variables(pm, trainable_only=True),
                j_trainable=jax.tree_util.tree_map(np.asarray, jstate.trainable),
                j_batch_stats=jax.tree_util.tree_map(np.asarray, jstate.batch_stats),
                j_mu=adam_moment(jstate.opt_state, "mu"),
                mu=port_mu(pm, state), start=variables, report=report,
                updates=state.updates)


def test_loss_curve_matches_jax(curves):
    np.testing.assert_allclose(curves["losses"], curves["j_losses"], rtol=5e-3)
    assert curves["updates"] == STEPS
    # the curve is not flat: the steps trained something
    assert abs(curves["losses"][-1] - curves["losses"][0]) > 1e-3


def test_trainable_params_after_the_steps_match_jax(curves):
    ours, ref = flat(curves["state"]["params"]), flat(curves["j_trainable"])
    start = flat(curves["start"]["params"])
    assert set(ours) == set(ref) and len(ref) > 100
    d = np.concatenate([np.abs(ours[k] - ref[k]).ravel() for k in ref])
    r = np.concatenate([np.abs(ref[k]).ravel() for k in ref])
    assert np.mean(d > 2e-6 + 1e-3 * r) <= 3e-2
    assert d.max() <= 4 * (LR + LR_MLP)
    upd = np.concatenate([(ours[k] - start[k]).ravel() for k in ref])
    upd_ref = np.concatenate([(ref[k] - start[k]).ravel() for k in ref])
    assert upd @ upd_ref / np.linalg.norm(upd) / np.linalg.norm(upd_ref) >= 0.99
    # every trainable leaf moved in both packages
    for k in ref:
        assert np.abs(ref[k] - start[k]).max() > 0, k
        assert np.abs(ours[k] - start[k]).max() > 0, k


def test_each_trainable_leaf_gradient_matches_jax(curves):
    """Per leaf, the direction of the gradient: the cosine of the two
    packages' Adam first moments after the steps (a running average of the
    steps' gradients), on every leaf whose JAX gradient is above rounding
    level: a first moment of rms above 1e-5 of the largest leaf's (658 of 712
    leaves, rms 1.5e-5 to 0.1; the other 54, biases that a norm or a softmax
    right after them cancels, sit at 7e-9 or below). Measured: every cosine
    >= 0.99936. The update itself is no measure per leaf: Adam moves each
    element by about lr whatever its gradient, so one element of a 16-wide
    leaf whose gradient is near zero turns the update's cosine to 0.875."""
    ours, ref = curves["mu"], curves["j_mu"]
    assert set(ours) == set(ref) == set(flat(curves["j_trainable"]))
    rms = {k: np.sqrt(np.mean(ref[k] ** 2)) for k in ref}
    live = [k for k in ref if rms[k] > 1e-5 * max(rms.values())]
    assert len(live) > 0.9 * len(ref)
    cos = {k: ours[k].ravel() @ ref[k].ravel() / np.linalg.norm(ours[k]) / np.linalg.norm(ref[k])
           for k in live}
    assert all(c >= 0.995 for c in cos.values()), min(cos.items(), key=lambda kv: kv[1])


def test_batch_stats_after_the_steps_match_jax(curves):
    ours, ref = flat(curves["state"]["batch_stats"]), flat(curves["j_batch_stats"])
    start = flat(curves["start"]["batch_stats"])
    assert set(ours) == set(ref) and len(ref) > 10
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-3, atol=1e-3, err_msg=str(k))
        assert np.abs(ref[k] - start[k]).max() > 0, k


@pytest.mark.parametrize("key", ["trainable", "frozen", "total"])
def test_param_report_counts_match_jax(curves, key):
    ours, ref = curves["report"]
    assert ours[key] == ref[key] > 0
