"""The port's train steps of the legacy AVE models against the JAX package's,
on the CPU.

MMILNetV1 (`make_mmil_v1_loss_fn`: the AVE loss plus the BCE of the gate
outputs) and MMILNetV2 (`make_mmil_v2_loss_fn`: the BCE of the softmaxed
scores) at `replace(tiny_ave_config(), d_model=32)` with Swin-V2 cut to
depths 1-1-3-1 and HTS-AT to 1-1-1-1 (4 V1 sites, one of them behind two
visual-only blocks; 6 LAVisH blocks), float32, the same seeded weights
(non-zero gates, gate_av and latent tokens) and the same three batches,
V1's mixup λ handed in: the port's `make_train_step` against the JAX
package's jitted `make_train_step` + `create_train_state`, lr_mlp = lr.
AVMOE_DETERMINISTIC_TRAIN=1 on both sides (dropout and SpecAugment off;
DropPath's rate is 0 in the tiny configs).

The loss curve runs free, each package from its own state; every step is
also taken by the port from JAX's state before it (parameters, batch stats,
Adam's moments and count), as tests/test_torch_avqa_train.py does and for
its reason: two float32 trajectories part after Adam's sign-like first
step. Tolerances are that file's: losses and each loss term rtol 5e-3; the
trainable parameters after a step |d| <= 1e-6 + 2e-3 |ref| for all but a
1e-3 share of the elements and the update cosine >= 0.999; the Adam first
moments (the gradients) per live leaf cosine >= 0.995, the others at
rounding level in the port too.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from torch_port_harness import jax_variables, to_jax

from torch_train_harness import (LIVE, adam_moment, cos, flat, live, load_jax_state, outside,
                                 port_mu)

from avmoe_tpu_torch.convert import export_jax_variables, load_jax_variables

torch.set_num_threads(2)

STEPS = 3
LR = 2e-4
SWIN_DEPTHS, HTSAT_DEPTHS = (1, 1, 3, 1), (1, 1, 1, 1)
AUX = {"v1": {"loss", "loss_is_event", "loss_event_class", "loss_cas", "loss_gate", "accuracy"},
       "v2": {"loss", "accuracy"}}


def _cut(cfg):
    cfg = dataclasses.replace(cfg, d_model=32)
    return dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin, depths=SWIN_DEPTHS),
                               htsat=dataclasses.replace(cfg.htsat, depths=HTSAT_DEPTHS))


def _batches(cfg, name: str, seed: int = 0):
    rng = np.random.RandomState(seed)
    B, T, S, C = 2, cfg.num_segments, cfg.swin.img_size, cfg.num_classes
    out = []
    for _ in range(STEPS):
        labels = np.eye(C + 1, dtype=np.float32)[rng.randint(0, C + 1, (B, T))]
        b = dict(images=rng.rand(B, T, S, S, 3).astype(np.float32), labels=labels)
        if name == "v1":
            b["wave"] = rng.randn(B, T, cfg.audio_len).astype(np.float32) * 0.1
            b["mixup_lambda"] = rng.uniform(0.3, 0.7, size=B * T).astype(np.float32)
        else:
            b["audio_spec"] = rng.randn(B, T, S, S).astype(np.float32) * 0.5
        out.append(b)
    return out


def _run(name: str):
    from avmoe_tpu.config import TrainConfig as JTrainConfig, tiny_ave_config as jax_tiny
    from avmoe_tpu.models import ave_legacy as jal
    from avmoe_tpu.train.state import create_train_state as j_create_state
    from avmoe_tpu.train.steps import make_train_step as j_make_step

    from avmoe_tpu_torch.config import TrainConfig, tiny_ave_config
    from avmoe_tpu_torch.models import ave_legacy as al
    from avmoe_tpu_torch.train.state import create_train_state
    from avmoe_tpu_torch.train.steps import make_train_step

    v = name[1]
    jcfg = _cut(jax_tiny())
    batches = _batches(jcfg, name)
    a = "wave" if name == "v1" else "audio_spec"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AVMOE_DETERMINISTIC_TRAIN", "1")
        jm = getattr(jal, f"MMILNetV{v}")(jcfg)
        variables = jax_variables(jm, jnp.asarray(batches[0][a]),
                                  jnp.asarray(batches[0]["images"]), seed=5)
        tcfg = dict(accum_steps=1, lr=LR, lr_mlp=LR, decay=0.5, decay_epoch=1)
        jstate = j_create_state(jm, to_jax(variables), JTrainConfig(**tcfg), steps_per_epoch=2)
        jstep = j_make_step(getattr(jal, f"make_mmil_v{v}_loss_fn")(jm), donate=False)
        jstates, j_aux = [jstate], []
        for i, b in enumerate(batches):
            jstate, met = jstep(jstate, {k: jnp.asarray(t) for k, t in b.items()},
                                jax.random.PRNGKey(i))
            jstates.append(jstate)
            j_aux.append({k: float(t) for k, t in met.items()})
        jax.block_until_ready(jstate.trainable)

        pm = getattr(al, f"MMILNetV{v}")(_cut(tiny_ave_config()), device="cpu", seed=None)
        load_jax_variables(pm, variables)
        state = create_train_state(pm, TrainConfig(**tcfg), steps_per_epoch=2)
        step = make_train_step(getattr(al, f"make_mmil_v{v}_loss_fn")(pm))
        tbatches = [{k: torch.from_numpy(t) for k, t in b.items()} for b in batches]
        gen = torch.Generator().manual_seed(0)
        aux = []
        for b in tbatches:                       # free-running: the loss curve
            state, met = step(state, b, gen)
            aux.append({k: float(t) for k, t in met.items()})
        updates = state.updates
        steps = []                               # each step from JAX's state before it
        for i, b in enumerate(tbatches):
            load_jax_state(pm, state, jstates[i], i)
            state, met = step(state, b, gen)
            before, after = jstates[i], jstates[i + 1]
            steps.append(dict(
                loss=float(met["loss"]),
                start=flat(jax.tree_util.tree_map(np.asarray, before.trainable)),
                params=flat(export_jax_variables(pm, trainable_only=True)["params"]),
                j_params=flat(jax.tree_util.tree_map(np.asarray, after.trainable)),
                mu=port_mu(pm, state), j_mu=adam_moment(after.opt_state, "mu")))
    return dict(aux=aux, j_aux=j_aux, steps=steps, updates=updates)


@pytest.fixture(scope="module")
def runs():
    return {name: _run(name) for name in ("v1", "v2")}


@pytest.mark.parametrize("name", ["v1", "v2"])
def test_loss_curve_and_terms_match_jax(runs, name):
    r = runs[name]
    assert r["updates"] == STEPS
    losses = [a["loss"] for a in r["aux"]]
    np.testing.assert_allclose(losses, [a["loss"] for a in r["j_aux"]], rtol=5e-3)
    assert abs(losses[-1] - losses[0]) > 1e-4
    for ours, ref in zip(r["aux"], r["j_aux"]):
        assert set(ours) == set(ref) == AUX[name]
        for k in ref:
            assert ours[k] == pytest.approx(ref[k], rel=5e-3, abs=1e-6), k
    # each step from JAX's state before it
    np.testing.assert_allclose([s["loss"] for s in r["steps"]],
                               [a["loss"] for a in r["j_aux"]], rtol=5e-3)


@pytest.mark.parametrize("i", range(STEPS))
@pytest.mark.parametrize("name", ["v1", "v2"])
def test_each_trainable_leaf_gradient_matches_jax(runs, name, i):
    """Adam's first moment after a step from JAX's state: 0.1 g at the first
    step, so every trainable leaf's gradient there."""
    s = runs[name]["steps"][i]
    ours, ref = s["mu"], s["j_mu"]
    assert set(ours) == set(ref) == set(s["j_params"])
    alive, top = live(ref)
    assert len(alive) > 0.8 * len(ref)
    c = {k: cos(ours[k], ref[k]) for k in alive}
    assert all(v >= 0.995 for v in c.values()), min(c.items(), key=lambda kv: kv[1])
    for k in set(ref) - alive:
        assert np.sqrt(np.mean(ours[k] ** 2)) <= LIVE * top, k


@pytest.mark.parametrize("i", range(1, STEPS))
@pytest.mark.parametrize("name", ["v1", "v2"])
def test_trainable_params_after_a_step_match_jax(runs, name, i):
    s = runs[name]["steps"][i]
    ours, ref, start = s["params"], s["j_params"], s["start"]
    out = np.concatenate([outside(ours[k], ref[k]).ravel() for k in ref])
    assert np.mean(out) <= 1e-3
    upd = np.concatenate([(ours[k] - start[k]).ravel() for k in ref])
    upd_ref = np.concatenate([(ref[k] - start[k]).ravel() for k in ref])
    assert cos(upd, upd_ref) >= 0.999
