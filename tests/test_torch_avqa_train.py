"""The port's AVQA train step against the JAX package's, on the CPU.

The tiny AVQAFusionModel with both backbones cut to depths 2-2-2-2 (8
adapter sites, adapters in every stage, 3 experts, no gate on the audio
adapters), float32, the same seeded weights (non-zero gates and gate_av)
and the same four batches with mixup λ handed in: `make_train_step` with
`make_avqa_loss_fn` against the JAX package's jitted
`make_train_step(make_avqa_loss_fn(model))` + `create_train_state`, lr_mlp
= lr as the AVQA CLI sets it. AVMOE_DETERMINISTIC_TRAIN=1 on both sides
(dropout and SpecAugment off); AVMOE_FUSED_MOE_TRAIN unset (the JAX
package's materialized adapter path, the one the port has). The negative
frames run through the frozen Swin without gradient on both sides.

Two comparisons. The loss curve runs free: each package steps from its own
state. Every step is also held on its own, the port stepping from JAX's
state before it (parameters, batch stats, Adam's moments and count), since
two float32 trajectories of this model part after one Adam step: Adam's
first update is lr sign(g) per element, so the elements whose gradient is
at rounding level (the median of those that differ: 9e-4 of its leaf's
rms) step lr apart in the two packages; a few that differ have gradients
of their leaf's size (the adapters' ReLUs have pre-activations within 4e-6
of zero, the size of the two packages' difference under mixup). From there
7% of the elements differ after a second free-running step (measured; from
one shared state the second step agrees as tightly as the first).

Tolerances, as `tests/test_torch_avvp_train.py` sets them: losses rtol
5e-3. The trainable parameters after a step: |d| <= 1e-6 + 2e-3 |ref| for
all but a 1e-3 share of all elements, and the cosine of the two packages'
parameter updates >= 0.999. A leaf is live when the rms of JAX's Adam
first moment is above 1e-6 of the largest leaf's; the others have
gradients at rounding level in both packages. Per live leaf: the same |d|
bound on all but a 1e-3 share of its elements, the update cosine >= 0.98,
and the Adam first moments' cosine >= 0.995. Per other leaf: the port's
first moment at rounding level as well. The first moments (the gradients)
are held after every step, the parameters after the steps that follow the
first (the sign-like one).
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

STEPS = 4
LR = 2e-4
DEPTHS = (2, 2, 2, 2)


def _cut(cfg):
    return dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin, depths=DEPTHS),
                               htsat=dataclasses.replace(cfg.htsat, depths=DEPTHS))


def _batches(cfg, seed=0):
    rng = np.random.RandomState(seed)
    B, T, S = 2, cfg.num_segments, cfg.swin.img_size
    return [dict(
        wave=rng.randn(B, T, cfg.audio_len).astype(np.float32) * 0.1,
        visual_posi=rng.rand(B, T, S, S, 3).astype(np.float32),
        visual_nega=rng.rand(B, T, S, S, 3).astype(np.float32),
        question=rng.randint(0, cfg.qst_vocab, (B, cfg.max_qst_len)).astype(np.int32),
        answer=rng.randint(0, cfg.answer_vocab, B).astype(np.int32),
        mixup_lambda=rng.uniform(0.3, 0.7, size=B * T).astype(np.float32))
        for _ in range(STEPS)]


@pytest.fixture(scope="module")
def curves():
    from avmoe_tpu.config import TrainConfig as JTrainConfig, tiny_avqa_config as jax_tiny
    from avmoe_tpu.models.avqa import AVQAFusionModel as JAVQA, make_avqa_loss_fn as j_loss_fn
    from avmoe_tpu.train.freeze import param_report as j_param_report
    from avmoe_tpu.train.state import create_train_state as j_create_state
    from avmoe_tpu.train.steps import make_train_step as j_make_step

    from avmoe_tpu_torch.config import TrainConfig, tiny_avqa_config
    from avmoe_tpu_torch.models.avqa import AVQAFusionModel, make_avqa_loss_fn
    from avmoe_tpu_torch.train.freeze import param_report
    from avmoe_tpu_torch.train.state import create_train_state
    from avmoe_tpu_torch.train.steps import make_train_step

    jcfg = _cut(jax_tiny())
    batches = _batches(jcfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AVMOE_DETERMINISTIC_TRAIN", "1")
        mp.delenv("AVMOE_FUSED_MOE_TRAIN", raising=False)
        jm = JAVQA(jcfg)
        b0 = batches[0]
        variables = jax_variables(jm, *(jnp.asarray(b0[k]) for k in (
            "wave", "visual_posi", "visual_nega", "question")), seed=3)
        tcfg = dict(accum_steps=1, lr=LR, lr_mlp=LR, decay=0.5, decay_epoch=1)
        jstate = j_create_state(jm, to_jax(variables), JTrainConfig(**tcfg), steps_per_epoch=2)
        jstep = j_make_step(j_loss_fn(jm), donate=False)
        jstates, j_losses, j_aux = [jstate], [], []
        for i, b in enumerate(batches):
            jstate, met = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                                jax.random.PRNGKey(i))
            jstates.append(jstate)
            j_losses.append(float(met["loss"]))
            j_aux.append({k: float(v) for k, v in met.items()})
        jax.block_until_ready(jstate.trainable)

        pm = AVQAFusionModel(_cut(tiny_avqa_config()), device="cpu", seed=None)
        load_jax_variables(pm, variables)
        report = (param_report(pm), j_param_report(variables["params"]))
        state = create_train_state(pm, TrainConfig(**tcfg), steps_per_epoch=2)
        step = make_train_step(make_avqa_loss_fn(pm))
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
                mu=port_mu(pm, state), j_mu=adam_moment(after.opt_state, "mu")))
    return dict(losses=np.array(losses), j_losses=np.array(j_losses), aux=aux, j_aux=j_aux,
                steps=steps, report=report, updates=updates, model=pm)


def test_avqa_loss_curve_matches_jax(curves):
    np.testing.assert_allclose(curves["losses"], curves["j_losses"], rtol=5e-3)
    assert curves["updates"] == STEPS
    assert abs(curves["losses"][-1] - curves["losses"][0]) > 1e-3
    # each term of the loss and the accuracy
    for ours, ref in zip(curves["aux"], curves["j_aux"]):
        assert set(ours) == set(ref) == {"loss", "loss_qa", "loss_match", "accuracy"}
        for k in ref:
            assert ours[k] == pytest.approx(ref[k], rel=5e-3), k
    # each step from JAX's state before it
    np.testing.assert_allclose([s["loss"] for s in curves["steps"]], curves["j_losses"],
                               rtol=5e-3)


@pytest.mark.parametrize("i", range(1, STEPS))
def test_avqa_trainable_params_after_the_steps_match_jax(curves, i):
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
def test_avqa_each_live_leaf_update_matches_jax(curves, i):
    s = curves["steps"][i]
    ours, ref, start = s["params"], s["j_params"], s["start"]
    alive, _ = live(s["j_mu"])
    assert len(alive) > 0.9 * len(ref)
    share = {k: np.mean(outside(ours[k], ref[k])) for k in alive}
    assert all(v <= 1e-3 for v in share.values()), max(share.items(), key=lambda kv: kv[1])
    c = {k: cos(ours[k] - start[k], ref[k] - start[k]) for k in alive}
    assert all(v >= 0.98 for v in c.values()), min(c.items(), key=lambda kv: kv[1])


@pytest.mark.parametrize("i", range(STEPS))
def test_avqa_each_trainable_leaf_gradient_matches_jax(curves, i):
    s = curves["steps"][i]
    ours, ref = s["mu"], s["j_mu"]
    assert set(ours) == set(ref) == set(s["j_params"])
    alive, top = live(ref)
    c = {k: cos(ours[k], ref[k]) for k in alive}
    assert all(v >= 0.995 for v in c.values()), min(c.items(), key=lambda kv: kv[1])
    for k in set(ref) - alive:
        assert np.sqrt(np.mean(ours[k] ** 2)) <= LIVE * top, k


def test_avqa_freeze_trains_the_adapters_the_question_encoder_and_every_head(curves):
    """The backbones freeze (the negative pass reads the same frozen Swin);
    the encoder's adapters, the question encoder (embedding, LSTM, fc) and
    every head train."""
    trainable = {tuple(n.split(".")) for n, p in curves["model"].named_parameters()
                 if p.requires_grad}
    frozen = {tuple(n.split(".")) for n, p in curves["model"].named_parameters()
              if not p.requires_grad}
    assert frozen and all(p[1] in ("swin", "htsat") for p in frozen)
    assert all(p[0] != "encoder" or "moe" in p[1] for p in trainable)
    assert {p[0] for p in trainable} == {
        "encoder", "fc_a1", "fc_a2", "fc_gl", "fc_fusion", "fc1", "fc2", "fc3", "fc4",
        "question_encoder", "attn_v", "attn_a", "fc_ans"}
    assert {p[1] for p in trainable if p[0] == "question_encoder"} == {"word2vec", "lstm", "fc"}


@pytest.mark.parametrize("key", ["trainable", "frozen", "total"])
def test_avqa_param_report_counts_match_jax(curves, key):
    ours, ref = curves["report"]
    assert ours[key] == ref[key] > 0
