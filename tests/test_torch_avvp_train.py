"""The port's AVVP train step against the JAX package's, on the CPU.

The tiny MGN model with both backbones cut to depths 2-2-2-2 (8 adapter
sites, adapters in every stage), float32, the same seeded weights (non-zero
gates, gate_av and class tokens) and the same three batches with mixup λ
handed in: three steps of `avmoe_tpu_torch.train.steps.make_train_step`
with `make_avvp_loss_fn` against three of the JAX package's jitted
`make_train_step(make_avvp_loss_fn(model))` + `create_train_state`, lr_mlp
= lr as the AVVP CLI sets it. The random draws are made to agree:
AVMOE_DETERMINISTIC_TRAIN=1 on both sides (dropout and SpecAugment off),
the heads' DropPath off on both sides (the JAX module's DropPath patched to
the identity, the port's rates set to 0), and the same Gumbel noise for
HAN's assignment (the JAX module's jax.random.gumbel draw and the port's
`gumbel_noise` both patched to return it). AVMOE_FUSED_MOE_TRAIN is unset
(the JAX package's materialized adapter path, the one the port has).

Tolerances: losses rtol 5e-3. The trainable parameters after the steps:
|d| <= 1e-6 + 2e-3 |ref| for all but a 1e-3 share of all elements, and the
cosine of the two packages' parameter updates >= 0.999. A leaf is live when
the rms of JAX's Adam first moment is above 1e-6 of the largest leaf's; the
others (key and query biases that a softmax cancels, biases that a LayerNorm
cancels, some gate_av) have gradients at rounding level in both packages,
which Adam turns into steps of about lr in either direction. Per live leaf:
the same |d| bound on all but a 1e-3 share of its elements, the update
cosine >= 0.98, and the Adam first moments' cosine >= 0.995. Per other leaf:
the port's first moment at rounding level as well.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from torch_port_harness import jax_variables, to_jax

from torch_train_harness import LIVE, adam_moment, cos, flat, live, outside, port_mu

from avmoe_tpu_torch.convert import export_jax_variables, load_jax_variables

torch.set_num_threads(2)

STEPS = 3
LR = 2e-4
DEPTHS = (2, 2, 2, 2)


def _cut(cfg):
    return dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin, depths=DEPTHS),
                               htsat=dataclasses.replace(cfg.htsat, depths=DEPTHS))


def _batches(cfg, seed=0):
    rng = np.random.RandomState(seed)
    B, T = 2, cfg.num_segments
    return [dict(
        wave=rng.randn(B, T, cfg.audio_len).astype(np.float32) * 0.1,
        images=rng.rand(B, T, cfg.swin.img_size, cfg.swin.img_size, 3).astype(np.float32),
        video_st=rng.randn(B, T, cfg.st_dim).astype(np.float32),
        labels=(rng.rand(B, cfg.num_classes) < 0.2).astype(np.float32),
        mixup_lambda=rng.uniform(0.3, 0.7, size=B * T).astype(np.float32))
        for _ in range(STEPS)]


@pytest.fixture(scope="module")
def curves():
    import avmoe_tpu.heads.grouping as jgrouping
    from avmoe_tpu.config import TrainConfig as JTrainConfig, tiny_avvp_config as jax_tiny
    from avmoe_tpu.models.avvp import MGNModel as JMGN, make_avvp_loss_fn as j_loss_fn
    from avmoe_tpu.train.freeze import param_report as j_param_report
    from avmoe_tpu.train.state import create_train_state as j_create_state
    from avmoe_tpu.train.steps import make_train_step as j_make_step

    import avmoe_tpu_torch.heads.grouping as tgrouping
    from avmoe_tpu_torch.config import TrainConfig, tiny_avvp_config
    from avmoe_tpu_torch.models.avvp import MGNModel, make_avvp_loss_fn
    from avmoe_tpu_torch.train.freeze import param_report
    from avmoe_tpu_torch.train.state import create_train_state
    from avmoe_tpu_torch.train.steps import make_train_step

    jcfg = _cut(jax_tiny())
    batches = _batches(jcfg)
    B, T = batches[0]["wave"].shape[:2]
    noise = np.random.RandomState(5).gumbel(size=(B, T, T)).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AVMOE_DETERMINISTIC_TRAIN", "1")
        mp.delenv("AVMOE_FUSED_MOE_TRAIN", raising=False)
        mp.setattr(jgrouping, "DropPath", lambda rate: (lambda x, train=False: x))
        mp.setattr(jax.random, "gumbel",
                   lambda key, shape, dtype=jnp.float32: jnp.asarray(noise, dtype))
        mp.setattr(tgrouping, "gumbel_noise",
                   lambda shape, generator, device, dtype: torch.from_numpy(noise).to(dtype))
        jm = JMGN(jcfg)
        b0 = batches[0]
        variables = jax_variables(jm, jnp.asarray(b0["wave"]), jnp.asarray(b0["images"]),
                                  jnp.asarray(b0["video_st"]), seed=3)
        tcfg = dict(accum_steps=1, lr=LR, lr_mlp=LR, decay=0.5, decay_epoch=1)
        jstate = j_create_state(jm, to_jax(variables), JTrainConfig(**tcfg), steps_per_epoch=2)
        jstep = j_make_step(j_loss_fn(jm), donate=False)
        j_losses, j_aux = [], []
        for i, b in enumerate(batches):
            jstate, met = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                                jax.random.PRNGKey(i))
            j_losses.append(float(met["loss"]))
            j_aux.append({k: float(v) for k, v in met.items()})
        jax.block_until_ready(jstate.trainable)

        pm = MGNModel(_cut(tiny_avvp_config()), device="cpu", seed=None)
        load_jax_variables(pm, variables)
        for m in pm.modules():
            if isinstance(m, tgrouping.AttnBlock):
                m.drop_path = 0.0
        report = (param_report(pm), j_param_report(variables["params"]))
        state = create_train_state(pm, TrainConfig(**tcfg), steps_per_epoch=2)
        step = make_train_step(make_avvp_loss_fn(pm))
        gen = torch.Generator().manual_seed(0)
        losses, aux = [], []
        for b in batches:
            state, met = step(state, {k: torch.from_numpy(v) for k, v in b.items()}, gen)
            losses.append(float(met["loss"]))
            aux.append({k: float(v) for k, v in met.items()})
    return dict(losses=np.array(losses), j_losses=np.array(j_losses), aux=aux, j_aux=j_aux,
                state=export_jax_variables(pm, trainable_only=True),
                j_trainable=jax.tree_util.tree_map(np.asarray, jstate.trainable),
                j_mu=adam_moment(jstate.opt_state, "mu"), mu=port_mu(pm, state),
                start=variables, report=report, updates=state.updates, model=pm)


def test_avvp_loss_curve_matches_jax(curves):
    np.testing.assert_allclose(curves["losses"], curves["j_losses"], rtol=5e-3)
    assert curves["updates"] == STEPS
    assert abs(curves["losses"][-1] - curves["losses"][0]) > 1e-3
    # each term of the loss, the load-balance loss summed over the 32 calls too
    for ours, ref in zip(curves["aux"], curves["j_aux"]):
        assert set(ours) == set(ref)
        for k in ref:
            assert ours[k] == pytest.approx(ref[k], rel=5e-3), k
        assert ref["loss_lb"] > 32 * 2 * np.log(2) - 1e-3


def test_avvp_trainable_params_after_the_steps_match_jax(curves):
    ours, ref = flat(curves["state"]["params"]), flat(curves["j_trainable"])
    start = flat(curves["start"]["params"])
    assert set(ours) == set(ref) and len(ref) > 100
    out = np.concatenate([outside(ours[k], ref[k]).ravel() for k in ref])
    assert np.mean(out) <= 1e-3
    upd = np.concatenate([(ours[k] - start[k]).ravel() for k in ref])
    upd_ref = np.concatenate([(ref[k] - start[k]).ravel() for k in ref])
    assert cos(upd, upd_ref) >= 0.999
    for k in ref:
        assert np.abs(ref[k] - start[k]).max() > 0, k
        assert np.abs(ours[k] - start[k]).max() > 0, k


def test_avvp_each_live_leaf_update_matches_jax(curves):
    ours, ref = flat(curves["state"]["params"]), flat(curves["j_trainable"])
    start = flat(curves["start"]["params"])
    alive, _ = live(curves["j_mu"])
    assert len(alive) > 0.9 * len(ref)
    share = {k: np.mean(outside(ours[k], ref[k])) for k in alive}
    assert all(v <= 1e-3 for v in share.values()), max(share.items(), key=lambda kv: kv[1])
    c = {k: cos(ours[k] - start[k], ref[k] - start[k]) for k in alive}
    assert all(v >= 0.98 for v in c.values()), min(c.items(), key=lambda kv: kv[1])


def test_avvp_each_trainable_leaf_gradient_matches_jax(curves):
    ours, ref = curves["mu"], curves["j_mu"]
    assert set(ours) == set(ref) == set(flat(curves["j_trainable"]))
    alive, top = live(ref)
    c = {k: cos(ours[k], ref[k]) for k in alive}
    assert all(v >= 0.995 for v in c.values()), min(c.items(), key=lambda kv: kv[1])
    # the leaves JAX's gradient leaves at rounding level: the port's is too
    for k in set(ref) - alive:
        assert np.sqrt(np.mean(ours[k] ** 2)) <= LIVE * top, k


def test_avvp_freeze_trains_the_adapters_and_every_head(curves):
    """The backbones freeze; the encoder's adapters, the class tokens, the
    fc layers and all three grouping heads train."""
    trainable = {tuple(n.split(".")) for n, p in curves["model"].named_parameters()
                 if p.requires_grad}
    frozen = {tuple(n.split(".")) for n, p in curves["model"].named_parameters()
              if not p.requires_grad}
    assert frozen and all(p[1] in ("swin", "htsat") for p in frozen)
    assert all(p[0] != "encoder" or "moe" in p[1] for p in trainable)
    tops = {p[0] for p in trainable}
    assert tops == {"encoder", "fc_a", "fc_v", "fc_st", "fc_fusion", "audio_token",
                    "visual_token", "audio_cug", "visual_cug", "av_mcg", "fc_prob",
                    "fc_prob_a", "fc_prob_v", "fc_cls"}


@pytest.mark.parametrize("key", ["trainable", "frozen", "total"])
def test_avvp_param_report_counts_match_jax(curves, key):
    ours, ref = curves["report"]
    assert ours[key] == ref[key] > 0
