"""Why some AVS parameters never move from the seeded init, in both packages.

TPAVI's W_z_conv kernel and bias and W_z_bn's scale start at zero (flax's
initializers; the port's seeded init copies them), so W_z's output is zero
whatever its input. No gradient then reaches W_z_bn's scale (its normalized
input is all zeros), W_z_conv or TPAVI's g, theta and phi before it (W_z_bn's
scale is zero), and none of them moves while all stay zero. In S4, whose
masked audio-visual loss is off, TPAVI's aligned audio and the temporal
attention's video branch, which only scales that audio, get no gradient
either. `chip_smoke.py`'s AVS CLI phase exempts exactly those tensors
(`avs_seed_init_stalls`) from its every-trainable-tensor-moved check.

The tiny S4 and MS3 configs with both backbones cut to depths 1-1-1-1,
float32, seeded noise weights but for W_z's zeros (so every other path is
live), AVMOE_DETERMINISTIC_TRAIN=1, the mixup λ and the router noise given:
the decoder's trainable leaves whose gradient is exactly zero, from
`jax.grad` of the JAX package's `make_avs_loss_fn` (over those leaves, the
encoder's held) and from the port's autograd, are the same set, and it is
`avs_seed_init_stalls`'; the port's encoder leaves all get a gradient. One
JAX compile for the file (both settings' gradients in one jitted function).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from torch_port_harness import port_variables, to_jax
from torch_train_harness import flat

import chip_smoke
from avmoe_tpu_torch.convert import export_jax_variables, load_jax_variables

torch.set_num_threads(2)

DEPTHS = (1, 1, 1, 1)
SETTINGS = {"s4": ("swin",), "ms3": ("swin", "htsat")}      # the frozen scopes
B = 2


def _cut(cfg, setting: str):
    cfg = dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin, depths=DEPTHS),
                              htsat=dataclasses.replace(cfg.htsat, depths=DEPTHS))
    if setting == "s4":
        return cfg
    # the MS3 recipe, as the port's ms3_config and the JAX CLI's build_config give it
    adapter = dataclasses.replace(cfg.moe.adapter, self_attention="token")
    return dataclasses.replace(
        cfg, setting="ms3", temporal_gamma=0.1, lb_loss_weight=0.01, sa_loss_flag=True,
        lambda_1=0.5, sa_loss_kind="kl", sa_norm_fea=False, sa_threshold=False,
        sa_loss_stages=(0, 1, 2, 3), moe=dataclasses.replace(cfg.moe, adapter=adapter))


def _batch(cfg, setting: str):
    rng = np.random.RandomState(0)
    T, S, M = cfg.num_segments, cfg.img_size, cfg.mask_size
    mask = rng.rand(B, M, M) if setting == "s4" else rng.rand(B, T, M, M)
    return dict(images=rng.rand(B, T, S, S, 3).astype(np.float32),
                wave=rng.randn(B, T, cfg.audio_len).astype(np.float32) * 0.1,
                mask=(mask > 0.6).astype(np.float32),
                mixup_lambda=rng.uniform(0.3, 0.7, size=B * T).astype(np.float32))


@pytest.fixture(scope="module")
def zeros():
    from avmoe_tpu import config as jc
    from avmoe_tpu.models.avs import AVSModel as JAVS, make_avs_loss_fn as j_loss_fn
    from avmoe_tpu.train.freeze import merge_params, partition_params

    import avmoe_tpu_torch.moe.adapter as adapter
    from avmoe_tpu_torch import config as pc
    from avmoe_tpu_torch.models.avs import AVSModel, make_avs_loss_fn
    from avmoe_tpu_torch.train.freeze import freeze

    noise = np.random.RandomState(1).randn(B * 2, 2).astype(np.float32)
    out, jobs = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AVMOE_DETERMINISTIC_TRAIN", "1")
        mp.delenv("AVMOE_FUSED_MOE_TRAIN", raising=False)
        mp.setattr(jax.random, "normal", lambda key, shape, *a, **k: jnp.asarray(noise))
        mp.setattr(adapter, "router_noise",
                   lambda shape, generator, device: torch.from_numpy(noise).to(device))
        for setting, scopes in SETTINGS.items():
            cfg = _cut(pc.tiny_avs_config(), setting)
            pm = AVSModel(cfg, device="cpu", seed=None)
            variables = port_variables(pm, seed=5)
            for name, sub in variables["params"].items():
                if name.startswith("tpavi_b"):
                    for leaf in (sub["W_z_conv"]["kernel"], sub["W_z_conv"]["bias"],
                                 sub["W_z_bn"]["scale"]):
                        leaf[...] = 0.0
            batch = _batch(cfg, setting)
            jm = JAVS(_cut(jc.tiny_avs_config(), setting))
            trainable, frozen = partition_params(to_jax(variables["params"]), scopes)
            jobs[setting] = (j_loss_fn(jm), trainable, frozen, variables["batch_stats"], batch)

            load_jax_variables(pm, variables)
            params = freeze(pm, scopes)
            b = {k: torch.from_numpy(v) for k, v in batch.items()}
            loss, _ = make_avs_loss_fn(pm)(pm, b, torch.Generator().manual_seed(0))
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            grads = {n: torch.zeros_like(p) if g is None else g
                     for (n, p), g in zip(params.items(), grads)}
            with torch.no_grad():                # the port's gradients in the flax tree
                for n, p in params.items():
                    p.copy_(grads[n])
                tree = flat(export_jax_variables(pm, trainable_only=True,
                                                 frozen_scopes=scopes)["params"])
            out[setting] = dict(cfg=cfg, grads=grads, tree=tree)

        def jgrads(trs):
            res = {}
            for setting, (loss_fn, _, frozen, stats, batch) in jobs.items():
                encoder = {"encoder": trs[setting]["encoder"]}

                def loss(heads):
                    v = {"params": merge_params({**heads, **encoder}, frozen),
                         "batch_stats": stats}
                    return loss_fn(v, {k: jnp.asarray(x) for k, x in batch.items()},
                                   {k: jax.random.PRNGKey(i) for i, k in enumerate(
                                       ("dropout", "specaug", "router", "gumbel"))})[0]
                heads = {k: v for k, v in trs[setting].items() if k != "encoder"}
                res[setting] = jax.grad(loss)(heads)
            return res

        res = jax.jit(jgrads)({s: job[1] for s, job in jobs.items()})
    for setting, g in res.items():
        out[setting]["j_tree"] = flat(jax.tree_util.tree_map(np.asarray, g))
    return out


def test_the_seeded_init_starts_w_z_at_zero():
    """The port's seeded init sets W_z as flax's initializers do (zeros for
    the conv kernel and bias, the BN scale), and the JAX package's TPAVI
    block initializes them so."""
    from avmoe_tpu.heads.avs import TPAVIModule as JTPAVI

    from avmoe_tpu_torch.config import tiny_avs_config
    from avmoe_tpu_torch.models.avs import AVSModel

    pm = AVSModel(tiny_avs_config(), device="cpu", seed=0)
    for name, m in pm.tpavi.items():
        assert not m.W_z_conv.kernel.any() and not m.W_z_conv.bias.any(), name
        assert not m.W_z_bn.weight.any(), name
        assert m.g.weight.abs().sum() > 0 and m.theta.weight.abs().sum() > 0
    x, a = jnp.ones((1, 2, 3, 3, 8)), jnp.ones((1, 2, 128))
    v = JTPAVI(8).init(jax.random.PRNGKey(0), x, a)
    assert not np.asarray(v["params"]["W_z_conv"]["kernel"]).any()
    assert not np.asarray(v["params"]["W_z_conv"]["bias"]).any()
    assert not np.asarray(v["params"]["W_z_bn"]["scale"]).any()


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_the_same_tensors_get_no_gradient_in_both_packages(zeros, setting):
    """The decoder's leaves (every trainable tensor outside the encoder: the
    JAX gradient is taken over those alone); in the port, the encoder's
    trainable leaves all get a gradient."""
    z = zeros[setting]
    heads = {k: v for k, v in z["tree"].items() if k[0] != "encoder"}
    ours = {k for k, v in heads.items() if not np.any(v)}
    ref = {k for k, v in z["j_tree"].items() if not np.any(v)}
    assert set(heads) == set(z["j_tree"])
    assert ours == ref and ours
    assert all(k[0].startswith(("tpavi_b", "temporal_attn")) for k in ours)
    assert all(np.any(v) for k, v in z["tree"].items() if k[0] == "encoder")


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_chip_smoke_exempts_exactly_those_tensors(zeros, setting):
    z = zeros[setting]
    dead = {n for n, g in z["grads"].items() if not g.any()}
    assert dead == chip_smoke.avs_seed_init_stalls(z["cfg"], z["grads"])
    # TPAVI's W_z and the products before it in both settings; the aligned
    # audio and the temporal attention's video branch in S4 only
    kinds = {n.split(".")[1].rstrip("_0123456789") for n in dead}
    assert kinds >= {"g", "theta", "phi", "W_z_conv", "W_z_bn"}
    assert ("align_channel" in kinds) == (setting == "s4")
    assert ("v_fc" in kinds and "visual_rnn" in kinds) == (setting == "s4")
