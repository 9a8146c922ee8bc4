"""The port's fused MoE combine in train, against the JAX package's.

Adapter: under AVMOE_FUSED_MOE_TRAIN=1 (JAX) and `MoEAdapter(...,
fused_moe_train=True)` (port), for the unimodal kinds 'none' and 'token'
as in `tests/test_fused_moe.py`: the loss sum(y²) + 0.1 sum(gates), every
parameter's gradient and the updated BN running statistics (bn2's from the
closed-form moments of z). JAX's bounds: loss rtol 1e-4, gradients and
statistics rtol 5e-4 / atol 5e-5, in float32.

Whole model: the tiny `AVEModel` (backbones cut to depths 1-1-1-1) with
both switches on (`fused_moe=True, fused_moe_train=True`) against the JAX
model with both environment variables set, on the same exported weights,
with the random draws off (AVMOE_DETERMINISTIC_TRAIN=1) and no mixup: the
eval forward's logits (rtol 2e-3 / atol 1e-4, the suite's activation
bound), one train forward's loss (rtol 5e-3) and its gradient of every
trainable leaf with a live gradient (cosine >= 0.9999, and elementwise
within 2e-3 of the leaf's largest JAX entry). One jitted JAX function gives
the eval forward, the loss and the gradients: one compile for the file.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from torch_port_harness import jax_variables, to_jax  # noqa: E402
from torch_train_harness import cos, flat, live  # noqa: E402

from avmoe_tpu_torch.convert import export_jax_variables, load_jax_variables  # noqa: E402

torch.set_num_threads(2)

B, N, C, M, CO = 2, 24, 32, 16, 48
DEPTHS = (1, 1, 1, 1)


def port_grads(model, params) -> dict:
    """The gradients held in `params`' .grad as a flat flax params tree of
    the trainable leaves (each copied into its parameter for the export,
    then put back)."""
    with torch.no_grad():
        saved = {n: p.detach().clone() for n, p in params.items()}
        for p in params.values():
            p.copy_(p.grad if p.grad is not None else torch.zeros_like(p))
        out = flat(export_jax_variables(model, trainable_only=True)["params"])
        for n, p in params.items():
            p.copy_(saved[n])
    return out


@pytest.mark.parametrize("sa", ["none", "token"])
def test_fused_train_adapter_matches_jax(monkeypatch, sa):
    from avmoe_tpu.config import AdapterConfig as JA, MoEConfig as JM
    from avmoe_tpu.moe.adapter import MoEAdapter as JMoE

    from avmoe_tpu_torch.config import AdapterConfig, MoEConfig
    from avmoe_tpu_torch.moe.adapter import MoEAdapter

    akw = dict(downsample=4, num_conv_group=2, num_tokens=4, use_bn=True,
               post_layernorm=True, self_attention=sa)
    mkw = dict(num_multimodal_experts=2, num_singlemodal_experts=2)
    jm = JMoE(dim=C, other_dim=CO, num_tokens=N, other_num_tokens=M,
              cfg=JM(adapter=JA(**akw), **mkw))
    rng = np.random.RandomState(2)
    x = rng.randn(B, N, C).astype(np.float32)
    other = rng.randn(B, M, CO).astype(np.float32)
    variables = jax_variables(jm, jnp.asarray(x), jnp.asarray(other), True, seed=3)
    jv = to_jax(variables)

    def loss_fn(params):
        (y, aux), new = jm.apply({"params": params, "batch_stats": jv["batch_stats"]},
                                 jnp.asarray(x), jnp.asarray(other), True,
                                 mutable=["batch_stats"])
        return jnp.sum(jnp.square(y)) + 0.1 * jnp.sum(aux["gating_probs"]), new["batch_stats"]

    monkeypatch.setenv("AVMOE_FUSED_MOE_TRAIN", "1")
    (jloss, jstats), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(jv["params"])
    monkeypatch.delenv("AVMOE_FUSED_MOE_TRAIN")

    pm = MoEAdapter(C, CO, N, M, MoEConfig(adapter=AdapterConfig(**akw), **mkw),
                    fused_moe_train=True)
    load_jax_variables(pm, variables)
    y, aux = pm(torch.from_numpy(x), torch.from_numpy(other), train=True)
    loss = (y * y).sum() + 0.1 * aux["gating_probs"].sum()
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    ours = port_grads(pm, dict(pm.named_parameters()))
    ref = flat(jax.device_get(jgrads))
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=5e-4, atol=5e-5, err_msg=str(k))
    stats = flat(export_jax_variables(pm)["batch_stats"])
    jst = flat(jax.device_get(jstats))
    assert stats.keys() == jst.keys()
    for k in jst:
        np.testing.assert_allclose(stats[k], jst[k], rtol=5e-4, atol=5e-5, err_msg=str(k))


def _cut(cfg):
    return dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin, depths=DEPTHS),
                               htsat=dataclasses.replace(cfg.htsat, depths=DEPTHS))


@pytest.fixture(scope="module")
def whole_model():
    from avmoe_tpu.config import tiny_ave_config as jax_tiny
    from avmoe_tpu.losses.ave import ave_loss as jax_ave_loss
    from avmoe_tpu.models.ave import AVEModel as JAVE

    from avmoe_tpu_torch.config import tiny_ave_config
    from avmoe_tpu_torch.losses.ave import ave_loss
    from avmoe_tpu_torch.models.ave import AVEModel
    from avmoe_tpu_torch.train.freeze import freeze

    cfg = _cut(tiny_ave_config())
    rng = np.random.RandomState(5)
    T = cfg.num_segments
    wave = (0.1 * rng.randn(2, T, cfg.audio_len)).astype(np.float32)
    images = rng.rand(2, T, cfg.swin.img_size, cfg.swin.img_size, 3).astype(np.float32)
    labels = np.eye(cfg.num_classes + 1, dtype=np.float32)[
        rng.randint(0, cfg.num_classes + 1, (2, T))]
    pm = AVEModel(cfg, device="cpu", seed=7, fused_moe=True, fused_moe_train=True)
    with torch.no_grad():   # noised gates and stats: every adapter contributes
        for n, p in pm.named_parameters():
            if n.endswith(("gate", "gate_av")):
                p.copy_(0.5 + 0.2 * torch.from_numpy(rng.randn(*p.shape).astype(np.float32)))
    variables = to_jax(export_jax_variables(pm))
    jm = JAVE(_cut(jax_tiny()))

    def run(params):
        v = {"params": params, "batch_stats": variables["batch_stats"]}
        ev = jm.apply(v, jnp.asarray(wave), jnp.asarray(images), train=False)

        def loss(p):
            out, _ = jm.apply({"params": p, "batch_stats": variables["batch_stats"]},
                              jnp.asarray(wave), jnp.asarray(images), train=True,
                              rngs={"dropout": jax.random.PRNGKey(1),
                                    "specaug": jax.random.PRNGKey(2)},
                              mutable=["batch_stats"])
            return jax_ave_loss(out, jnp.asarray(labels))[0]

        return ev["event_logits"], jax.value_and_grad(loss)(params)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AVMOE_DETERMINISTIC_TRAIN", "1")
        mp.setenv("AVMOE_FUSED_MOE", "1")
        mp.setenv("AVMOE_FUSED_MOE_TRAIN", "1")
        jev, (jloss, jgrads) = jax.device_get(jax.jit(run)(variables["params"]))
        ev = pm(torch.from_numpy(wave), torch.from_numpy(images))["event_logits"]
        out = pm(torch.from_numpy(wave), torch.from_numpy(images), train=True,
                 generator=torch.Generator().manual_seed(0))
        loss, _ = ave_loss(out, torch.from_numpy(labels))
        trainable = freeze(pm)
        loss.backward(inputs=list(trainable.values()))
    return dict(ev=ev.numpy(), jev=np.asarray(jev), loss=float(loss), jloss=float(jloss),
                grads=port_grads(pm, trainable), jgrads=flat(jgrads))


def test_fused_ave_eval_matches_jax(whole_model):
    np.testing.assert_allclose(whole_model["ev"], whole_model["jev"], rtol=2e-3, atol=1e-4)


def test_fused_ave_train_step_matches_jax(whole_model):
    np.testing.assert_allclose(whole_model["loss"], whole_model["jloss"], rtol=5e-3)
    ours, ref = whole_model["grads"], whole_model["jgrads"]
    keep, _ = live(ref)
    trained = [k for k in keep if k in ours]
    assert len(trained) > 50, len(trained)
    for k in trained:
        assert cos(ours[k], ref[k]) >= 0.9999, (k, cos(ours[k], ref[k]))
        bound = 2e-3 * np.abs(ref[k]).max()
        np.testing.assert_allclose(ours[k], ref[k], rtol=0, atol=bound, err_msg=str(k))
