"""One AVS S4 train step's gradients against `jax.grad`, on the CPU, with
HTS-AT trainable.

S4's reference recipe freezes only Swin (its freeze scan matches no HTS-AT
name), so the step trains HTS-AT's weights beside the adapters and the
decoder: frozen_scopes ("swin",). On the CPU the K1 and K2 wrappers'
autograd Functions run the plain backward versions of K1b and K2b, which
give the backbone's weight gradients too (the bias's; the MLP's and
norm2's), as the kernels do on the card.

The tiny S4 config (the 'mha' expert, the first-frame IoU-BCE loss) with
both backbones cut to depths 1-1-1-1, 80-px frames and the (24, 12, 6, 3)
pyramid as in `tests/test_torch_avs.py`, float32, seeded noise weights,
AVMOE_DETERMINISTIC_TRAIN=1, the mixup λ and the router noise given: the
port's loss and its gradient per trainable leaf (read through the
converter) against `jax.value_and_grad` of the JAX package's
`make_avs_loss_fn` over the trainable subtree of `partition_params(params,
("swin",))`.

Tolerances, as cosines (a gradient element is a sum with cancellations, so
elementwise bounds hold the parameters after a step, in
`tests/test_torch_avs_train.py`, not the gradients): the loss rtol 5e-3;
the whole gradient's cosine >= 0.9999; per leaf whose rms is above 1e-4 of
the largest leaf's, >= 0.995; per live leaf below that (rms above 1e-6 of
the largest), >= 0.98; the other leaves at rounding level in the port too.
The weaker tier is the float32 conditioning of those leaves (the temporal
attention's coarsest audio path, ~1e-5 of the largest): a 1e-6 relative
change of the inputs moves the port's own gradient there below a cosine of
0.995, which `test_avs_s4_small_leaves_move_with_a_rounding_sized_input_change`
holds.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from torch_port_harness import port_variables, to_jax
from torch_train_harness import LIVE, cos, flat, live

from avmoe_tpu_torch.convert import export_jax_variables, load_jax_variables

torch.set_num_threads(2)

SWIN_DEPTHS = HTSAT_DEPTHS = (1, 1, 1, 1)
FRAME = 80
SCOPES = ("swin",)


def _s4(cfg):
    return dataclasses.replace(
        cfg, pyramid_sizes=(24, 12, 6, 3), mask_size=96,
        swin=dataclasses.replace(cfg.swin, depths=SWIN_DEPTHS),
        htsat=dataclasses.replace(cfg.htsat, depths=HTSAT_DEPTHS))


@pytest.fixture(scope="module")
def grads():
    from avmoe_tpu import config as jc
    from avmoe_tpu.models.avs import AVSModel as JAVS, make_avs_loss_fn as j_loss_fn
    from avmoe_tpu.train.freeze import partition_params

    import avmoe_tpu_torch.moe.adapter as adapter
    from avmoe_tpu_torch import config as pc
    from avmoe_tpu_torch.models.avs import AVSModel, make_avs_loss_fn
    from avmoe_tpu_torch.train.freeze import freeze

    jcfg = _s4(jc.tiny_avs_config())
    rng = np.random.RandomState(0)
    B, T = 2, jcfg.num_segments
    batch = dict(images=rng.rand(B, T, FRAME, FRAME, 3).astype(np.float32),
                 wave=rng.randn(B, T, jcfg.audio_len).astype(np.float32) * 0.1,
                 mask=(rng.rand(B, 96, 96) > 0.6).astype(np.float32),
                 mixup_lambda=rng.uniform(0.3, 0.7, size=B * T).astype(np.float32))
    noise = rng.randn(B * T, 2).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AVMOE_DETERMINISTIC_TRAIN", "1")
        mp.delenv("AVMOE_FUSED_MOE_TRAIN", raising=False)
        jm = JAVS(jcfg)
        pm = AVSModel(_s4(pc.tiny_avs_config()), device="cpu", seed=None)
        variables = port_variables(pm, seed=5)     # the tree test_torch_avs.py holds equal
        trainable, frozen = partition_params(to_jax(variables["params"]), SCOPES)
        loss_fn = j_loss_fn(jm)

        def jloss(tr):
            from avmoe_tpu.train.freeze import merge_params

            v = {"params": merge_params(tr, frozen), "batch_stats": variables["batch_stats"]}
            loss, (aux, _) = loss_fn(v, {k: jnp.asarray(x) for k, x in batch.items()},
                                     {k: jax.random.PRNGKey(i) for i, k in enumerate(
                                         ("dropout", "specaug", "router", "gumbel"))})
            return loss

        mp.setattr(jax.random, "normal", lambda key, shape, *a, **k: jnp.asarray(noise))
        j_loss, j_grads = jax.jit(jax.value_and_grad(jloss))(trainable)
        j_grads = flat(jax.tree_util.tree_map(np.asarray, j_grads))

        mp.setattr(adapter, "router_noise",
                   lambda shape, generator, device: torch.from_numpy(noise).to(device))
        load_jax_variables(pm, variables)
        params = freeze(pm, SCOPES)
        kept = {n: p.detach().clone() for n, p in params.items()}

        def port_grads(eps: float):
            """The port's loss and gradients, the frames and waves scaled
            elementwise by 1 + eps * seeded noise."""
            r = np.random.RandomState(1)
            b = {k: torch.from_numpy(v) for k, v in batch.items()}
            for k in ("images", "wave"):
                b[k] = b[k] * (1 + eps * torch.from_numpy(r.randn(*b[k].shape).astype(np.float32)))
            loss, _ = make_avs_loss_fn(pm)(pm, b, torch.Generator().manual_seed(0))
            g = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            with torch.no_grad():
                for (n, p), gi in zip(params.items(), g):
                    p.copy_(torch.zeros_like(p) if gi is None else gi)
                out = flat(export_jax_variables(pm, trainable_only=True,
                                                frozen_scopes=SCOPES)["params"])
                for n, p in params.items():
                    p.copy_(kept[n])
            return float(loss), out

        loss, ours = port_grads(0.0)
        _, ours_eps = port_grads(1e-6)
    return dict(loss=loss, j_loss=float(j_loss), ours=ours, ours_eps=ours_eps, ref=j_grads)


def test_avs_s4_loss_matches_jax(grads):
    assert grads["loss"] == pytest.approx(grads["j_loss"], rel=5e-3)


def _tiers(ref):
    """(leaves above 1e-4 of the largest rms, the other live leaves, the
    largest rms)."""
    alive, top = live(ref)
    strong = {k for k in alive if np.sqrt(np.mean(ref[k] ** 2)) > 1e-4 * top}
    return strong, alive - strong, top


def test_avs_s4_trains_htsat_and_its_gradients_match_jax_per_leaf(grads):
    ours, ref = grads["ours"], grads["ref"]
    assert set(ours) == set(ref)
    htsat = {k for k in ref if k[:2] == ("encoder", "htsat")}
    assert len(htsat) > 20 and not any(k[:2] == ("encoder", "swin") for k in ref)
    strong, weak, top = _tiers(ref)
    assert len((strong | weak) & htsat) > 0.9 * len(htsat) and len(strong) > 0.5 * len(ref)
    keys = sorted(ref)
    assert cos(np.concatenate([ours[k].ravel() for k in keys]),
               np.concatenate([ref[k].ravel() for k in keys])) >= 0.9999
    c = {k: cos(ours[k], ref[k]) for k in strong}
    assert all(v >= 0.995 for v in c.values()), min(c.items(), key=lambda kv: kv[1])
    c = {k: cos(ours[k], ref[k]) for k in weak}
    assert all(v >= 0.98 for v in c.values()), min(c.items(), key=lambda kv: kv[1])
    for k in set(ref) - strong - weak:
        assert np.sqrt(np.mean(ours[k] ** 2)) <= LIVE * top, k


def test_avs_s4_small_leaves_move_with_a_rounding_sized_input_change(grads):
    """Why the weaker tier: a 1e-6 relative change of the frames and waves
    leaves the port's gradient of every leaf above 1e-4 of the largest at a
    cosine >= 0.995, and moves some leaf below it under that size."""
    ours, moved, ref = grads["ours"], grads["ours_eps"], grads["ref"]
    strong, weak, _ = _tiers(ref)
    assert min(cos(ours[k], moved[k]) for k in strong) >= 0.995
    assert min(cos(ours[k], moved[k]) for k in weak) < 0.995
