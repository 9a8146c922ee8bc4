"""AVQA's grounding stage: the port's tiny AVQAGroundingModel against the JAX
package's on the same seeded weights and inputs. HTS-AT's and Swin-V2's
`forward_features` (captured inside the JAX forward) and the match logits in
eval and in train mode (draws off through AVMOE_DETERMINISTIC_TRAIN=1 on
both sides, DropPath's rate 0 in the tiny configs: bn0 normalizes with the
batch's statistics and updates its running ones), the loss, the accuracy and
the heads' gradients against `jax.grad`, the converter's round trip over
the grounding tree, the launch plan at AVQAConfig(), and the stage-B graft
of the heads against the JAX package's `load_partial`.

One JAX compile for the file (a module-scoped fixture), both backbones cut
to depths 2-2-2-2: the grounding model has no adapters, so no check reads
the depth (the feature shapes and the heads do not depend on it);
tolerance rtol 2e-3, atol 1e-4 (the JAX suite's activation tolerance).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from torch_port_harness import FWD_TOL, jax_variables, port_variables, to_jax

from avmoe_tpu_torch.convert import export_jax_variables, load_jax_variables

torch.set_num_threads(2)

HEADS = ("fc_a1", "fc_a2", "fc_gl", "fc1", "fc2", "fc3", "fc4")
B = 3                      # segments: one sample each
DEPTHS = (2, 2, 2, 2)


def _inputs(cfg, seed: int):
    rng = np.random.RandomState(seed)
    S = cfg.swin.img_size
    return (rng.randn(B, cfg.audio_len).astype(np.float32) * 0.1,
            rng.rand(B, S, S, 3).astype(np.float32), rng.rand(B, S, S, 3).astype(np.float32))


def _cut(cfg):
    return dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin, depths=DEPTHS),
                               htsat=dataclasses.replace(cfg.htsat, depths=DEPTHS))


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)) if isinstance(v, dict) else {prefix + (k,): v})
    return out


@pytest.fixture(scope="module")
def grd():
    from avmoe_tpu.config import tiny_avqa_config as jax_tiny
    from avmoe_tpu.models.avqa_grounding import AVQAGroundingModel as JGrd
    from avmoe_tpu.models.avqa_grounding import make_grounding_loss_fn as j_loss_fn

    jcfg = _cut(jax_tiny())
    ins = _inputs(jcfg, 0)
    jm = JGrd(jcfg)
    variables = jax_variables(jm, *map(jnp.asarray, ins), seed=5)
    capture = lambda mdl, name: name == "forward_features"
    rngs = {"dropout": jax.random.PRNGKey(1), "specaug": jax.random.PRNGKey(2)}
    loss_fn = j_loss_fn(jm)

    def run(v, wave, posi, nega):
        ev, inter = jm.apply(v, wave, posi, nega, train=False, capture_intermediates=capture,
                             mutable=["intermediates"])
        tr, upd = jm.apply(v, wave, posi, nega, train=True, rngs=rngs,
                           capture_intermediates=capture, mutable=["batch_stats", "intermediates"])
        heads = {k: v["params"][k] for k in HEADS}

        def loss_of(h):
            params = {**v["params"], **h}
            loss, (aux, _) = loss_fn({"params": params, "batch_stats": v["batch_stats"]},
                                     {"wave": wave, "posi": posi, "nega": nega}, rngs)
            return loss, aux

        (loss, aux), grads = jax.value_and_grad(loss_of, has_aux=True)(heads)
        return ev, inter["intermediates"], tr, upd, loss, aux, grads

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AVMOE_DETERMINISTIC_TRAIN", "1")
        res = jax.jit(run)(to_jax(variables), *map(jnp.asarray, ins))
    ev, inter, tr, upd, loss, aux, grads = jax.tree_util.tree_map(np.asarray, res)
    return dict(variables=variables, ins=tuple(torch.from_numpy(a) for a in ins), ev=ev,
                inter=inter, tr=tr, bstats=upd["batch_stats"], inter_train=upd["intermediates"],
                loss=float(loss), accuracy=float(aux["accuracy"]), grads=grads)


def _port(grd):
    from avmoe_tpu_torch.config import tiny_avqa_config
    from avmoe_tpu_torch.models.avqa_grounding import AVQAGroundingModel

    pm = AVQAGroundingModel(_cut(tiny_avqa_config()), device="cpu", seed=None)
    load_jax_variables(pm, grd["variables"])
    return pm


@pytest.mark.parametrize("key", ["match_posi", "match_nega"])
def test_eval_forward_matches_jax(grd, key):
    out = _port(grd)(*grd["ins"])
    assert out[key].shape == (B, 2)
    np.testing.assert_allclose(out[key].numpy(), grd["ev"][key], **FWD_TOL)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_htsat_forward_features_matches_jax(grd, train, monkeypatch):
    """No adapters and no final norm; in train bn0 takes the batch's stats."""
    monkeypatch.setenv("AVMOE_DETERMINISTIC_TRAIN", "1")
    htsat = _port(grd).htsat
    with torch.no_grad():
        ours = htsat.forward_features(htsat.embed(grd["ins"][0], train=train), train=train)
    inter = grd["inter_train"] if train else grd["inter"]
    ref = inter["htsat"]["forward_features"][0]
    assert ours.shape == ref.shape == (B, 4, 128)
    np.testing.assert_allclose(ours.numpy(), ref, **FWD_TOL)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_swin_forward_features_match_jax(grd, train):
    """The positive and the negative frames' grids, after the final norm."""
    swin = _port(grd).swin
    for frames, ref in zip(grd["ins"][1:], (grd["inter_train"] if train else grd["inter"])
                           ["swin"]["forward_features"]):
        with torch.no_grad():
            ours = swin.forward_features(swin.embed(frames), train=train)
        np.testing.assert_allclose(ours.numpy(), ref, **FWD_TOL)


def test_train_forward_loss_accuracy_and_bn0_stats_match_jax(grd, monkeypatch):
    from avmoe_tpu_torch.models.avqa_grounding import make_grounding_loss_fn

    monkeypatch.setenv("AVMOE_DETERMINISTIC_TRAIN", "1")
    pm = _port(grd)
    wave, posi, nega = grd["ins"]
    out = pm(wave, posi, nega, train=True)
    for key in ("match_posi", "match_nega"):
        np.testing.assert_allclose(out[key].detach().numpy(), grd["tr"][key], **FWD_TOL)
    bn0 = grd["bstats"]["htsat"]["bn0"]
    np.testing.assert_allclose(pm.htsat.bn0.running_mean.numpy(), bn0["mean"], **FWD_TOL)
    np.testing.assert_allclose(pm.htsat.bn0.running_var.numpy(), bn0["var"], **FWD_TOL)
    assert not np.allclose(bn0["mean"], grd["variables"]["batch_stats"]["htsat"]["bn0"]["mean"])

    pm = _port(grd)
    loss, aux = make_grounding_loss_fn(pm)(pm, {"wave": wave, "posi": posi, "nega": nega}, None)
    assert float(loss.detach()) == pytest.approx(grd["loss"], rel=2e-3)
    assert float(aux["accuracy"]) == pytest.approx(grd["accuracy"], rel=1e-6)   # percent


def test_head_gradients_match_jax_grad(grd, monkeypatch):
    """Only the heads train; the backbones give no gradient."""
    from avmoe_tpu_torch.models.avqa_grounding import make_grounding_loss_fn
    from avmoe_tpu_torch.train.freeze import freeze

    monkeypatch.setenv("AVMOE_DETERMINISTIC_TRAIN", "1")
    pm = _port(grd)
    trainable = freeze(pm)
    assert {n.split(".")[0] for n in trainable} == set(HEADS)
    wave, posi, nega = grd["ins"]
    loss, _ = make_grounding_loss_fn(pm)(pm, {"wave": wave, "posi": posi, "nega": nega}, None)
    grads = dict(zip(trainable, torch.autograd.grad(loss, list(trainable.values()))))
    for name, g in grads.items():
        mod, leaf = name.split(".")
        ref = grd["grads"][mod]["kernel" if leaf == "weight" else "bias"]
        ours = g.numpy().T if leaf == "weight" else g.numpy()
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(ours, ref, rtol=2e-3, atol=1e-4 * scale, err_msg=name)
        assert scale > 0, name


def test_converter_round_trip_over_the_grounding_tree(grd):
    """The flax tree of the grounding model: HTS-AT without norm, tscam_conv
    and head (the forward never reads them), Swin-V2 with its final norm."""
    ours = _flat(export_jax_variables(_port(grd)))
    want = _flat(grd["variables"])
    assert set(ours) == set(want)
    assert not any(k[:3] == ("params", "htsat", "norm") for k in want)
    for k in want:
        np.testing.assert_array_equal(ours[k], want[k], err_msg="/".join(k))


def test_grounding_launch_plan():
    from avmoe_tpu_torch.config import AVQAConfig
    from avmoe_tpu_torch.models.avqa_grounding import grounding_kernel_launches

    assert grounding_kernel_launches(AVQAConfig()) == {"K1": 60, "K2": 60, "K3": 0}


def test_stage_b_graft_matches_jax_load_partial(grd, tmp_path):
    """The CLI's graft of a port grounding checkpoint into the fusion model
    equals the JAX CLI's `load_partial` with its include regex on the same
    trees: the seven heads from the grounding model, the rest untouched."""
    from avmoe_tpu.checkpoint.manager import CheckpointManager as JManager
    from avmoe_tpu.train.freeze import partition_params

    from avmoe_tpu_torch.cli.train_avqa import load_grounding_heads
    from avmoe_tpu_torch.config import tiny_avqa_config
    from avmoe_tpu_torch.models.avqa import AVQAFusionModel

    fus = AVQAFusionModel(tiny_avqa_config(), device="cpu", seed=None)
    fus_vars = port_variables(fus, seed=11)
    load_jax_variables(fus, fus_vars)
    donor, _ = partition_params(grd["variables"]["params"])
    want = JManager.load_partial(fus_vars["params"], donor,
                                 include=r"^(fc_a1|fc_a2|fc_gl|fc1|fc2|fc3|fc4)/")

    step = tmp_path / "7"
    step.mkdir()
    torch.save({"model": _port(grd).state_dict()}, step / "state.pt")
    load_grounding_heads(fus, str(tmp_path))              # the run's directory: its latest step
    got = _flat(export_jax_variables(fus)["params"])
    want = _flat(want)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg="/".join(k))
    for head in HEADS:
        np.testing.assert_array_equal(got[(head, "kernel")],
                                      grd["variables"]["params"][head]["kernel"])
    np.testing.assert_array_equal(got[("fc_ans", "kernel")],
                                  fus_vars["params"]["fc_ans"]["kernel"])
