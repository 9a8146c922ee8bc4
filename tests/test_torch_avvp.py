"""The AVVP slice as a whole: the port's tiny MGNModel eval forward on both
paths vs the JAX package's MGNModel on the same seeded weights and inputs
(every output key, the gating probs and the summed lb_loss), the converter's
round trip over the MGN tree, the configs, the eval closure's F1 suite and
the injection plan at AVVPConfig().

One JAX MGN compile for the file (a module-scoped fixture).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from torch_port_harness import FWD_TOL, jax_variables, max_err, to_jax

from avmoe_tpu_torch.convert import export_jax_variables, load_jax_variables

torch.set_num_threads(2)

OUT_KEYS = ["aud_cls_logits", "vis_cls_logits", "global_prob", "a_prob", "v_prob",
            "a_frame_prob", "v_frame_prob"]
GATING_KEYS = ["audio_p1", "audio_p2", "video_p1", "video_p2"]


def _inputs(cfg, clips: int, seed: int):
    rng = np.random.RandomState(seed)
    T = cfg.num_segments
    return (rng.randn(clips, T, cfg.audio_len).astype(np.float32) * 0.1,
            rng.rand(clips, T, cfg.swin.img_size, cfg.swin.img_size, 3).astype(np.float32),
            rng.randn(clips, T, cfg.st_dim).astype(np.float32))


@pytest.fixture(scope="module")
def mgn():
    from avmoe_tpu.config import tiny_avvp_config as jax_tiny
    from avmoe_tpu.models.avvp import MGNModel as JMGN

    from avmoe_tpu_torch.config import tiny_avvp_config
    from avmoe_tpu_torch.models.avvp import MGNModel

    jcfg = jax_tiny()
    wave, imgs, st = _inputs(jcfg, 2, 0)
    jm = JMGN(jcfg)
    variables = jax_variables(jm, jnp.asarray(wave), jnp.asarray(imgs), jnp.asarray(st), seed=1)
    ref = jax.jit(lambda v, w, i, s: jm.apply(v, w, i, s))(
        to_jax(variables), jnp.asarray(wave), jnp.asarray(imgs), jnp.asarray(st))
    pm = MGNModel(tiny_avvp_config(), device="cpu", seed=None)
    load_jax_variables(pm, variables)
    ins = tuple(torch.from_numpy(a) for a in (wave, imgs, st))
    return dict(variables=variables, ref=jax.tree_util.tree_map(np.asarray, ref),
                out=pm(*ins), model=pm, ins=ins)


@pytest.mark.parametrize("key", OUT_KEYS)
def test_tiny_mgn_forward_matches_jax(mgn, key):
    ours, ref = mgn["out"][key].numpy(), mgn["ref"][key]
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, **FWD_TOL)


def test_tiny_mgn_output_shapes_and_keys(mgn):
    out, T = mgn["out"], 2
    assert set(out) == set(mgn["ref"])
    assert out["aud_cls_logits"].shape == out["vis_cls_logits"].shape == (25, 25)
    for key in ("global_prob", "a_prob", "v_prob"):
        assert out[key].shape == (2, 25)
    for key in ("a_frame_prob", "v_frame_prob"):
        assert out[key].shape == (2, T, 25)


@pytest.mark.parametrize("key", GATING_KEYS)
def test_tiny_mgn_gating_probs_match_jax(mgn, key):
    ours, ref = mgn["out"]["telemetry"][key].numpy(), mgn["ref"]["telemetry"][key]
    # adapters in all four stages: 12 sites at the tiny depths too
    assert ours.shape == ref.shape == (12, 4, 2)
    np.testing.assert_allclose(ours, ref, **FWD_TOL)
    assert np.abs(ours - 0.5).max() > 1e-3


def test_tiny_mgn_lb_loss_matches_jax(mgn):
    ours, ref = float(mgn["out"]["telemetry"]["lb_loss"]), float(mgn["ref"]["telemetry"]["lb_loss"])
    # compat magnitude: -sum(log mean_p) per call, summed over 4 x 12 calls
    assert ours > 48 * 2 * np.log(2) - 1e-3
    assert ours == pytest.approx(ref, rel=5e-3)


@pytest.fixture(scope="module")
def chain_out(mgn):
    from avmoe_tpu_torch.config import tiny_avvp_config
    from avmoe_tpu_torch.kernels.block_chain import block_chain
    from avmoe_tpu_torch.models.avvp import MGNModel

    pm = MGNModel(tiny_avvp_config(), device="cpu", seed=None, block_chains=True)
    pm.load_state_dict(mgn["model"].state_dict())
    before = block_chain.launches
    out = pm(*mgn["ins"])
    assert block_chain.launches == before      # CPU tensors take the plain version
    return out


@pytest.mark.parametrize("key", OUT_KEYS + GATING_KEYS + ["lb_loss"])
def test_tiny_mgn_block_chains_match_jax_and_default_path(mgn, chain_out, key):
    tele = key in GATING_KEYS or key == "lb_loss"
    ours = (chain_out["telemetry"] if tele else chain_out)[key].numpy()
    ref = (mgn["ref"]["telemetry"] if tele else mgn["ref"])[key]
    default = (mgn["out"]["telemetry"] if tele else mgn["out"])[key].numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, **FWD_TOL)
    np.testing.assert_allclose(ours, default, rtol=1e-4, atol=1e-4)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_convert_round_trip_gives_back_the_jax_tree(mgn):
    """load_jax_variables then export_jax_variables: the same tree, leaf for
    leaf, bit for bit (the top-level class tokens, the (in, out) Dense
    kernels of the heads, the expert axis of the bmm experts' gate_av)."""
    variables = mgn["variables"]
    back = export_jax_variables(mgn["model"])
    want = dict(_flat(variables["params"]))
    got = dict(_flat(back["params"]))
    assert set(got) == set(want)
    for path, v in want.items():
        assert got[path].shape == v.shape, path
        np.testing.assert_array_equal(got[path], v, err_msg="/".join(path))
    # no BatchNorm in the AVVP adapters, and the backbones' BN is bn0 alone
    assert {p[-2] for p, _ in _flat(back["batch_stats"])} <= {"bn0"}
    for key in [("audio_token",), ("visual_token",), ("fc_cls", "kernel"),
                ("encoder", "audio_moe_p1_0", "singlemodal_experts", "gate_av")]:
        assert key in got, key
    assert got[("encoder", "audio_moe_p1_0", "singlemodal_experts", "gate_av")].shape == (1, 1)


def test_configs_match_jax_field_by_field():
    from avmoe_tpu import config as jc

    from avmoe_tpu_torch import config as pc

    def same(a, b):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        for sub in db.values():
            if isinstance(sub, dict):
                for key in ("remat", "remat_policy", "token_shard_axis"):
                    sub.pop(key, None)
        assert da == db

    same(pc.AVVPConfig(), jc.AVVPConfig())
    same(pc.tiny_avvp_config(), jc.tiny_avvp_config())
    same(pc.mini_avvp_config(), jc.mini_avvp_config())


def test_eval_fn_f1_summary_matches_the_jax_evaluator(mgn):
    from avmoe_tpu.metrics.avvp import AVVPEvaluator as JEvaluator

    from avmoe_tpu_torch.metrics.avvp import AVVPEvaluator
    from avmoe_tpu_torch.models.avvp import make_avvp_eval_fn

    rng = np.random.RandomState(4)
    grids = {k: (rng.rand(25, 2) < 0.3).astype(np.int64) for k in range(3)}
    gt_a, gt_v = {0: grids[0], 1: grids[1]}, {0: grids[2]}     # clip 1 has no visual grid
    ev = AVVPEvaluator()
    res = make_avvp_eval_fn(mgn["model"], gt_a, gt_v)(
        {"wave": mgn["ins"][0], "images": mgn["ins"][1], "video_st": mgn["ins"][2],
         "clip_index": torch.tensor([0, 1])}, ev)
    assert set(res["telemetry"]) == set(mgn["ref"]["telemetry"])
    ref = JEvaluator()
    zeros = np.zeros((25, 2), np.int64)
    for i in range(2):
        ref.add_clip(mgn["ref"]["global_prob"][i], mgn["ref"]["a_frame_prob"][i],
                     mgn["ref"]["v_frame_prob"][i], gt_a.get(i, zeros), gt_v.get(i, zeros))
    ours, want = ev.summary(), ref.summary()
    assert set(ours) == set(want) and len(ours) == 10
    for k in want:
        assert np.isfinite(ours[k])
        assert ours[k] == pytest.approx(want[k]), k


def test_mgn_model_raises_when_cuda_is_asked_for_and_absent():
    from avmoe_tpu_torch.config import tiny_avvp_config
    from avmoe_tpu_torch.models.avvp import MGNModel

    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="cuda"):
        MGNModel(tiny_avvp_config())


def test_mgn_chain_path_refuses_to_train(mgn):
    from avmoe_tpu_torch.config import tiny_avvp_config
    from avmoe_tpu_torch.models.avvp import MGNModel

    pm = MGNModel(tiny_avvp_config(), device="cpu", seed=0, block_chains=True)
    with pytest.raises(NotImplementedError, match="eval only"):
        pm(*mgn["ins"], train=True, generator=torch.Generator())
