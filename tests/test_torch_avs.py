"""The AVS slice as a whole: the port's tiny S4 AVSModel eval forward on both
paths vs the JAX package's AVSModel on the same seeded weights and inputs
(the mask logits, every feature_map_list and a_fea_list entry, the stage
tokens the encoder collects, the gating probs and lb_loss), the converter's
round trip over the AVS tree, the configs (MS3 against the JAX CLI's
build_config), the eval closure's metrics and the launch plan at
AVSConfig().

The config is tiny_avs_config() with the pyramid at (24, 12, 6, 3), 96-px
masks and 80-px frames, so that both resizes run as they do at full width
(frames 224 -> 192, stage maps 48 -> 56): the stock tiny config resizes
nothing (its frames are Swin's 64 px and its pyramid is Swin's grid).

One JAX compile for the file (a module-scoped fixture); the stage tokens
come from the JAX forward itself, stashed by a method interceptor (the
model pops them from the encoder's telemetry). Tolerance rtol 2e-3, atol
1e-4 (the JAX suite's activation tolerance).
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from torch_port_harness import FWD_TOL, jax_variables, to_jax

from avmoe_tpu_torch.convert import export_jax_variables, load_jax_variables

torch.set_num_threads(2)

GATING_KEYS = ["audio_p1", "audio_p2", "video_p1", "video_p2"]
FRAME = 80


def _cfg(pkg):
    return dataclasses.replace(pkg.tiny_avs_config(), pyramid_sizes=(24, 12, 6, 3),
                               mask_size=96)


def _inputs(cfg, clips: int, seed: int):
    rng = np.random.RandomState(seed)
    T = cfg.num_segments
    return (rng.rand(clips, T, FRAME, FRAME, 3).astype(np.float32),
            rng.randn(clips, T, cfg.audio_len).astype(np.float32) * 0.1)


def _stash_stage_tokens(next_fun, args, kwargs, context):
    out = next_fun(*args, **kwargs)
    if context.method_name == "forward_tokens" and kwargs.get("collect_stages"):
        context.module.sow("intermediates", "stage_tokens", tuple(out[2]["stage_tokens"]))
    return out


@pytest.fixture(scope="module")
def avs():
    import flax.linen as fnn

    from avmoe_tpu import config as jc
    from avmoe_tpu.models.avs import AVSModel as JAVS

    from avmoe_tpu_torch import config as pc
    from avmoe_tpu_torch.models.avs import AVSModel

    jcfg = _cfg(jc)
    ins = _inputs(jcfg, 2, 0)
    jm = JAVS(jcfg)
    variables = jax_variables(jm, *map(jnp.asarray, ins), seed=1)
    with fnn.intercept_methods(_stash_stage_tokens):
        ref, inter = jax.jit(lambda v, *a: jm.apply(v, *a, mutable=["intermediates"]))(
            to_jax(variables), *map(jnp.asarray, ins))
    pm = AVSModel(_cfg(pc), device="cpu", seed=None)
    load_jax_variables(pm, variables)
    tins = tuple(torch.from_numpy(a) for a in ins)
    tokens = inter["intermediates"]["encoder"]["stage_tokens"][0]
    return dict(variables=variables, ref=jax.tree_util.tree_map(np.asarray, ref),
                tokens=[np.asarray(t) for t in tokens], out=pm(*tins), model=pm, ins=tins)


@pytest.fixture(scope="module")
def chain_out(avs):
    from avmoe_tpu_torch import config as pc
    from avmoe_tpu_torch.kernels.block_chain import block_chain
    from avmoe_tpu_torch.models.avs import AVSModel

    pm = AVSModel(_cfg(pc), device="cpu", seed=None, block_chains=True)
    pm.load_state_dict(avs["model"].state_dict())
    before = block_chain.launches
    out = pm(*avs["ins"])
    assert block_chain.launches == before        # CPU tensors take the plain version
    return out


PATHS = pytest.mark.parametrize("path", ["default", "chain"])


def _out(avs, chain_out, path):
    return chain_out if path == "chain" else avs["out"]


@PATHS
def test_tiny_avs_mask_logits_match_jax(avs, chain_out, path):
    ours, ref = _out(avs, chain_out, path)["mask_logits"].numpy(), avs["ref"]["mask_logits"]
    assert ours.shape == ref.shape == (4, 96, 96)
    np.testing.assert_allclose(ours, ref, **FWD_TOL)
    assert ref.std() > 1e-2


@PATHS
@pytest.mark.parametrize("i", range(4))
def test_tiny_avs_feature_maps_match_jax(avs, chain_out, path, i):
    """The pyramid maps after TPAVI, relu'd as the reference leaves them."""
    ours = _out(avs, chain_out, path)["feature_map_list"][i].numpy()
    ref = avs["ref"]["feature_map_list"][i]
    size = (24, 12, 6, 3)[i]
    assert ours.shape == ref.shape == (4, size, size, 32)
    np.testing.assert_allclose(ours, ref, **FWD_TOL)
    assert ours.min() == 0.0 and (ours == 0).mean() > 0.1     # the ReLU bites


@PATHS
@pytest.mark.parametrize("i", range(4))
def test_tiny_avs_aligned_audio_matches_jax(avs, chain_out, path, i):
    ours = _out(avs, chain_out, path)["a_fea_list"][i].numpy()
    ref = avs["ref"]["a_fea_list"][i]
    assert ours.shape == ref.shape == (2, 2, 32)
    np.testing.assert_allclose(ours, ref, **FWD_TOL)


@PATHS
@pytest.mark.parametrize("i", range(4))
def test_tiny_avs_stage_tokens_match_jax(avs, path, i):
    """forward_tokens(collect_stages=True): stage i's visual tokens before its
    downsample, the last stage's after the final norm."""
    model = avs["model"]
    images, wave = avs["ins"]
    from avmoe_tpu_torch.heads.avs import resize_bicubic

    model.encoder.block_chains = path == "chain"
    try:
        with torch.no_grad():
            imgs = resize_bicubic(images.reshape(4, FRAME, FRAME, 3), 64, 64)
            f_v, _, tele = model.encoder.forward_tokens(wave.reshape(4, -1), imgs,
                                                        collect_stages=True)
    finally:
        model.encoder.block_chains = False
    ours, ref = tele["stage_tokens"][i].numpy(), avs["tokens"][i]
    assert ours.shape == ref.shape == (4, (16 // 2 ** i) ** 2, 16 * 2 ** i)
    np.testing.assert_allclose(ours, ref, **FWD_TOL)
    if i == 3:
        np.testing.assert_array_equal(ours, f_v.numpy())


@PATHS
@pytest.mark.parametrize("key", GATING_KEYS + ["lb_loss"])
def test_tiny_avs_gating_and_lb_loss_match_jax(avs, chain_out, path, key):
    ours = _out(avs, chain_out, path)["telemetry"][key].numpy()
    ref = avs["ref"]["telemetry"][key]
    assert ours.shape == ref.shape == (() if key == "lb_loss" else (12, 4, 2))
    np.testing.assert_allclose(ours, ref, **FWD_TOL)


def test_tiny_avs_chain_path_matches_the_default_path(avs, chain_out):
    np.testing.assert_allclose(chain_out["mask_logits"].numpy(),
                               avs["out"]["mask_logits"].numpy(), rtol=1e-4, atol=1e-4)


def test_tpavi_zero_init_would_hide_it_so_the_test_weights_are_noised(avs):
    """flax starts TPAVI's W_z_bn scale at zero, which makes TPAVI the
    identity plus LayerNorm: the parity weights carry a noised scale, and
    the port's own seeded init keeps flax's zeros."""
    from avmoe_tpu_torch import config as pc
    from avmoe_tpu_torch.models.avs import AVSModel

    scales = [avs["variables"]["params"][f"tpavi_b{i}"]["W_z_bn"]["scale"] for i in (1, 2, 3, 4)]
    assert all(np.abs(s).min() > 0.5 for s in scales)
    fresh = AVSModel(_cfg(pc), device="cpu", seed=0)
    for m in fresh.tpavi.values():
        assert torch.count_nonzero(m.W_z_bn.weight) == 0
        assert torch.count_nonzero(m.W_z_conv.kernel) == 0


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_convert_round_trip_gives_back_the_jax_tree(avs):
    """load then export: the same tree bit for bit, in both collections
    (conv kernels HWIO, TPAVI's (1, 1, 1, in, out) W_z_conv, the stacked
    MHA kernels with the expert axis first, W_z_bn's running stats)."""
    variables = avs["variables"]
    back = export_jax_variables(avs["model"])
    for col in ("params", "batch_stats"):
        want, got = dict(_flat(variables[col])), dict(_flat(back[col]))
        assert set(got) == set(want), col
        for path, v in want.items():
            assert got[path].shape == v.shape, path
            np.testing.assert_array_equal(got[path], v, err_msg="/".join(path))
    p = dict(_flat(back["params"]))
    mha = ("encoder", "vis_moe_p1_0", "singlemodal_experts", "self_attention")
    assert p[mha + ("query", "kernel")].shape == (1, 16, 4, 4)
    assert p[mha + ("out", "kernel")].shape == (1, 4, 4, 16)
    assert p[("path_0", "res1", "conv1", "kernel")].shape == (3, 3, 32, 32)
    assert p[("out_conv3", "kernel")].shape == (1, 1, 32, 1)
    assert p[("tpavi_b1", "W_z_conv", "kernel")].shape == (1, 1, 1, 16, 32)
    assert ("path_3", "res1", "conv1", "kernel") not in p       # the coarsest takes no skip
    assert ("encoder", "audio_moe_p1_0", "singlemodal_experts", "gate") not in p
    assert ("encoder", "vis_moe_p1_0", "singlemodal_experts", "gate") in p


def _cli_args(setting: str, tiny: bool):
    return types.SimpleNamespace(
        mini=False, tiny=tiny, setting=setting, sa_loss_flag=False, no_sa_loss=False,
        tpavi_stages=[0, 1, 2, 3], lambda_1=None, sa_loss_kind=None, sa_norm_fea=None,
        sa_threshold=None, closer_loss=False, masked_av_stages=None,
        load_balancing_loss_weight=None)


def test_configs_match_jax_field_by_field():
    from avmoe_tpu import config as jc
    from avmoe_tpu.cli.train_avs import build_config

    from avmoe_tpu_torch import config as pc

    def same(a, b):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        for sub in db.values():
            if isinstance(sub, dict):
                for key in ("remat", "remat_policy", "token_shard_axis"):
                    sub.pop(key, None)
        assert da == db

    same(pc.AVSConfig(), jc.AVSConfig())
    same(pc.tiny_avs_config(), jc.tiny_avs_config())
    same(pc.mini_avs_config(), jc.mini_avs_config())
    for tiny in (False, True):
        base = pc.tiny_avs_config() if tiny else pc.AVSConfig()
        same(base, build_config(_cli_args("s4", tiny)))
        same(pc.ms3_config(base), build_config(_cli_args("ms3", tiny)))


def test_eval_fn_metrics_match_the_jax_metrics(avs):
    from avmoe_tpu.metrics.avs import eval_fmeasure, mask_iou

    from avmoe_tpu_torch.models.avs import make_avs_eval_fn

    logits = avs["ref"]["mask_logits"]
    gt = (logits > np.median(logits)).astype(np.float32)
    gt[1] = 0.0                                            # an empty ground truth
    images, wave = avs["ins"]
    res = make_avs_eval_fn(avs["model"])(dict(images=images, wave=wave,
                                              mask=torch.from_numpy(gt).reshape(2, 2, 96, 96)))
    assert set(res["telemetry"]) == set(avs["ref"]["telemetry"])
    assert float(res["miou"]) == pytest.approx(float(mask_iou(jnp.asarray(logits), gt)),
                                               rel=1e-3)
    assert float(res["fmeasure"]) == pytest.approx(
        float(eval_fmeasure(jnp.asarray(logits), gt)), rel=1e-3)


# AVSConfig(): adapters in every stage (num_skip=1), AVVP's 12 sites; the
# decoder runs no kernel; the step's backward is the encoder's
AVS_PLAN = {"sites": 12, "adapter calls": 48, "experts": 2, "K1": 36, "K2": 36, "K3": 0,
            "chain K1": 0, "chain K2": 12, "chain K3": 30, "K1b": 34, "K2b": 35}


@pytest.mark.parametrize("what", sorted(AVS_PLAN))
def test_avs_launch_plan(what):
    from avmoe_tpu_torch.config import AVSConfig
    from avmoe_tpu_torch.models.avs import avs_kernel_launches
    from avmoe_tpu_torch.moe.injection import backward_launches, plan_injection

    cfg = AVSConfig()
    sites = plan_injection(cfg.swin, cfg.htsat, cfg.injection)
    got = {"sites": len(sites), "adapter calls": 4 * len(sites),
           "experts": cfg.moe.num_experts, **avs_kernel_launches(cfg, False),
           **{f"chain {k}": v for k, v in avs_kernel_launches(cfg, True).items()},
           **backward_launches(cfg.swin, cfg.htsat, cfg.injection)}
    assert got[what] == AVS_PLAN[what]


def test_avs_model_raises_when_cuda_is_asked_for_and_absent():
    from avmoe_tpu_torch.config import tiny_avs_config
    from avmoe_tpu_torch.models.avs import AVSModel

    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="cuda"):
        AVSModel(tiny_avs_config())


def test_avs_chain_path_refuses_to_train(avs):
    from avmoe_tpu_torch import config as pc
    from avmoe_tpu_torch.models.avs import AVSModel
    from avmoe_tpu_torch.train.freeze import freeze

    pm = AVSModel(_cfg(pc), device="cpu", seed=0, block_chains=True)
    freeze(pm)
    with pytest.raises(NotImplementedError, match="eval only"):
        pm(*avs["ins"], train=True, generator=torch.Generator())


@pytest.mark.parametrize("K,rel_plain,want", [
    (1, 0.3, 4e-2), (2, 0.3, 4e-2),            # short chains keep K3_BF16_TOL
    (18, 3.05e-1, 1.2e-1),                     # the length bound is the tighter
    (18, 5e-2, 5e-2),                          # the Pallas rounding's is the tighter
    (18, 1e-2, 4e-2)])                         # never below K3_BF16_TOL
def test_chip_smoke_k3_bf16_budget_tightens_long_chains(K, rel_plain, want):
    import chip_smoke

    geom = types.SimpleNamespace(K=K)
    assert chip_smoke.k3_bf16_budget(geom, rel_plain) == pytest.approx(want, rel=1e-12)


def test_chip_smoke_holds_every_avs_chain_geometry():
    """chip_smoke holds K3 against its plain version at exactly the
    geometries and calls of AVS's chain path (at AVS's own frame counts)."""
    import chip_smoke
    from avmoe_tpu_torch.config import AVSConfig
    from avmoe_tpu_torch.models.avs import avs_kernel_launches
    from avmoe_tpu_torch.moe.injection import chain_calls

    cfg = AVSConfig()
    calls = chain_calls(cfg.swin, cfg.htsat, cfg.injection)
    shapes = dict(chip_smoke.avs_k3_shapes())
    assert set(shapes) == {c.geom for c in calls}
    assert sum(shapes.values()) == len(calls) == avs_kernel_launches(cfg, True)["K3"] == 30


@pytest.mark.parametrize("kernel", ["K1", "K2", "K1b", "K2b"])
@pytest.mark.parametrize("clips", [4, 1])
def test_chip_smoke_avs_kernel_shapes_sum_to_the_avs_plans(kernel, clips):
    """chip_smoke's per-shape plans at AVS's frames (5 a clip) add up to the
    launches of an AVS forward or MS3 step, and carry its row counts."""
    import chip_smoke
    from avmoe_tpu_torch.config import AVSConfig
    from avmoe_tpu_torch.models.avs import avs_kernel_launches
    from avmoe_tpu_torch.moe.injection import backward_launches

    cfg = AVSConfig()
    frames = clips * cfg.num_segments
    shapes = getattr(chip_smoke, f"{kernel.lower()}_shapes")(frames)
    plan = {**avs_kernel_launches(cfg, False),
            **backward_launches(cfg.swin, cfg.htsat, cfg.injection)}
    assert sum(s[-1] for s in shapes) == plan[kernel]
    if kernel.startswith("K2"):
        # stage 3 of Swin-V2-L: 6 x 6 tokens a frame
        assert (frames * 36, 1536) in {(R, C) for R, C, _, _ in shapes}
    else:
        # stage 0 of Swin-V2-L: 16 windows a frame
        assert frames * 16 in {s[0] for s in shapes}
