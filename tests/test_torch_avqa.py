"""The AVQA slice as a whole: the port's tiny AVQAFusionModel eval forward on
both paths vs the JAX package's AVQAFusionModel on the same seeded weights
and inputs (qa_logits, match_posi, match_nega, the gating probs), the
encoder's token outputs and the frozen negative pass against what the JAX
forward computed inside (captured intermediates of `forward_tokens` and
`swin.forward_features`), grounding and matching on JAX's own inputs, the
converter's round trip over the AVQA tree, the configs, the eval closure's
accuracy and the launch plan at AVQAConfig().

One JAX compile for the file (a module-scoped fixture); tolerance rtol
2e-3, atol 1e-4 (the JAX suite's activation tolerance).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from torch_port_harness import FWD_TOL, jax_variables, to_jax

from avmoe_tpu_torch.convert import export_jax_variables, load_jax_variables

torch.set_num_threads(2)

OUT_KEYS = ["qa_logits", "match_posi", "match_nega"]
GATING_KEYS = ["audio_p1", "audio_p2", "video_p1", "video_p2"]
CAPTURED = ("forward_tokens", "forward_features", "_ground", "_match")


def _inputs(cfg, clips: int, seed: int):
    rng = np.random.RandomState(seed)
    T, S = cfg.num_segments, cfg.swin.img_size
    return (rng.randn(clips, T, cfg.audio_len).astype(np.float32) * 0.1,
            rng.rand(clips, T, S, S, 3).astype(np.float32),
            rng.rand(clips, T, S, S, 3).astype(np.float32),
            rng.randint(0, cfg.qst_vocab, (clips, cfg.max_qst_len)).astype(np.int32))


@pytest.fixture(scope="module")
def avqa():
    from avmoe_tpu.config import tiny_avqa_config as jax_tiny
    from avmoe_tpu.models.avqa import AVQAFusionModel as JAVQA

    from avmoe_tpu_torch.config import tiny_avqa_config
    from avmoe_tpu_torch.models.avqa import AVQAFusionModel

    jcfg = jax_tiny()
    ins = _inputs(jcfg, 2, 0)
    jm = JAVQA(jcfg)
    variables = jax_variables(jm, *map(jnp.asarray, ins), seed=1)
    capture = lambda mdl, name: name in CAPTURED
    ref, inter = jax.jit(lambda v, *a: jm.apply(v, *a, capture_intermediates=capture,
                                                mutable=["intermediates"]))(
        to_jax(variables), *map(jnp.asarray, ins))
    inter = jax.tree_util.tree_map(np.asarray, inter["intermediates"])
    pm = AVQAFusionModel(tiny_avqa_config(), device="cpu", seed=None)
    load_jax_variables(pm, variables)
    tins = tuple(torch.from_numpy(a) for a in ins)
    return dict(variables=variables, ref=jax.tree_util.tree_map(np.asarray, ref), inter=inter,
                out=pm(*tins), model=pm, ins=tins)


@pytest.mark.parametrize("key", OUT_KEYS)
def test_tiny_avqa_forward_matches_jax(avqa, key):
    ours, ref = avqa["out"][key].numpy(), avqa["ref"][key]
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, **FWD_TOL)


def test_tiny_avqa_output_shapes_and_keys(avqa):
    out = avqa["out"]
    assert set(out) == set(avqa["ref"])
    assert out["qa_logits"].shape == (2, 8)                 # fc_class, not answer_vocab
    assert out["match_posi"].shape == out["match_nega"].shape == (4, 2)
    assert set(out["telemetry"]) == set(avqa["ref"]["telemetry"])


@pytest.mark.parametrize("key", GATING_KEYS)
def test_tiny_avqa_gating_probs_match_jax(avqa, key):
    ours, ref = avqa["out"]["telemetry"][key].numpy(), avqa["ref"]["telemetry"][key]
    # adapters in all four stages (12 sites), 3 experts (1 cross-modal, 2 unimodal)
    assert ours.shape == ref.shape == (12, 4, 3)
    np.testing.assert_allclose(ours, ref, **FWD_TOL)
    assert np.abs(ours - 1.0 / 3).max() > 1e-3


@pytest.mark.parametrize("which", ["f_v grid", "f_a tokens"])
def test_tiny_avqa_forward_tokens_match_jax(avqa, which):
    """The positive pass's token outputs: the normed visual grid (B', N_last,
    C_v) and the un-normed audio tokens (B', M_last, C_a)."""
    B, T = 2, 2
    wave, posi = avqa["ins"][0], avqa["ins"][1]
    with torch.no_grad():
        f_v, f_a, _ = avqa["model"].encoder.forward_tokens(
            wave.reshape(B * T, -1), posi.reshape((B * T,) + tuple(posi.shape[2:])))
    ref = avqa["inter"]["encoder"]["forward_tokens"][0]
    ours, want = (f_v, ref[0]) if which == "f_v grid" else (f_a, ref[1])
    assert ours.shape == want.shape == (B * T, 4, 128)
    np.testing.assert_allclose(ours.numpy(), want, **FWD_TOL)


@pytest.mark.parametrize("chains", [False, True], ids=["default path", "chain path"])
def test_negative_pass_matches_jax_forward_features(avqa, chains):
    """The frozen pass over the negative frames: embed, every block without
    adapters, the downsamples and the final norm (K3 chains a stage on the
    chain path, their plain version on the CPU)."""
    from avmoe_tpu_torch.kernels.block_chain import block_chain

    model, nega = avqa["model"], avqa["ins"][2]
    model.encoder.block_chains = chains
    before = block_chain.launches
    try:
        ours = model.negative_features(nega.reshape((4,) + tuple(nega.shape[2:])))
    finally:
        model.encoder.block_chains = False
    assert block_chain.launches == before        # CPU tensors take the plain version
    assert not ours.requires_grad
    ref = avqa["inter"]["encoder"]["swin"]["forward_features"][0]
    assert ours.shape == ref.shape == (4, 4, 128)
    np.testing.assert_allclose(ours.numpy(), ref, **FWD_TOL)


def test_ground_and_match_on_the_jax_inputs(avqa):
    """`ground` and `match` on the grids, grounded features and audio
    features of the JAX forward (the audio feature from JAX's f_a tokens
    through the port's fc_a1 / fc_a2), against JAX's _ground / _match."""
    model, inter = avqa["model"], avqa["inter"]
    f_a = torch.from_numpy(np.array(inter["encoder"]["forward_tokens"][0][1])).mean(dim=1)
    grids = (inter["encoder"]["forward_tokens"][0][0],
             inter["encoder"]["swin"]["forward_features"][0])
    with torch.no_grad():
        audio = model.fc_a2(torch.relu(model.fc_a1(f_a)))
        for grid, grd_ref, match_ref in zip(grids, inter["_ground"], inter["_match"]):
            grd = model.ground(audio, torch.from_numpy(np.array(grid)))
            np.testing.assert_allclose(grd.numpy(), grd_ref, **FWD_TOL)
            match = model.match(audio, torch.from_numpy(np.array(grd_ref)))
            np.testing.assert_allclose(match.numpy(), match_ref, **FWD_TOL)


@pytest.fixture(scope="module")
def chain_out(avqa):
    from avmoe_tpu_torch.config import tiny_avqa_config
    from avmoe_tpu_torch.kernels.block_chain import block_chain
    from avmoe_tpu_torch.models.avqa import AVQAFusionModel

    pm = AVQAFusionModel(tiny_avqa_config(), device="cpu", seed=None, block_chains=True)
    pm.load_state_dict(avqa["model"].state_dict())
    before = block_chain.launches
    out = pm(*avqa["ins"])
    assert block_chain.launches == before
    return out


@pytest.mark.parametrize("key", OUT_KEYS + GATING_KEYS)
def test_tiny_avqa_block_chains_match_jax_and_default_path(avqa, chain_out, key):
    tele = key in GATING_KEYS
    ours = (chain_out["telemetry"] if tele else chain_out)[key].numpy()
    ref = (avqa["ref"]["telemetry"] if tele else avqa["ref"])[key]
    default = (avqa["out"]["telemetry"] if tele else avqa["out"])[key].numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, **FWD_TOL)
    np.testing.assert_allclose(ours, default, rtol=1e-4, atol=1e-4)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_convert_round_trip_gives_back_the_jax_tree(avqa):
    """load_jax_variables then export_jax_variables: the same tree, leaf for
    leaf, bit for bit (the embedding, the LSTM's per-gate kernels under
    question_encoder/lstm, the MHA kernels, the visual gates the audio
    adapters lack)."""
    variables = avqa["variables"]
    back = export_jax_variables(avqa["model"])
    want, got = dict(_flat(variables["params"])), dict(_flat(back["params"]))
    assert set(got) == set(want)
    for path, v in want.items():
        assert got[path].shape == v.shape, path
        np.testing.assert_array_equal(got[path], v, err_msg="/".join(path))
    assert {p[-2] for p, _ in _flat(back["batch_stats"])} <= {"bn0"}
    for key in [("question_encoder", "word2vec", "embedding"),
                ("question_encoder", "lstm", "ii", "kernel"),
                ("question_encoder", "lstm", "ho", "bias"),
                ("attn_v", "attn", "query", "kernel"), ("fc4", "kernel"),
                ("encoder", "vis_moe_p1_0", "singlemodal_experts", "gate")]:
        assert key in got, key
    assert ("encoder", "audio_moe_p1_0", "singlemodal_experts", "gate") not in got
    assert got[("question_encoder", "word2vec", "embedding")].shape == (20, 16)


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

    same(pc.AVQAConfig(), jc.AVQAConfig())
    same(pc.tiny_avqa_config(), jc.tiny_avqa_config())
    same(pc.mini_avqa_config(), jc.mini_avqa_config())


def test_eval_fn_accuracy_matches_the_jax_metric(avqa):
    from avmoe_tpu.metrics.avqa import AVQAAccuracy as JAccuracy

    from avmoe_tpu_torch.metrics.avqa import AVQAAccuracy
    from avmoe_tpu_torch.models.avqa import make_avqa_eval_fn

    pred = np.argmax(avqa["ref"]["qa_logits"][:, :6], axis=-1)
    answer = np.array([pred[0], (pred[1] + 1) % 6])         # one right, one wrong
    qtypes = ["Audio_Counting", ""]
    acc = AVQAAccuracy()
    wave, posi, nega, q = avqa["ins"]
    res = make_avqa_eval_fn(avqa["model"])(
        dict(wave=wave, visual_posi=posi, visual_nega=nega, question=q,
             answer=torch.from_numpy(answer), qtype_str=qtypes), acc)
    assert set(res["telemetry"]) == set(avqa["ref"]["telemetry"])
    ref = JAccuracy()
    ref.update(pred, answer, qtypes)
    assert acc.summary() == ref.summary() == {"overall": 50.0, "Audio_Counting": 100.0}


# AVQAConfig(): adapters in every stage; the frozen negative pass adds the
# 24 Swin blocks (default path) or 6 chains (one per stage's same-(window,
# shift) run: 2 + 2 + 1 + 1) to the encoder's launches; the step's backward
# is the encoder's alone
AVQA_PLAN = {"sites": 12, "adapter calls": 48, "experts": 3, "K1": 60, "K2": 60, "K3": 0,
             "chain K1": 0, "chain K2": 12, "chain K3": 36, "K1b": 34, "K2b": 35}


@pytest.mark.parametrize("what", sorted(AVQA_PLAN))
def test_avqa_launch_plan(what):
    from avmoe_tpu_torch.config import AVQAConfig
    from avmoe_tpu_torch.models.avqa import avqa_kernel_launches
    from avmoe_tpu_torch.moe.injection import backward_launches, plan_injection

    cfg = AVQAConfig()
    sites = plan_injection(cfg.swin, cfg.htsat, cfg.injection)
    got = {"sites": len(sites), "adapter calls": 4 * len(sites),
           "experts": cfg.moe.num_experts, **avqa_kernel_launches(cfg, False),
           **{f"chain {k}": v for k, v in avqa_kernel_launches(cfg, True).items()},
           **backward_launches(cfg.swin, cfg.htsat, cfg.injection)}
    assert got[what] == AVQA_PLAN[what]


def test_negative_pass_chains_are_whole_stages():
    """The frozen pass's K3 calls at AVQAConfig(): stages 0 and 1 alternate
    shifts (one block a chain), stage 2's 18 blocks at the 12 x 12 grid are
    one unshifted chain, stage 3's two blocks at 6 x 6 another."""
    from avmoe_tpu_torch.config import AVQAConfig
    from avmoe_tpu_torch.moe.injection import swin_chain_calls

    calls = swin_chain_calls(AVQAConfig().swin)
    assert [(c.stage, c.geom.K, c.geom.N, c.geom.C) for c in calls] == [
        (0, 1, 144, 192), (0, 1, 144, 192), (1, 1, 144, 384), (1, 1, 144, 384),
        (2, 18, 144, 768), (3, 2, 36, 1536)]
    assert all(c.geom.part == "full" for c in calls)
    assert [c.blocks for c in calls][4] == tuple(range(4, 22))


def test_avqa_model_raises_when_cuda_is_asked_for_and_absent():
    from avmoe_tpu_torch.config import tiny_avqa_config
    from avmoe_tpu_torch.models.avqa import AVQAFusionModel

    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="cuda"):
        AVQAFusionModel(tiny_avqa_config())


def test_avqa_chain_path_refuses_to_train(avqa):
    from avmoe_tpu_torch.config import tiny_avqa_config
    from avmoe_tpu_torch.models.avqa import AVQAFusionModel

    pm = AVQAFusionModel(tiny_avqa_config(), device="cpu", seed=0, block_chains=True)
    with pytest.raises(NotImplementedError, match="eval only"):
        pm(*avqa["ins"], train=True, generator=torch.Generator())
