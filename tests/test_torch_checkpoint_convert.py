"""The port's reference-checkpoint converters (avmoe_tpu_torch/checkpoint/
convert.py) against the JAX package's, and the backbone graft.

Reference-layout state dicts are written from seeded flax-layout trees by
tests/torch_reference_layout.py (the converters' inverse). On them:

  * the port's converter equals the JAX one leaf for leaf (keys, dtypes,
    values) for every task variant and both backbones; the timm-layout Swin-V2
    comes from the independent tests/torch_swinv2.py;
  * the converted tree loads into the port's model (strictly) and gives back
    the tree it was written from;
  * the tiny AVE eval forward from one reference dict, through the port
    (convert, load, forward on the CPU) and through JAX (convert_mmil_net,
    apply), agrees at FWD_TOL (one JAX compile for the file);
  * `graft_backbones` on each task model (and AVQA's grounding model) gives
    the state a load of JAX's converted backbone subtrees gives, and a model
    that ran a bf16 forward before the graft computes what a fresh one does;
  * JAX's own `graft_backbones` raises on the AVE tree given an HTS-AT dict
    (the tree has no encoder/htsat/norm), where the port's graft skips it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

import torch_reference_layout as ref
from torch_port_harness import port_variables, to_jax

from avmoe_tpu.checkpoint import convert as jcv
from avmoe_tpu_torch import config as C
from avmoe_tpu_torch.checkpoint import convert as pcv
from avmoe_tpu_torch.convert import export_jax_variables, load_jax_variables

torch.set_num_threads(2)

# Measured on the CPU with these seeds: max |port - JAX| over the three
# outputs 1.7e-6 (logits up to 2.0 in size); FWD_TOL is the bound checked.
FWD_TOL = dict(rtol=2e-3, atol=1e-4)


def _models():
    from avmoe_tpu_torch.models.ave import AVEModel
    from avmoe_tpu_torch.models.avqa import AVQAFusionModel
    from avmoe_tpu_torch.models.avqa_grounding import AVQAGroundingModel
    from avmoe_tpu_torch.models.avs import AVSModel
    from avmoe_tpu_torch.models.avvp import MGNModel

    ave_inter = dataclasses.replace(C.tiny_ave_config(), is_inter_in_cmbs=True)
    return {
        "ave": lambda **kw: AVEModel(C.tiny_ave_config(), **kw),
        "ave_inter": lambda **kw: AVEModel(ave_inter, **kw),
        "avvp": lambda **kw: MGNModel(C.tiny_avvp_config(), **kw),
        "avqa": lambda **kw: AVQAFusionModel(C.tiny_avqa_config(), **kw),
        "avqa_grounding": lambda **kw: AVQAGroundingModel(C.tiny_avqa_config(), **kw),
        "avs_s4": lambda **kw: AVSModel(C.tiny_avs_config(), **kw),
        "avs_ms3": lambda **kw: AVSModel(C.ms3_config(C.tiny_avs_config()), **kw),
    }


def _build(name: str, **kw):
    return _models()[name](device="cpu", seed=None, **kw)


def _backbones(model):
    host = getattr(model, "encoder", model)
    return host.swin, host.htsat


def _depths(model):
    swin, htsat = _backbones(model)
    return dict(swin_depths=swin.cfg.depths, htsat_depths=htsat.cfg.depths)


def _variables(out):
    """A converter's result as {"params", "batch_stats"}."""
    if isinstance(out, tuple):
        return {"params": out[0], "batch_stats": out[1]}
    return {"params": out, "batch_stats": {}}


def _task(name: str, model, tree):
    """(reference state dict, converter call taking a convert module)."""
    d = _depths(model)
    enc = tree["params"].get("encoder")
    sites = ref.n_sites(enc) if enc else 0
    if name.startswith("ave"):
        return (ref.mmil_net_state_dict(tree, dropped=True),
                lambda cv, sd: cv.convert_mmil_net(sd, n_sites=sites, inter=name == "ave_inter",
                                                   **d))
    if name == "avvp":
        c = model.cfg
        return (ref.mgn_net_state_dict(tree, dropped=True),
                lambda cv, sd: cv.convert_mgn_net(
                    sd, n_sites=sites, grouping_depths=(c.depth_aud, c.depth_vis, c.depth_av),
                    moe_kwargs={"num_conv_group": c.moe.adapter.num_conv_group}, **d))
    if name == "avqa":
        return (ref.avqa_fusion_net_state_dict(tree, dropped=True),
                lambda cv, sd: cv.convert_avqa_fusion_net(
                    sd, n_sites=sites,
                    moe_kwargs={"num_conv_group": model.cfg.moe.adapter.num_conv_group}, **d))
    if name == "avqa_grounding":
        return (ref.grounding_net_state_dict(tree, dropped=True),
                lambda cv, sd: cv.convert_grounding_net(sd, **d))
    kw = {"self_attention": "token"} if name == "avs_ms3" else {}
    return (ref.pred_endecoder_state_dict(tree, dropped=True),
            lambda cv, sd: cv.convert_pred_endecoder(sd, n_sites=sites, moe_kwargs=kw, **d))


TASKS = list(_models())


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _assert_same_tree(ours, theirs):
    a, b = _flat(ours), _flat(theirs)
    assert sorted(a) == sorted(b)
    for k in a:
        assert isinstance(a[k], np.ndarray), k
        assert a[k].dtype == np.asarray(b[k]).dtype, k
        assert np.array_equal(a[k], np.asarray(b[k])), k


@pytest.fixture(scope="module")
def tasks():
    """name -> (model, seeded source tree, reference state dict, converter)."""
    out = {}
    for i, name in enumerate(TASKS):
        model = _build(name)
        tree = port_variables(model, seed=10 + i)
        sd, conv = _task(name, model, tree)
        out[name] = (model, tree, sd, conv)
    return out


@pytest.mark.parametrize("name", TASKS)
def test_task_converter_equals_jax(tasks, name):
    _, _, sd, conv = tasks[name]
    ours, theirs = _variables(conv(pcv, sd)), _variables(conv(jcv, sd))
    for col in ("params", "batch_stats"):
        _assert_same_tree(ours[col], theirs[col])


def _off_paths(model):
    """The subtrees the port's modules list in their flax_off_path."""
    return {(tuple(n.split(".")) if n else ()) + (sub,)
            for n, m in model.named_modules() for sub in getattr(m, "flax_off_path", ())}


@pytest.mark.parametrize("name", TASKS)
def test_converted_tree_loads_and_round_trips(tasks, name):
    """Every converted leaf the source tree lacks lies on an off path
    (HTS-AT's tagging tail; AVS's coarsest FPN level's res1)."""
    model, tree, sd, conv = tasks[name]
    got = _variables(conv(pcv, sd))
    load_jax_variables(model, got)                      # strict: raises on a gap
    back = export_jax_variables(model)
    off = _off_paths(model)
    for col in ("params", "batch_stats"):
        src, conv_flat = _flat(tree.get(col, {})), _flat(got[col])
        extra = set(conv_flat) - set(src)
        assert all(any(k[:len(o)] == o for o in off) for k in extra), extra
        for k, v in _flat(back[col]).items():
            assert np.array_equal(v, src[k]), k


@pytest.mark.parametrize("name", ["ave", "avvp", "avqa", "avs_s4"])
def test_keylog_reads_every_key_but_the_dropped_modules(tasks, name):
    _, _, sd, conv = tasks[name]
    log = pcv.KeyLog(sd)
    ours = _variables(conv(pcv, log))
    _assert_same_tree(ours["params"], _variables(conv(pcv, sd))["params"])
    dropped = ("swin.head.", ".relative_position_index", "spectrogram_extractor.",
               "logmel_extractor.", "_decoder.decoder.layers.0.self_attn.")
    unread = log.unread()
    assert unread and all(any(d in k for d in dropped) for k in unread), unread[:5]
    assert len(log.read) + len(unread) == len(sd)


def test_htsat_alone_equals_jax_and_loads():
    model = _build("ave")
    htsat = model.encoder.htsat
    tree = port_variables(htsat, seed=3)
    sd = ref.htsat_state_dict(tree["params"], tree["batch_stats"], dropped=True)
    ours = pcv.convert_htsat(sd, htsat.cfg.depths)
    theirs = jcv.convert_htsat(sd, htsat.cfg.depths)
    for a, b in zip(ours, theirs):
        _assert_same_tree(a, b)
    assert {"norm", "tscam_conv", "head"} <= set(ours[0])
    load_jax_variables(htsat, _variables(ours))          # the tail is off the path


def test_swinv2_timm_state_dict_equals_jax_and_loads():
    """A timm-layout module's own state_dict (tests/torch_swinv2.py, with its
    non-persistent buffers left out as timm's are)."""
    from torch_swinv2 import SwinTransformerV2

    from avmoe_tpu_torch.backbones.swin_v2 import SwinV2Encoder

    cfg = C.tiny_swin()
    torch.manual_seed(0)
    timm = SwinTransformerV2(img_size=cfg.img_size, patch_size=cfg.patch_size,
                             embed_dim=cfg.embed_dim, depths=cfg.depths,
                             num_heads=cfg.num_heads, window_size=cfg.window_size)
    sd = pcv.torch_state_dict_to_numpy(timm.state_dict())
    ours, theirs = pcv.convert_swinv2_timm(sd, cfg.depths), jcv.convert_swinv2_timm(sd, cfg.depths)
    _assert_same_tree(ours, theirs)
    enc = SwinV2Encoder(cfg)
    load_jax_variables(enc, {"params": ours})
    x = torch.rand(2, cfg.img_size, cfg.img_size, 3)
    with torch.no_grad():
        got = enc.forward_features(enc.embed(x))
        want = timm.forward_features(x.permute(0, 3, 1, 2))
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def test_torch_state_dict_to_numpy_copies():
    lin = torch.nn.Linear(3, 2)
    sd = pcv.torch_state_dict_to_numpy(lin.state_dict())
    with torch.no_grad():
        lin.weight.add_(1.0)
    assert not np.array_equal(sd["weight"], lin.weight.detach().numpy())


def test_seeded_variables_shapes_dtypes_and_seed():
    shapes = export_jax_variables(_build("avs_s4"))
    a, b = ref.seeded_variables(shapes, 4), ref.seeded_variables(shapes, 4)
    fa, fs = _flat(a), _flat({k: v for k, v in shapes.items() if v})
    assert sorted(fa) == sorted(fs)
    assert all(fa[k].dtype == np.float32 and fa[k].shape == fs[k].shape for k in fa)
    assert all(np.array_equal(fa[k], v) for k, v in _flat(b).items())
    assert not np.array_equal(fa[k := next(iter(fa))], _flat(ref.seeded_variables(shapes, 5))[k])
    gates = [v for k, v in fa.items() if k[-1] in ("gate", "gate_av")]
    assert gates and all((np.abs(g) > 0).all() for g in gates)
    bn0 = [v for k, v in fa.items() if k[0] == "batch_stats" and "bn0" in k and k[-1] == "var"]
    assert bn0 and all((v > 0).all() for v in bn0)


def test_strip_prefix_and_derived_dicts_record_into_one_log():
    sd = {"sed_model.a.weight": np.ones(2), "sed_model.b": np.zeros(1), "c": np.ones(1)}
    log = pcv.KeyLog(sd)
    stripped = pcv.strip_prefix(log, "sed_model.")
    assert sorted(stripped) == ["a.weight", "b", "c"] and not log.read
    stripped["a.weight"]
    assert log.read == {"sed_model.a.weight"}
    assert log.unread() == ["c", "sed_model.b"]


# ------------------------------------------------------------------ graft


def _backbone_dicts(model, seed: int):
    """Seeded timm- and HTS-AT-layout dicts for the model's backbones, the
    HTS-AT one with its checkpoints' 'sed_model.' prefix."""
    swin, htsat = _backbones(model)
    s = ref.seeded_variables(export_jax_variables(swin), seed)
    h = ref.seeded_variables(export_jax_variables(htsat), seed + 1)
    swin_sd = ref.swinv2_timm_state_dict(s["params"], dropped=True)
    htsat_sd = {"sed_model." + k: v for k, v in ref.htsat_state_dict(
        h["params"], h["batch_stats"], dropped=True).items()}
    return swin_sd, htsat_sd


def _backbone_pass(model, seed: int):
    """Both backbones' plain forward (no adapters), as the grounding stage
    runs them: every Swin block's K2 reads its cached compute-dtype MLP
    weights."""
    swin, htsat = _backbones(model)
    rng = np.random.RandomState(seed)
    wave = torch.from_numpy(rng.randn(2, htsat.cfg.frontend.sample_rate).astype(np.float32) * 0.1)
    imgs = torch.from_numpy(rng.rand(2, swin.cfg.img_size, swin.cfg.img_size, 3)
                            .astype(np.float32))
    with torch.no_grad():
        return (swin.forward_features(swin.embed(imgs)).float(),
                htsat.forward_features(htsat.embed(wave)).float())


@pytest.mark.parametrize("name", ["ave", "avvp", "avqa", "avqa_grounding", "avs_s4"])
def test_graft_backbones_equals_loading_jax_subtrees(name):
    model = _build(name, dtype=torch.bfloat16)
    base = port_variables(model, seed=1)
    load_jax_variables(model, base)
    before = _backbone_pass(model, 0)                 # fills the bf16 weight caches
    start = {k: v.clone() for k, v in model.state_dict().items()}
    swin_sd, htsat_sd = _backbone_dicts(model, 20)
    assert pcv.graft_backbones(model, swin_sd=swin_sd,
                               htsat_sd=pcv.strip_prefix(htsat_sd, "sed_model.")) is model

    fresh = _build(name, dtype=torch.bfloat16)
    load_jax_variables(fresh, base)
    swin, htsat = _backbones(fresh)
    load_jax_variables(swin, {"params": jcv.convert_swinv2_timm(swin_sd, swin.cfg.depths)})
    hp, hbs = jcv.convert_htsat(jcv.strip_prefix(htsat_sd, "sed_model."), htsat.cfg.depths)
    load_jax_variables(htsat, {"params": hp, "batch_stats": hbs})

    got, want = model.state_dict(), fresh.state_dict()
    assert sorted(got) == sorted(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    moved = [k for k in got if ".swin." in f".{k}" or ".htsat." in f".{k}"]
    assert moved and all(not torch.equal(got[k], start[k]) for k in moved)
    # the adapters and heads keep their weights
    assert all(torch.equal(got[k], start[k]) for k in got if k not in moved)

    after, ref_out = _backbone_pass(model, 0), _backbone_pass(fresh, 0)
    for a, b, c in zip(after, ref_out, before):
        assert torch.equal(a, b)
        assert not torch.equal(a, c)


def test_graft_backbones_keeps_the_mlp_weight_cache_current():
    model = _build("ave", dtype=torch.bfloat16)
    load_jax_variables(model, port_variables(model, seed=1))
    _backbone_pass(model, 0)
    swin_sd, htsat_sd = _backbone_dicts(model, 30)
    pcv.graft_backbones(model, swin_sd=swin_sd, htsat_sd=pcv.strip_prefix(htsat_sd, "sed_model."))
    for blk in model.encoder.swin.blocks + model.encoder.htsat.blocks:
        w1, w2, _, _ = blk._mlp_weights(torch.bfloat16, False)
        assert torch.equal(w1, blk.mlp.fc1.weight.to(torch.bfloat16))
        assert torch.equal(w2, blk.mlp.fc2.weight.to(torch.bfloat16))


def test_graft_backbones_raises_on_a_stray_or_missing_leaf():
    model = _build("ave")
    swin_sd, htsat_sd = _backbone_dicts(model, 40)
    with pytest.raises(KeyError):
        pcv.graft_backbones(model, swin_sd={k: v for k, v in swin_sd.items()
                                            if k != "norm.weight"})
    bad = dict(pcv.strip_prefix(htsat_sd, "sed_model."))
    bad["layers.0.blocks.0.attn.qkv.weight"] = bad["layers.0.blocks.0.attn.qkv.weight"][:, :-1]
    with pytest.raises(ValueError):
        pcv.graft_backbones(model, htsat_sd=bad)


# ------------------------------------------- the whole AVE forward, and JAX


# both backbones cut to depths 2-2-2-2 for the forward: the converters map
# blocks one by one whatever the depth, and the JAX trace of the tiny
# model's 36 blocks cost most of this file's time
CUT = (2, 2, 2, 2)


def _cut(cfg):
    return dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin, depths=CUT),
                               htsat=dataclasses.replace(cfg.htsat, depths=CUT))


@pytest.fixture(scope="module")
def ave_forward():
    from avmoe_tpu.config import tiny_ave_config as jax_tiny
    from avmoe_tpu.models.ave import AVEModel as JAVE

    from avmoe_tpu_torch.models.ave import AVEModel

    model = AVEModel(_cut(C.tiny_ave_config()), device="cpu", seed=None)
    tree = port_variables(model, seed=5)
    sd = ref.mmil_net_state_dict(tree, dropped=True)
    kw = dict(n_sites=ref.n_sites(tree["params"]["encoder"]), **_depths(model))

    jcfg = _cut(jax_tiny())
    rng = np.random.RandomState(6)
    wave = rng.randn(2, jcfg.num_segments, jcfg.audio_len).astype(np.float32) * 0.1
    imgs = rng.rand(2, jcfg.num_segments, jcfg.swin.img_size, jcfg.swin.img_size,
                    3).astype(np.float32)
    jm = JAVE(jcfg)
    jp, jbs = jcv.convert_mmil_net(sd, **kw)
    out = jax.jit(lambda v, w, i: jm.apply(v, w, i))(
        to_jax({"params": jp, "batch_stats": jbs}), jnp.asarray(wave), jnp.asarray(imgs))
    jax_tree = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(wave),
                                              jnp.asarray(imgs)))

    pp, pbs = pcv.convert_mmil_net(sd, **kw)
    load_jax_variables(model, {"params": pp, "batch_stats": pbs})
    ours = model(torch.from_numpy(wave), torch.from_numpy(imgs))
    return dict(ours=ours, ref=jax.tree_util.tree_map(np.asarray, out), jax_tree=jax_tree,
                sd=sd, model=model)


@pytest.mark.parametrize("key", ["is_event_logits", "event_logits", "av_score"])
def test_reference_dict_ave_forward_matches_jax(ave_forward, key):
    ours, want = ave_forward["ours"][key].numpy(), ave_forward["ref"][key]
    assert ours.shape == want.shape
    np.testing.assert_allclose(ours, want, **FWD_TOL)


def test_jax_graft_backbones_raises_on_the_ave_tree(ave_forward):
    """The JAX AVE tree has no encoder/htsat/norm, and JAX's graft asserts
    that every converted leaf exists; the port's graft skips HTS-AT's tail."""
    shapes = ave_forward["jax_tree"]
    variables = {col: jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                             dict(shapes[col])) for col in shapes}
    assert "norm" not in variables["params"]["encoder"]["htsat"]
    model = ave_forward["model"]
    swin_sd, htsat_sd = _backbone_dicts(model, 50)
    htsat_sd = jcv.strip_prefix(htsat_sd, "sed_model.")
    depths = _depths(model)
    with pytest.raises(AssertionError, match="missing.*'htsat', 'norm'"):
        jcv.graft_backbones(variables, htsat_sd=htsat_sd, **depths)
    grafted = jcv.graft_backbones(variables, swin_sd=swin_sd, **depths)   # the Swin half works
    pcv.graft_backbones(model, swin_sd=swin_sd, htsat_sd=htsat_sd)
    theirs = _flat(grafted["params"]["encoder"]["swin"])
    ours = _flat(export_jax_variables(model)["params"]["encoder"]["swin"])
    assert sorted(ours) == sorted(theirs)
    assert all(np.array_equal(ours[k], theirs[k]) for k in ours)
