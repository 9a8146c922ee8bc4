"""The port's converters of the legacy AVE models (avmoe_tpu_torch/checkpoint/
convert.py: convert_dgsct_adapter, convert_lavish_adapter, convert_mmil_v1,
convert_mmil_v2) against the JAX package's, and the graft into both models.

Reference-layout state dicts are written from seeded flax-layout trees by
tests/torch_reference_layout.py (`dgsct_adapter_state_dict`,
`lavish_adapter_state_dict`, `mmil_v1_state_dict`, `mmil_v2_state_dict`,
the converters' inverse), with the keys of the reference modules no
converter reads (the DG-SCT adapters' gate_tk, MMIL_Net v1's
adapter_token_downsampler, the backbones' and heads' dropped modules). On
them:

  * the port's converter equals the JAX one leaf for leaf (keys, dtypes,
    values), and `KeyLog` shows every key read but the dropped ones;
  * the converted tree loads into the port's model (strictly) and gives
    back the tree it was written from;
  * one tiny V1 and one tiny V2 eval forward from the same dict through both
    packages agree at FWD_TOL (Swin-V2 at depths 1-1-3-1, HTS-AT 1-1-1-1);
  * `graft_backbones` grafts V1's two backbones and V2's one Swin-V2 as a
    load of JAX's converted subtrees does, and refuses an HTS-AT dict for
    V2, which has no HTS-AT.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

import torch_reference_layout as ref
from torch_port_harness import FWD_TOL, port_variables, to_jax

from avmoe_tpu.checkpoint import convert as jcv
from avmoe_tpu_torch import config as C
from avmoe_tpu_torch.checkpoint import convert as pcv
from avmoe_tpu_torch.convert import export_jax_variables, load_jax_variables

torch.set_num_threads(2)

DEPTHS = dict(swin=(1, 1, 3, 1), htsat=(1, 1, 1, 1))
DROPPED = ("swin.head.", ".relative_position_index", "spectrogram_extractor.",
           "logmel_extractor.", "_decoder.decoder.layers.0.self_attn.",
           "adapter_token_downsampler.", ".gate_tk")


def _cfg(cut: bool = False):
    cfg = C.replace(C.tiny_ave_config(), d_model=32)
    if not cut:
        return cfg
    return dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin, depths=DEPTHS["swin"]),
                               htsat=dataclasses.replace(cfg.htsat, depths=DEPTHS["htsat"]))


def _model(name: str, cut: bool = False, **kw):
    from avmoe_tpu_torch.models.ave_legacy import MMILNetV1, MMILNetV2

    return (MMILNetV1 if name == "v1" else MMILNetV2)(_cfg(cut), device="cpu", seed=None, **kw)


def _convert(cv, name: str, model, sd):
    if name == "v1":
        return cv.convert_mmil_v1(sd, n_sites=len(model.encoder.sites),
                                  swin_depths=model.cfg.swin.depths,
                                  htsat_depths=model.cfg.htsat.depths,
                                  adapter_kwargs={"num_conv_group": 2})
    return cv.convert_mmil_v2(sd, swin_depths=model.cfg.swin.depths,
                              adapter_kwargs={"num_conv_group": 2})


def _state_dict(name: str, tree):
    return (ref.mmil_v1_state_dict if name == "v1" else ref.mmil_v2_state_dict)(
        tree, dropped=True)


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
    assert sorted(a) == sorted(b) and a
    for k in a:
        assert isinstance(a[k], np.ndarray), k
        assert a[k].dtype == np.asarray(b[k]).dtype, k
        assert np.array_equal(a[k], np.asarray(b[k])), k


@pytest.fixture(scope="module")
def tasks():
    """name -> (model, seeded source tree, reference state dict)."""
    out = {}
    for i, name in enumerate(("v1", "v2")):
        model = _model(name)
        tree = port_variables(model, seed=20 + i)
        out[name] = (model, tree, _state_dict(name, tree))
    return out


@pytest.mark.parametrize("kind", ["dgsct", "lavish"])
def test_adapter_converter_equals_jax(tasks, kind):
    """One adapter of each model: its reference dict through both packages'
    converters; the DG-SCT adapter's gate_tk is the one key left unread."""
    model, tree, _ = tasks["v1" if kind == "dgsct" else "v2"]
    params = tree["params"]["encoder"] if kind == "dgsct" else tree["params"]
    stats = tree["batch_stats"]["encoder"] if kind == "dgsct" else tree["batch_stats"]
    write = getattr(ref, f"{kind}_adapter_state_dict")
    sd = write(params["audio_adapter_p1_0"], stats["audio_adapter_p1_0"], dropped=True)
    log = pcv.KeyLog(sd)
    convert = f"convert_{kind}_adapter"
    ours = getattr(pcv, convert)(log)
    theirs = getattr(jcv, convert)(sd)
    for a, b in zip(ours, theirs):
        _assert_same_tree(a, b)
    assert log.unread() == (["gate_tk"] if kind == "dgsct" else [])
    _assert_same_tree(ours[0], params["audio_adapter_p1_0"])


@pytest.mark.parametrize("name", ["v1", "v2"])
def test_model_converter_equals_jax(tasks, name):
    model, _, sd = tasks[name]
    log = pcv.KeyLog(sd)
    ours, theirs = _convert(pcv, name, model, log), _convert(jcv, name, model, sd)
    for a, b in zip(ours, theirs):
        _assert_same_tree(a, b)
    unread = log.unread()
    assert unread and all(any(d in k for d in DROPPED) for k in unread), unread[:5]
    assert any("adapter_token_downsampler." in k for k in unread) == (name == "v1")
    assert any(k.endswith(".gate_tk") for k in unread) == (name == "v1")


def _off_paths(model):
    return {(tuple(n.split(".")) if n else ()) + (sub,)
            for n, m in model.named_modules() for sub in getattr(m, "flax_off_path", ())}


@pytest.mark.parametrize("name", ["v1", "v2"])
def test_converted_tree_loads_and_round_trips(tasks, name):
    model, tree, sd = tasks[name]
    params, stats = _convert(pcv, name, model, sd)
    load_jax_variables(model, {"params": params, "batch_stats": stats})
    back = export_jax_variables(model)
    off = _off_paths(model)
    got = {"params": params, "batch_stats": stats}
    for col in ("params", "batch_stats"):
        src, conv = _flat(tree.get(col, {})), _flat(got[col])
        extra = set(conv) - set(src)
        assert all(any(k[:len(o)] == o for o in off) for k in extra), extra
        for k, v in _flat(back[col]).items():
            assert np.array_equal(v, src[k]), k


@pytest.fixture(scope="module")
def forwards():
    """The tiny V1 and V2 eval forwards from one reference dict each, through
    the port (convert, load, forward) and through JAX (convert, apply)."""
    from avmoe_tpu.config import replace as jreplace, tiny_ave_config as jtiny
    from avmoe_tpu.models.ave_legacy import MMILNetV1 as JV1, MMILNetV2 as JV2

    jcfg = jreplace(jtiny(), d_model=32)
    jcfg = dataclasses.replace(
        jcfg, swin=dataclasses.replace(jcfg.swin, depths=DEPTHS["swin"]),
        htsat=dataclasses.replace(jcfg.htsat, depths=DEPTHS["htsat"]))
    rng = np.random.RandomState(8)
    B, T, S = 2, jcfg.num_segments, jcfg.swin.img_size
    x = dict(wave=rng.randn(B, T, jcfg.audio_len).astype(np.float32) * 0.1,
             audio_spec=rng.randn(B, T, S, S).astype(np.float32) * 0.5,
             images=rng.rand(B, T, S, S, 3).astype(np.float32))
    out = {}
    for i, (name, J, a) in enumerate((("v1", JV1, "wave"), ("v2", JV2, "audio_spec"))):
        model = _model(name, cut=True)
        sd = _state_dict(name, port_variables(model, seed=30 + i))
        jp, jbs = _convert(jcv, name, model, sd)
        jm = J(jcfg)
        want = jax.jit(lambda v, s, im: jm.apply(v, s, im))(
            to_jax({"params": jp, "batch_stats": jbs}), jnp.asarray(x[a]),
            jnp.asarray(x["images"]))
        pp, pbs = _convert(pcv, name, model, sd)
        load_jax_variables(model, {"params": pp, "batch_stats": pbs})
        got = model(torch.from_numpy(x[a]), torch.from_numpy(x["images"]))
        out[name] = (got, jax.tree_util.tree_map(np.asarray, want))
    return out


@pytest.mark.parametrize("name, key", [
    ("v1", "is_event_logits"), ("v1", "event_logits"), ("v1", "av_score"), ("v1", "av_gate"),
    ("v2", "event_probs"), ("v2", "event_logits")])
def test_reference_dict_forward_matches_jax(forwards, name, key):
    ours, want = forwards[name][0][key].numpy(), forwards[name][1][key]
    assert ours.shape == want.shape
    np.testing.assert_allclose(ours, want, **FWD_TOL)


@pytest.mark.parametrize("name", ["v1", "v2"])
def test_graft_backbones_into_the_legacy_models(name):
    """The graft lands where each model keeps its backbones (V1's
    encoder.swin / encoder.htsat, V2's swin) and changes nothing else."""
    model = _model(name, cut=True)
    load_jax_variables(model, port_variables(model, seed=1))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    host = getattr(model, "encoder", model)
    s = ref.seeded_variables(export_jax_variables(host.swin), 40)
    swin_sd = ref.swinv2_timm_state_dict(s["params"], dropped=True)
    kw = {"swin_sd": swin_sd}
    if name == "v1":
        h = ref.seeded_variables(export_jax_variables(host.htsat), 41)
        kw["htsat_sd"] = ref.htsat_state_dict(h["params"], h["batch_stats"], dropped=True)
    assert pcv.graft_backbones(model, **kw) is model
    want = {"swin": {"params": jcv.convert_swinv2_timm(swin_sd, host.swin.cfg.depths)}}
    if name == "v1":
        hp, hbs = jcv.convert_htsat(kw["htsat_sd"], host.htsat.cfg.depths)
        want["htsat"] = {"params": hp, "batch_stats": hbs}
    for bb, variables in want.items():
        got = export_jax_variables(getattr(host, bb))
        for col in ("params", "batch_stats"):
            theirs = _flat(variables.get(col, {}))
            for k, v in _flat(got[col]).items():
                assert np.array_equal(v, theirs[k]), (bb, k)
    prefix = "encoder." if name == "v1" else ""
    moved = [k for k in start if k.startswith((prefix + "swin.", prefix + "htsat."))]
    now = model.state_dict()
    assert moved and all(not torch.equal(now[k], start[k]) for k in moved)
    assert all(torch.equal(now[k], start[k]) for k in start if k not in moved)
    if name == "v2":
        with pytest.raises(ValueError, match="HTS-AT"):
            pcv.graft_backbones(model, htsat_sd=swin_sd)
