"""The port's legacy AVE models (avmoe_tpu_torch/models/ave_legacy.py,
moe/dgsct_adapter.py) against the JAX package's, on the CPU.

At `replace(tiny_ave_config(), d_model=32)` with Swin cut to depths 1-1-3-1
and HTS-AT to 1-1-1-1 (`_cfgs`), in float32, with the same seeded numpy
inputs and the JAX tree (seeded noise: non-zero gates, gate_av and
latent tokens) loaded into the port with `load_jax_variables`:

  * DGSCTAdapter (output and s_maps) and LAVisHAdapter, eval and train
    (batch statistics, the running stats' update), at rtol 2e-3 / atol 1e-4;
  * the MMILNetV1 and MMILNetV2 eval forwards, every output, the same way;
  * the trainable set against JAX's `partition_params`;
  * in bfloat16: the dtype of both streams at every adapter site and block
    boundary against a `jax.eval_shape` trace of the JAX models, and the
    two adapters' bf16 outputs within max |d| <= 2e-2 (1 + max |ref|);
  * the kernels' wrappers called as often as the models' launch plans say,
    forward and train step (on the CPU the wrappers take their plain
    versions, so the calls are counted).

One jitted JAX forward a model; the train steps are in
tests/test_torch_ave_legacy_train.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from torch_port_harness import FWD_TOL, jax_variables, to_jax

from avmoe_tpu_torch.convert import load_jax_variables

torch.set_num_threads(2)

# bf16 against bf16: max |d| <= BF16_TOL (1 + max |ref|), a bound on the
# largest difference against the output's scale. Elementwise the two
# packages' bf16 adapters can differ by more than BF16_TOL (|ref| + 1): they
# round at different places, each about as far from its own float32 output.
BF16_TOL = 2e-2
V1_OUT = ("is_event_logits", "event_logits", "av_score", "av_gate")
V2_OUT = ("event_probs", "event_logits")


def _cfgs():
    """The JAX and port configs, Swin at depths 1-1-3-1 and HTS-AT at
    1-1-1-1: V1 keeps an adapter site in every stage (4 of the tiny
    depths' 12) and each stage its dtype pattern, and the JAX package's
    trace and compile of the tiny depths (Swin 2-2-18-2) took ~20 s a model
    for each."""
    from avmoe_tpu.config import replace as jreplace, tiny_ave_config as jtiny

    from avmoe_tpu_torch.config import replace, tiny_ave_config

    cfgs = jreplace(jtiny(), d_model=32), replace(tiny_ave_config(), d_model=32)
    return tuple(dataclasses.replace(
        c, swin=dataclasses.replace(c.swin, depths=(1, 1, 3, 1)),
        htsat=dataclasses.replace(c.htsat, depths=(1, 1, 1, 1))) for c in cfgs)


def _inputs(cfg, seed: int = 0):
    rng = np.random.RandomState(seed)
    B, T, S = 2, cfg.num_segments, cfg.swin.img_size
    return dict(wave=rng.randn(B, T, cfg.audio_len).astype(np.float32) * 0.1,
                images=rng.rand(B, T, S, S, 3).astype(np.float32),
                audio_spec=rng.randn(B, T, S, S).astype(np.float32) * 0.5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    """The two models in both packages, the same variables, the JAX outputs."""
    from avmoe_tpu.models.ave_legacy import MMILNetV1 as JV1, MMILNetV2 as JV2

    from avmoe_tpu_torch.models.ave_legacy import MMILNetV1, MMILNetV2

    jcfg, pcfg = _cfgs()
    x = _inputs(jcfg)
    out = {}
    for name, J, P, a in (("v1", JV1, MMILNetV1, "wave"), ("v2", JV2, MMILNetV2, "audio_spec")):
        jm = J(jcfg)
        variables = jax_variables(jm, jnp.asarray(x[a]), jnp.asarray(x["images"]),
                                  seed=3 if name == "v1" else 4)
        ref = jax.jit(lambda v, s, i: jm.apply(v, s, i))(
            to_jax(variables), jnp.asarray(x[a]), jnp.asarray(x["images"]))
        pm = P(pcfg, device="cpu", seed=None)
        load_jax_variables(pm, variables)
        ours = pm(torch.from_numpy(x[a]), torch.from_numpy(x["images"]))
        out[name] = dict(jax=jm, variables=variables, ref=_np(ref), ours=ours, port=pm, arg=a)
    out["inputs"] = x
    out["cfgs"] = (jcfg, pcfg)
    return out


@pytest.mark.parametrize("key", V1_OUT)
def test_mmil_v1_forward_matches_jax(models, key):
    ours, ref = models["v1"]["ours"][key].numpy(), models["v1"]["ref"][key]
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, **FWD_TOL)


@pytest.mark.parametrize("key", V2_OUT)
def test_mmil_v2_forward_matches_jax(models, key):
    ours, ref = models["v2"]["ours"][key].numpy(), models["v2"]["ref"][key]
    B, T = 2, models["cfgs"][1].num_segments
    assert ours.shape == ref.shape == (B * T, models["cfgs"][1].num_classes + 1)
    np.testing.assert_allclose(ours, ref, **FWD_TOL)


@pytest.mark.parametrize("name", ["v1", "v2"])
def test_trainable_set_matches_jax_partition(models, name):
    """The port trains exactly the leaves JAX's partition_params trains (the
    adapters, anything under an adapter scope, and the heads), counted in
    the flax layout (`export_jax_variables(..., trainable_only=True)`)."""
    from flax import traverse_util

    from avmoe_tpu.train.freeze import partition_params

    from avmoe_tpu_torch.convert import export_jax_variables
    from avmoe_tpu_torch.train.freeze import partition

    trainable, frozen = partition_params(models[name]["variables"]["params"])
    ours = export_jax_variables(models[name]["port"], trainable_only=True)["params"]
    assert set(traverse_util.flatten_dict(ours)) == set(traverse_util.flatten_dict(trainable))
    t, f = partition(models[name]["port"])
    assert sum(p.numel() for p in t.values()) == sum(
        np.size(v) for v in jax.tree_util.tree_leaves(trainable))
    assert sum(p.numel() for p in f.values()) == sum(
        np.size(v) for v in jax.tree_util.tree_leaves(frozen))
    assert {n.split(".")[0] for n in f} == {"encoder" if name == "v1" else "swin"}


# ---------------------------------------------------------------- adapters


def _adapter_pair(kind: str, dtype_name: str = "float32"):
    """(JAX adapter, port adapter without weights, x, other) at a tiny site:
    the audio side of a tiny V1 stage-0 site for DG-SCT (32 wide, 64
    tokens, reading a 16-wide 256-token stream), a 32-wide stream for
    LAVisH."""
    from avmoe_tpu.config import AdapterConfig as JAdapterConfig
    from avmoe_tpu.models.ave_legacy import LAVisHAdapter as JLAVisH
    from avmoe_tpu.moe.dgsct_adapter import DGSCTAdapter as JDGSCT

    from avmoe_tpu_torch.config import AdapterConfig
    from avmoe_tpu_torch.models.ave_legacy import LAVisHAdapter
    from avmoe_tpu_torch.moe.dgsct_adapter import DGSCTAdapter

    kw = dict(downsample=4, num_conv_group=2, num_tokens=8)
    jdt, pdt = getattr(jnp, dtype_name), getattr(torch, dtype_name)
    rng = np.random.RandomState(7)
    if kind == "dgsct":
        x, other = rng.randn(2, 64, 32), rng.randn(2, 256, 16)
        geo = dict(dim=32, other_dim=16, num_tokens=64, other_num_tokens=256)
        jm = JDGSCT(cfg=JAdapterConfig(**kw), tokens_init="uniform", dtype=jdt, **geo)
        pm = DGSCTAdapter(cfg=AdapterConfig(**kw), dtype=pdt, **geo)
    else:
        x, other = rng.randn(2, 64, 32), rng.randn(2, 48, 32)
        jm = JLAVisH(dim=32, cfg=JAdapterConfig(**kw), use_gate=True, dtype=jdt)
        pm = LAVisHAdapter(32, AdapterConfig(**kw), use_gate=True, dtype=pdt)
    return jm, pm, x.astype(np.float32), other.astype(np.float32)


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("kind", ["dgsct", "lavish"])
def test_adapter_matches_jax(kind, train):
    """Output (and DG-SCT's s_maps); in train the batch-statistics norms and
    the running stats they update."""
    jm, pm, x, other = _adapter_pair(kind)
    variables = jax_variables(jm, jnp.asarray(x), jnp.asarray(other), seed=11)
    load_jax_variables(pm, variables)
    if train:
        ref, upd = jm.apply(to_jax(variables), jnp.asarray(x), jnp.asarray(other), train=True,
                            mutable=["batch_stats"])
        pm.train()
    else:
        ref = jm.apply(to_jax(variables), jnp.asarray(x), jnp.asarray(other))
    with torch.no_grad():
        ours = pm(torch.from_numpy(x), torch.from_numpy(other), train)
    ours, ref = _outputs(ours), _outputs(ref)
    assert len(ours) == len(ref) == (2 if kind == "dgsct" else 1)
    for a, b in zip(ours, ref):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FWD_TOL)
    if kind == "dgsct":
        maps = ours[1].numpy()
        assert maps.shape == (2, 1, 64)
        np.testing.assert_allclose(maps.sum(-1), 1.0, rtol=1e-5)
    if train:
        stats = _np(upd["batch_stats"])["bottleneck"]
        for bn in ("bn1", "bn2"):
            mod = getattr(pm.bottleneck, bn)
            np.testing.assert_allclose(mod.running_mean.numpy(), stats[bn]["mean"], **FWD_TOL)
            np.testing.assert_allclose(mod.running_var.numpy(), stats[bn]["var"], **FWD_TOL)


@pytest.mark.parametrize("stream", ["bfloat16", "float32"])
@pytest.mark.parametrize("kind", ["dgsct", "lavish"])
def test_adapter_bf16_matches_jax(kind, stream):
    """A bf16 adapter returns float32 in both packages, for a bf16 stream (a
    stage's first site) and a float32 one (every later site)."""
    jm, pm, x, other = _adapter_pair(kind, "bfloat16")
    variables = jax_variables(jm, jnp.asarray(x), jnp.asarray(other), seed=12)
    load_jax_variables(pm, variables)
    jx, jo = (jnp.asarray(t).astype(getattr(jnp, stream)) for t in (x, other))
    px, po = (torch.from_numpy(t).to(getattr(torch, stream)) for t in (x, other))
    ref = _outputs(jm.apply(to_jax(variables), jx, jo))
    with torch.no_grad():
        ours = _outputs(pm(px, po))
    for a, b in zip(ours, ref):
        assert a.dtype == torch.float32 and b.dtype == jnp.float32
        b = np.asarray(b, np.float32)
        d = np.abs(a.numpy() - b).max()
        assert d <= BF16_TOL * (1.0 + np.abs(b).max()), d


# ------------------------------------------------------- bf16 stream dtypes


def _jax_trace(jm, *args):
    """[(kind, input dtypes..., output dtype)] of every adapter call and
    every sub-block state update of a bf16 JAX forward, from eval_shape."""
    from flax import linen as nn

    from avmoe_tpu.models.ave_legacy import LAVisHAdapter
    from avmoe_tpu.moe.dgsct_adapter import DGSCTAdapter
    from avmoe_tpu.ops.swin import SwinBlock

    events = []

    def icpt(next_fun, a, kw, ctx):
        out = next_fun(*a, **kw)
        m, meth = ctx.module, ctx.method_name
        if isinstance(m, (DGSCTAdapter, LAVisHAdapter)) and meth == "__call__":
            o = out[0] if isinstance(out, tuple) else out
            events.append((m.name, str(a[0].dtype), str(a[1].dtype), str(o.dtype)))
        elif isinstance(m, SwinBlock) and meth in ("attn_state", "mlp_state"):
            events.append((meth, str(a[0].dtype), str(out.dtype)))
        return out

    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args))
    with nn.intercept_methods(icpt):
        jax.eval_shape(lambda v: jm.apply(v, *args), shapes)
    return events


def _port_trace(pm, *args, monkeypatch):
    import avmoe_tpu_torch.models.ave_legacy as al

    events = []
    names = {m: n.rsplit(".", 1)[-1] for n, m in pm.named_modules()}
    name = lambda t: str(t.dtype).replace("torch.", "")
    for fn in ("attn_state", "mlp_state"):
        inner = getattr(al, fn)

        def wrapped(blk, x, dt, train, generator, _i=inner, _n=fn):
            out = _i(blk, x, dt, train, generator)
            events.append((_n, name(x), name(out)))
            return out
        monkeypatch.setattr(al, fn, wrapped)
    hooks = []
    for m in pm.modules():
        if isinstance(m, (al.DGSCTAdapter, al.LAVisHAdapter)):
            hooks.append(m.register_forward_hook(lambda mod, a, out: events.append(
                (names[mod], name(a[0]), name(a[1]),
                 name(out[0] if isinstance(out, tuple) else out)))))
    try:
        pm(*args)
    finally:
        for h in hooks:
            h.remove()
    return events


@pytest.mark.parametrize("name", ["v1", "v2"])
def test_bf16_stream_dtypes_match_the_jax_trace(name, monkeypatch):
    """At every adapter site the dtypes of both streams and of the adapter's
    output, and at every sub-block the stream's dtype in and out, equal the
    JAX model's at bf16: bf16 from a stage's downsample to its first adapter
    residual, float32 after it."""
    from avmoe_tpu.models.ave_legacy import MMILNetV1 as JV1, MMILNetV2 as JV2

    from avmoe_tpu_torch.models.ave_legacy import MMILNetV1, MMILNetV2

    jcfg, pcfg = _cfgs()
    x = _inputs(jcfg)
    a = "wave" if name == "v1" else "audio_spec"
    J, P = (JV1, MMILNetV1) if name == "v1" else (JV2, MMILNetV2)
    want = _jax_trace(J(jcfg, dtype=jnp.bfloat16), jnp.asarray(x[a]),
                      jnp.asarray(x["images"]))
    pm = P(pcfg, dtype=torch.bfloat16, device="cpu", seed=0)
    got = _port_trace(pm, torch.from_numpy(x[a]), torch.from_numpy(x["images"]),
                      monkeypatch=monkeypatch)
    assert got == want
    assert {e[-1] for e in got} == {"bfloat16", "float32"}


# ------------------------------------------------------------ launch plans


def _counted(monkeypatch):
    """Calls of the four kernels' wrappers (K1 and K2 as ops/swin.py calls
    them, K1b and K2b as their autograd Functions do)."""
    import avmoe_tpu_torch.kernels.mlp_block as mb
    import avmoe_tpu_torch.kernels.window_attention as wa
    import avmoe_tpu_torch.ops.swin as swin

    counts = {"K1": 0, "K2": 0, "K1b": 0, "K2b": 0}
    for mod, fn, key in ((swin, "window_attention", "K1"), (swin, "mlp_block", "K2"),
                         (wa, "window_attention_bwd", "K1b"), (mb, "mlp_block_bwd", "K2b")):
        inner = getattr(mod, fn)
        monkeypatch.setattr(mod, fn, lambda *a, _i=inner, _k=key, **k: (
            counts.__setitem__(_k, counts[_k] + 1), _i(*a, **k))[1])
    return counts


@pytest.mark.parametrize("name", ["v1", "v2"])
def test_wrapper_calls_follow_the_launch_plans(models, name, monkeypatch):
    """An eval forward calls K1 / K2 as `mmil_v*_kernel_launches` plans; a
    train step K1 / K2 and K1b / K2b as the backward plan adds; the frozen
    Swin (and HTS-AT) bit-identical after it."""
    from avmoe_tpu_torch.config import AVEConfig, TrainConfig
    from avmoe_tpu_torch.models import ave_legacy as al
    from avmoe_tpu_torch.train.state import create_train_state
    from avmoe_tpu_torch.train.steps import make_train_step

    pcfg = models["cfgs"][1]
    pm, a = models[name]["port"], models[name]["arg"]
    x = models["inputs"]
    fwd = getattr(al, f"mmil_{name}_kernel_launches")(pcfg)
    bwd = getattr(al, f"mmil_{name}_backward_launches")(pcfg)
    counts = _counted(monkeypatch)
    pm(torch.from_numpy(x[a]), torch.from_numpy(x["images"]))
    assert counts == {"K1": fwd["K1"], "K2": fwd["K2"], "K1b": 0, "K2b": 0}
    assert fwd["K3"] == 0
    state = create_train_state(pm, TrainConfig(accum_steps=1))
    frozen = {n: p.detach().clone() for n, p in pm.named_parameters() if not p.requires_grad}
    make_loss = al.make_mmil_v1_loss_fn if name == "v1" else al.make_mmil_v2_loss_fn
    labels = np.eye(pcfg.num_classes + 1, dtype=np.float32)[
        np.random.RandomState(1).randint(0, pcfg.num_classes + 1, (2, pcfg.num_segments))]
    batch = {a: torch.from_numpy(x[a]), "images": torch.from_numpy(x["images"]),
             "labels": torch.from_numpy(labels)}
    for k in counts:
        counts[k] = 0
    state, met = make_train_step(make_loss(pm))(state, batch, torch.Generator().manual_seed(0))
    assert counts == {"K1": fwd["K1"], "K2": fwd["K2"], **bwd}
    assert np.isfinite(float(met["loss"]))
    assert all(torch.equal(p, frozen[n]) for n, p in pm.named_parameters() if n in frozen)
    full = AVEConfig()
    assert (getattr(al, f"mmil_{name}_kernel_launches")(full),
            getattr(al, f"mmil_{name}_backward_launches")(full)) == (
        ({"K1": 36, "K2": 36, "K3": 0}, {"K1b": 34, "K2b": 35}) if name == "v1"
        else ({"K1": 48, "K2": 48, "K3": 0}, {"K1b": 46, "K2b": 48}))
