"""The rest of AVE against the JAX package: the CMBS interaction block
(`AudioVideoInter`, `CMBSHead(inter=True)`), the tiny AVEModel with each
head setting the JAX model supports, the config presets field by field, and
the scv2 HTS-AT flavor's front end (16 kHz, hop 160) at full width.

One JAX compile for the file: the tiny AVEModel with is_cmbs=False (both
backbones cut to depths 2-2-2-2: the heads read the encoder's pooled
features, whose shapes do not depend on the depth), whose forward also
hands out the encoder's pooled features (f_v, f_a) through
`capture_intermediates`. The other head settings are held against the JAX
heads applied eagerly to those features, under the same encoder weights.
The JAX AVEModel itself cannot be built with is_temporal_att=False: it
creates that path's `nn.Dropout` inside `__call__` of a `setup` module,
which flax refuses (AssignSubModuleError); in eval the dropout is the
identity, so the reference applies the JAX `v_fc` / `a_fc` Dense layers,
ReLU and the JAX `CMBSHead` in that order, as the JAX model's body does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from torch_port_harness import FWD_TOL, jax_variables, port_variables, to_jax

from avmoe_tpu_torch.convert import load_jax_variables

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


DEPTHS = (2, 2, 2, 2)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _cut(cfg, **kw):
    return dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin, depths=DEPTHS),
                               htsat=dataclasses.replace(cfg.htsat, depths=DEPTHS), **kw)


def _close(ours, ref):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), **FWD_TOL)


# ---------------------------------------------------------------------------
# the interaction block alone
# ---------------------------------------------------------------------------


def test_audio_video_inter_matches_jax():
    from avmoe_tpu.heads.ave import AudioVideoInter as JInter

    from avmoe_tpu_torch.heads.ave import AudioVideoInter

    rng = np.random.RandomState(3)
    video, audio = rng.randn(2, 2, 5, 16).astype(np.float32)
    jm, pm = JInter(16), AudioVideoInter(16)
    variables = jax_variables(jm, jnp.asarray(video), jnp.asarray(audio), seed=5)
    load_jax_variables(pm, variables)
    assert pm.norm1.eps == 1e-5
    _close(pm(_t(video), _t(audio)), jm.apply(to_jax(variables), jnp.asarray(video),
                                              jnp.asarray(audio)))


def test_audio_video_inter_train_draws():
    """Train mode draws its masks from the generator: the same seed gives
    the same output, another seed another, and eval none."""
    from avmoe_tpu_torch.heads.ave import AudioVideoInter

    torch.manual_seed(0)
    pm = AudioVideoInter(16)
    for p in pm.parameters():
        torch.nn.init.normal_(p, std=0.3)
    video, audio = torch.randn(2, 2, 5, 16, generator=torch.Generator().manual_seed(1))
    run = lambda seed: pm(video, audio, True, torch.Generator().manual_seed(seed))
    torch.testing.assert_close(run(4), run(4), rtol=0, atol=0)
    assert (run(4) - run(5)).abs().max() > 1e-3
    assert (run(4) - pm(video, audio)).abs().max() > 1e-3


def test_cmbs_head_inter_matches_jax():
    from avmoe_tpu.heads.ave import CMBSHead as JCMBS

    from avmoe_tpu_torch.heads.ave import CMBSHead

    rng = np.random.RandomState(7)
    vis, aud = rng.randn(2, 3, 6, 16).astype(np.float32)
    jm, pm = JCMBS(num_classes=7, d_model=16, inter=True), CMBSHead(7, 16, inter=True)
    variables = jax_variables(jm, jnp.asarray(vis), jnp.asarray(aud), seed=9)
    assert {"av_inter", "va_inter"} <= set(variables["params"])
    load_jax_variables(pm, variables)
    for a, b in zip(pm(_t(vis), _t(aud)), jm.apply(to_jax(variables), jnp.asarray(vis),
                                                   jnp.asarray(aud))):
        _close(a, b)


# ---------------------------------------------------------------------------
# the tiny AVEModel with each head setting
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def no_cmbs():
    """The JAX tiny AVEModel with is_cmbs=False on seeded-noise weights (the
    port's export gives the tree), its outputs and its encoder's features."""
    from avmoe_tpu.config import tiny_ave_config as jax_tiny
    from avmoe_tpu.models.ave import AVEModel as JAVE

    from avmoe_tpu_torch.config import tiny_ave_config
    from avmoe_tpu_torch.models.ave import AVEModel

    cfg = _cut(tiny_ave_config(), is_cmbs=False)
    pm = AVEModel(cfg, device="cpu", seed=None)
    variables = port_variables(pm, seed=1)
    load_jax_variables(pm, variables)
    rng = np.random.RandomState(0)
    wave = rng.randn(2, cfg.num_segments, cfg.audio_len).astype(np.float32) * 0.1
    imgs = rng.rand(2, cfg.num_segments, 64, 64, 3).astype(np.float32)
    jm = JAVE(_cut(jax_tiny(), is_cmbs=False))
    ref, state = jax.jit(lambda v, w, i: jm.apply(
        v, w, i, capture_intermediates=lambda mdl, name: mdl.name == "encoder"))(
        to_jax(variables), jnp.asarray(wave), jnp.asarray(imgs))
    f_v, f_a, _ = state["intermediates"]["encoder"]["__call__"][0]
    B, T = wave.shape[:2]
    return dict(cfg=cfg, model=pm, variables=variables, wave=wave, imgs=imgs,
                ref=jax.tree_util.tree_map(np.asarray, ref),
                f_v=np.asarray(f_v).reshape(B, T, -1), f_a=np.asarray(f_a).reshape(B, T, -1))


def test_tiny_ave_classification_path_matches_jax(no_cmbs):
    out = no_cmbs["model"](_t(no_cmbs["wave"]), _t(no_cmbs["imgs"]))
    ref = no_cmbs["ref"]
    assert set(out) == set(ref) == {"segment_probs", "telemetry"}
    assert out["segment_probs"].shape == (2, 2, 29)
    _close(out["segment_probs"], ref["segment_probs"])
    np.testing.assert_allclose(out["segment_probs"].sum(-1).numpy(), 1.0, rtol=1e-6)
    for key in ("audio_p1", "audio_p2", "video_p1", "video_p2"):
        _close(out["telemetry"][key], ref["telemetry"][key])


def _port_model(no_cmbs, seed: int, **head):
    """The port's tiny AVEModel with another head setting: its own seeded
    head weights, the encoder weights of `no_cmbs`."""
    from avmoe_tpu_torch.models.ave import AVEModel

    pm = AVEModel(dataclasses.replace(no_cmbs["cfg"], is_cmbs=True, **head), device="cpu",
                  seed=None)
    variables = port_variables(pm, seed=seed)
    for col in ("params", "batch_stats"):
        variables[col]["encoder"] = no_cmbs["variables"][col]["encoder"]
    load_jax_variables(pm, variables)
    return pm, variables["params"]


def _check_cmbs_outputs(pm, no_cmbs, ref):
    out = pm(_t(no_cmbs["wave"]), _t(no_cmbs["imgs"]))
    for key, r in zip(("is_event_logits", "event_logits", "av_score"), ref):
        assert out[key].shape == r.shape
        _close(out[key], r)


def test_tiny_ave_without_temporal_attention_matches_jax(no_cmbs):
    import flax.linen as fnn

    from avmoe_tpu.heads.ave import CMBSHead as JCMBS

    pm, params = _port_model(no_cmbs, 2, is_temporal_att=False)
    assert {"v_fc", "a_fc", "cmbs"} <= set(params) and "temporal_attn" not in params
    d = no_cmbs["cfg"].d_model
    dense = lambda name, x: fnn.Dense(d).apply({"params": to_jax(params[name])}, jnp.asarray(x))
    visual = jax.nn.relu(dense("v_fc", no_cmbs["f_v"]))
    audio = jax.nn.relu(dense("a_fc", no_cmbs["f_a"]))
    ref = JCMBS(num_classes=28, d_model=d).apply({"params": to_jax(params["cmbs"])},
                                                 visual, audio)
    _check_cmbs_outputs(pm, no_cmbs, ref)


def test_tiny_ave_inter_in_cmbs_matches_jax(no_cmbs):
    from avmoe_tpu.heads.ave import CMBSHead as JCMBS, TemporalAttention as JTA

    cfg = no_cmbs["cfg"]
    pm, params = _port_model(no_cmbs, 3, is_inter_in_cmbs=True)
    assert {"av_inter", "va_inter"} <= set(params["cmbs"])
    jta = JTA(video_input_dim=cfg.swin.num_features, audio_input_dim=cfg.htsat.num_features,
              d_model=cfg.d_model)
    visual, audio, _ = jta.apply({"params": to_jax(params["temporal_attn"])},
                                 jnp.asarray(no_cmbs["f_v"]), jnp.asarray(no_cmbs["f_a"]))
    ref = JCMBS(num_classes=28, d_model=cfg.d_model, inter=True).apply(
        {"params": to_jax(params["cmbs"])}, visual, audio)
    _check_cmbs_outputs(pm, no_cmbs, ref)


def test_head_settings_tree_matches_jax():
    """The port's parameter tree of each head setting is the JAX model's
    (from its eval_shape) for the heads; mlp_class lands in the lr_mlp
    group as in the JAX optimizer."""
    from avmoe_tpu.heads.ave import CMBSHead as JCMBS

    from avmoe_tpu_torch.config import TrainConfig, tiny_ave_config
    from avmoe_tpu_torch.convert import export_jax_variables
    from avmoe_tpu_torch.models.ave import AVEModel
    from avmoe_tpu_torch.train.state import create_train_state

    shapes = lambda tree: jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)
    pm = AVEModel(dataclasses.replace(tiny_ave_config(), is_inter_in_cmbs=True),
                  device="cpu", seed=0)
    x = jnp.zeros((2, 2, 32))
    jshapes = jax.eval_shape(lambda: JCMBS(num_classes=28, d_model=32, inter=True).init(
        jax.random.PRNGKey(0), x, x))
    assert shapes(export_jax_variables(pm)["params"]["cmbs"]) == shapes(
        dict(jshapes["params"]))
    pm = AVEModel(dataclasses.replace(tiny_ave_config(), is_cmbs=False), device="cpu", seed=0)
    state = create_train_state(pm, TrainConfig(lr=1e-3, lr_mlp=1e-5))
    lrs = {n: g["lr"] for g in state.optimizer.param_groups for n, p in state.trainable.items()
           if any(p is q for q in g["params"])}
    assert lrs["mlp_class.weight"] == lrs["mlp_class_2.bias"] == 1e-5
    assert lrs["encoder.audio_moe_p1_0.multimodal_experts.latent_tokens"] == 1e-3


# ---------------------------------------------------------------------------
# presets
# ---------------------------------------------------------------------------


def _as_dict(cfg):
    return dataclasses.asdict(cfg)


def _strip(d, drop=("remat", "remat_policy", "token_shard_axis")):
    """A JAX config dict without its TPU layout fields, which the port does
    not carry."""
    if isinstance(d, dict):
        return {k: _strip(v, drop) for k, v in d.items() if k not in drop}
    return d


@pytest.mark.parametrize("backbone", ["esc-50", "audioset", "scv2"])
@pytest.mark.parametrize("size", ["large", "base", "small"])
def test_flavor_presets_match_jax(backbone, size):
    from avmoe_tpu import config as J

    from avmoe_tpu_torch import config as P

    cfg, ckpt = P.ave_flavor_config(backbone, size)
    jcfg, jckpt = J.ave_flavor_config(backbone, size)
    assert ckpt == jckpt
    assert _as_dict(cfg) == _strip(_as_dict(jcfg))
    assert _as_dict(P.swin_model_preset(size)) == _strip(_as_dict(J.swin_model_preset(size)))
    assert P.htsat_backbone_preset(backbone)[1] == J.htsat_backbone_preset(backbone)[1]


def test_presets_match_jax():
    from avmoe_tpu import config as J

    from avmoe_tpu_torch import config as P

    assert P.HTSAT_BACKBONE_FLAVORS == J.HTSAT_BACKBONE_FLAVORS
    for mk in ("large", "base"):
        assert _as_dict(getattr(P.SwinV2Config, mk)()) == _strip(
            _as_dict(getattr(J.SwinV2Config, mk)()))
    cfg, tcfg = P.ave_train_preset()
    jcfg, jtcfg = J.ave_train_preset()
    assert _as_dict(cfg) == _strip(_as_dict(jcfg))
    assert _as_dict(tcfg) == _as_dict(jtcfg)
    assert _as_dict(P.mini_ave_config()) == _strip(_as_dict(J.mini_ave_config()))
    assert P.replace(P.TrainConfig(), seed=3).seed == 3
    for bad in (lambda: P.htsat_backbone_preset("nope"), lambda: P.swin_model_preset("huge")):
        with pytest.raises(NotImplementedError):
            bad()


def test_presets_meet_the_kernel_contracts():
    """Every preset's windows and widths fit K1 (N <= 256, D <= 64), K3
    (N <= 144) and K2 in bf16 (C % 8 == 0)."""
    from avmoe_tpu_torch import config as P

    for backbone in P.HTSAT_BACKBONE_FLAVORS:
        for size in ("large", "base"):
            cfg, _ = P.ave_flavor_config(backbone, size)
            for bb in (cfg.swin, cfg.htsat):
                N = bb.window_size ** 2
                assert N <= 144
                for i, heads in enumerate(bb.num_heads):
                    C = bb.embed_dim * 2 ** i
                    assert C % 8 == 0 and C // heads <= 64


def test_scv2_frontend_matches_jax_at_full_width():
    """The scv2 flavor (16 kHz, hop 160: 201 frames for a 32000-sample
    segment) through the log-mel and HTS-AT's bicubic fold to 1024 frames,
    at the full HTS-AT geometry."""
    from avmoe_tpu.audio import frontend as jfe
    from avmoe_tpu.config import htsat_backbone_preset as jpreset

    from avmoe_tpu_torch.audio import frontend as fe
    from avmoe_tpu_torch.config import htsat_backbone_preset

    cfg, _ = htsat_backbone_preset("scv2")
    jcfg, _ = jpreset("scv2")
    assert (cfg.frontend.sample_rate, cfg.frontend.hop_length) == (16_000, 160)
    wave = np.random.RandomState(11).randn(2, 32_000).astype(np.float32) * 0.1
    spec = fe.log_mel_spectrogram(_t(wave), cfg.frontend)
    jspec = jfe.log_mel_spectrogram(jnp.asarray(wave), jcfg.frontend)
    assert spec.shape == (2, 201, 64)
    _close(spec, jspec)
    img = fe.reshape_wav2img(spec, cfg.spec_size, cfg.freq_ratio)
    assert img.shape == (2, 256, 256, 1)
    _close(img, jfe.reshape_wav2img(jspec, cfg.spec_size, cfg.freq_ratio))
