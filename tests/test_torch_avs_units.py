"""The AVS modules one by one against the JAX package's: the 'mha' and
'token' unimodal experts (stacked over 2 experts, with gradients; the MHA's
dropout mask one (queries, keys) draw per expert, shared by its rows; its
attention across the frames, so a batch of 1 and a batch of 4 give a frame
different outputs), both resizes at both align_corners settings,
ResidualConvUnit and FeatureFusionBlock (channels-last; the residual is
relu(x)), TPAVI with audio and without, eval and train, with gradients,
MultiScaleTemporalAttention, every masked audio-visual loss flavour and the
IoU losses on given outputs, mask_iou and eval_fmeasure (an empty ground
truth included), and freezing with S4's ("swin",) and MS3's scopes.

Tolerance rtol 2e-3, atol 1e-4 for activations and gradients (the JAX
suite's); the losses and metrics on given outputs rtol 1e-5.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from torch_port_harness import FWD_TOL, jax_variables, to_jax

from avmoe_tpu_torch.convert import load_jax_variables

torch.set_num_threads(2)

EXACT = dict(rtol=1e-5, atol=1e-6)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _grads_match(pm, j_grads, x_grad=None, j_x_grad=None, batch_stats=None):
    """The port module's parameter gradients (p.grad) against JAX's
    gradient tree, read through the converter into a copy of the module."""
    want = copy.deepcopy(pm)
    load_jax_variables(want, {"params": j_grads, "batch_stats": batch_stats or {}})
    live = 0
    for (name, p), (_, w) in zip(pm.named_parameters(), want.named_parameters()):
        g = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(_np(g), _np(w), err_msg=name, **FWD_TOL)
        live += bool(w.abs().max() > 0)
    if x_grad is not None:
        np.testing.assert_allclose(_np(x_grad), np.asarray(j_x_grad), **FWD_TOL)
    return live


def _adapter_cfgs(kind: str):
    from avmoe_tpu.config import AdapterConfig as JA

    from avmoe_tpu_torch.config import AdapterConfig as PA

    kw = dict(downsample=4, num_conv_group=2, num_tokens=5, use_bn=False, use_gate=True,
              self_attention=kind)
    return JA(**kw), PA(**kw)


def _experts(kind: str, C: int, E: int = 2, seed: int = 0):
    from avmoe_tpu.moe.adapter import UnimodalExpert as JUni, _vmap_experts

    from avmoe_tpu_torch.moe.adapter import UnimodalExpert

    jcfg, pcfg = _adapter_cfgs(kind)
    jm = _vmap_experts(JUni, E, dim=C, cfg=jcfg)
    pm = UnimodalExpert(C, pcfg, E)
    return jm, pm


@pytest.mark.parametrize("kind", ["mha", "token"])
def test_unimodal_expert_matches_jax_with_gradients(kind):
    """(B', N, C) -> (E, B', N, C) at two experts, and the gradients of every
    stacked parameter and of x for a random output gradient."""
    B, N, C, E = 5, 6, 16, 2
    rng = np.random.RandomState(1)
    x = rng.randn(B, N, C).astype(np.float32)
    dout = rng.randn(E, B, N, C).astype(np.float32)
    jm, pm = _experts(kind, C, E)
    variables = jax_variables(jm, jnp.asarray(x), jnp.asarray(x), False, False, seed=2)
    load_jax_variables(pm, variables)

    def jloss(params, xx):
        out = jm.apply({"params": params}, xx, xx, False, False)
        return jnp.sum(out * dout), out

    (_, j_out), (j_gp, j_gx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        to_jax(variables["params"]), jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    out = pm(tx, tx)
    (out * torch.from_numpy(dout)).sum().backward()
    assert out.shape == (E, B, N, C)
    np.testing.assert_allclose(_np(out), np.asarray(j_out), **FWD_TOL)
    live = _grads_match(pm, jax.tree_util.tree_map(np.asarray, j_gp), tx.grad, j_gx)
    names = {n for n, _ in pm.named_parameters()}
    assert (("self_attention.query.kernel" in names) if kind == "mha"
            else {"latent_tokens", "gate_self"} <= names)
    assert live == len(names)


def test_mha_expert_in_bf16_matches_jax_bf16():
    """flax's MHA at dtype=bf16 (the installed flax: q and k promoted to
    bf16, the logits and the softmax in bf16, force_fp32_for_softmax off):
    the port computes the logits and the softmax in the compute dtype too.
    Both in bf16 against each other, |d| <= 3e-2 (1 + |ref|)."""
    from avmoe_tpu.moe.adapter import UnimodalExpert as JUni, _vmap_experts

    from avmoe_tpu_torch.moe.adapter import UnimodalExpert

    B, N, C, E = 6, 5, 16, 2
    x = np.random.RandomState(22).randn(B, N, C).astype(np.float32)
    jcfg, pcfg = _adapter_cfgs("mha")
    jm = _vmap_experts(JUni, E, dim=C, cfg=jcfg, dtype=jnp.bfloat16)
    variables = jax_variables(jm, jnp.asarray(x), jnp.asarray(x), False, False, seed=23)
    pm = UnimodalExpert(C, pcfg, E)
    load_jax_variables(pm, variables)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = np.asarray(jm.apply(to_jax(variables), xb, xb, False, False).astype(jnp.float32))
    with torch.no_grad():
        ours = pm(torch.from_numpy(x).bfloat16(), None).float().numpy()
    assert np.all(np.abs(ours - ref) <= 3e-2 * (1 + np.abs(ref)))


def test_mha_expert_mixes_the_frames_of_a_batch():
    """The 'mha' expert attends across B' at each token index, as the
    reference's sequence-first torch MHA reads (B', N, C): a frame's output
    depends on the other frames of its batch, in both packages."""
    B, N, C = 4, 6, 16
    x = np.random.RandomState(3).randn(B, N, C).astype(np.float32)
    jm, pm = _experts("mha", C)
    variables = jax_variables(jm, jnp.asarray(x), jnp.asarray(x), False, False, seed=4)
    load_jax_variables(pm, variables)
    with torch.no_grad():
        one, four = pm(torch.from_numpy(x[:1]), None), pm(torch.from_numpy(x), None)
    j_one = np.asarray(jm.apply(to_jax(variables), jnp.asarray(x[:1]), jnp.asarray(x[:1]),
                                False, False))
    np.testing.assert_allclose(_np(one), j_one, **FWD_TOL)
    assert np.abs(_np(one)[:, 0] - _np(four)[:, 0]).max() > 1e-2
    # a token's frames attend to each other only: shuffling the tokens
    # shuffles the outputs alike
    perm = np.random.RandomState(5).permutation(N)
    with torch.no_grad():
        shuffled = pm(torch.from_numpy(x[:, perm]), None)
    np.testing.assert_allclose(_np(shuffled), _np(four)[:, :, perm], rtol=1e-5, atol=1e-6)


def test_mha_expert_dropout_mask_is_one_per_expert_shared_by_its_rows():
    """flax draws one (queries, keys) mask per MHA call, shared by its batch
    rows (here the token index) and heads, and nn.vmap splits the dropout
    rng per expert: two identical token columns give identical train
    outputs, and two experts with the same weights different ones, in both
    packages."""
    B, N, C, E = 6, 4, 16, 2
    rng = np.random.RandomState(6)
    x = np.repeat(rng.randn(B, 1, C).astype(np.float32), N, axis=1)
    jm, pm = _experts("mha", C, E)
    variables = jax_variables(jm, jnp.asarray(x), jnp.asarray(x), False, False, seed=7)
    params = jax.tree_util.tree_map(lambda a: np.repeat(a[:1], E, axis=0), variables["params"])
    load_jax_variables(pm, {"params": params})
    with torch.no_grad():
        out = pm(torch.from_numpy(x), None, True, torch.Generator().manual_seed(0))
        plain = pm(torch.from_numpy(x), None)
    np.testing.assert_array_equal(_np(out)[:, :, 0], _np(out)[:, :, 1])
    assert np.abs(_np(out)[0] - _np(out)[1]).max() > 1e-3
    assert np.abs(_np(plain)[0] - _np(plain)[1]).max() == 0.0
    j_out = np.asarray(jm.apply({"params": to_jax(params)}, jnp.asarray(x), jnp.asarray(x),
                                True, False, rngs={"dropout": jax.random.PRNGKey(1)}))
    np.testing.assert_array_equal(j_out[:, :, 0], j_out[:, :, 1])
    assert np.abs(j_out[0] - j_out[1]).max() > 1e-3


@pytest.mark.parametrize("fn,align", [("bilinear", True), ("bilinear", False),
                                      ("bicubic", False), ("bicubic", True)])
@pytest.mark.parametrize("src,dst", [((12, 12), (14, 14)), ((48, 40), (56, 20)),
                                     ((7, 7), (14, 14)), ((1, 3), (4, 6))])
def test_resizes_match_jax(fn, align, src, dst):
    from avmoe_tpu.heads import avs as javs

    from avmoe_tpu_torch.heads import avs as pavs

    x = np.random.RandomState(8).randn(2, *src, 3).astype(np.float32)
    name = f"resize_{fn}"
    ours = getattr(pavs, name)(torch.from_numpy(x), *dst, align_corners=align)
    ref = getattr(javs, name)(jnp.asarray(x), *dst, align_corners=align)
    assert ours.shape == ref.shape == (2, *dst, 3)
    assert ours.is_contiguous()
    np.testing.assert_allclose(_np(ours), np.asarray(ref), rtol=1e-5, atol=1e-5)


def _fusion(skip: bool, C: int = 8):
    from avmoe_tpu.heads.avs import FeatureFusionBlock as JF

    from avmoe_tpu_torch.heads.avs import FeatureFusionBlock

    rng = np.random.RandomState(9)
    x = rng.randn(2, 5, 7, C).astype(np.float32)
    s = rng.randn(2, 5, 7, C).astype(np.float32) if skip else None
    jm = JF(C)
    args = (jnp.asarray(x),) + ((jnp.asarray(s),) if skip else ())
    variables = jax_variables(jm, *args, seed=10)
    pm = FeatureFusionBlock(C, skip=skip)
    load_jax_variables(pm, variables)
    return jm, pm, variables, x, s, args


@pytest.mark.parametrize("skip", [True, False], ids=["with skip", "coarsest"])
def test_feature_fusion_block_matches_jax_channels_last(skip):
    """NHWC in and out (x2 bilinear, align_corners); the flax HWIO conv
    kernels read into torch's OIHW weights."""
    jm, pm, variables, x, s, args = _fusion(skip)
    with torch.no_grad():
        ours = pm(torch.from_numpy(x), None if s is None else torch.from_numpy(s))
    ref = np.asarray(jm.apply(to_jax(variables), *args))
    assert ours.shape == ref.shape == (2, 10, 14, 8)
    np.testing.assert_allclose(_np(ours), ref, **FWD_TOL)
    assert ("res1" in variables["params"]) == skip


def test_nhwc_conv_layout_trap():
    """The flax conv reads (B, H, W, C) with an HWIO kernel; torch's conv
    reads (B, C, H, W) with OIHW. The port's Conv2d takes channels-last maps
    and the converted weight; feeding the same weight an NHWC tensor as if
    it were NCHW computes something else."""
    from flax import linen as fnn

    from avmoe_tpu_torch.heads.avs import Conv2d

    x = np.random.RandomState(11).randn(2, 6, 6, 6).astype(np.float32)   # H = W = C
    jm = fnn.Conv(6, (3, 3), padding=1)
    variables = jax_variables(jm, jnp.asarray(x), seed=12)
    pm = Conv2d(6, 6, 3, padding=1)
    load_jax_variables(pm, variables)
    assert variables["params"]["kernel"].shape == (3, 3, 6, 6) and pm.weight.shape == (6, 6, 3, 3)
    with torch.no_grad():
        ours = pm(torch.from_numpy(x))
        wrong = torch.nn.functional.conv2d(torch.from_numpy(x), pm.weight, pm.bias, padding=1)
    ref = np.asarray(jm.apply(to_jax(variables), jnp.asarray(x)))
    np.testing.assert_allclose(_np(ours), ref, **FWD_TOL)
    assert np.abs(_np(wrong) - ref).max() > 1e-1


def test_residual_conv_unit_adds_the_relud_input():
    """conv2(relu(conv1(relu(x)))) + relu(x), in both packages: against x as
    the residual it differs where x < 0."""
    from avmoe_tpu.heads.avs import ResidualConvUnit as JR

    from avmoe_tpu_torch.heads.avs import ResidualConvUnit

    x = np.random.RandomState(13).randn(2, 5, 5, 8).astype(np.float32)
    jm = JR(8)
    variables = jax_variables(jm, jnp.asarray(x), seed=14)
    pm = ResidualConvUnit(8)
    load_jax_variables(pm, variables)
    tx = torch.from_numpy(x)
    with torch.no_grad():
        ours = pm(tx)
        branch = pm.conv2(torch.relu(pm.conv1(torch.relu(tx))))
    ref = np.asarray(jm.apply(to_jax(variables), jnp.asarray(x)))
    np.testing.assert_allclose(_np(ours), ref, **FWD_TOL)
    np.testing.assert_allclose(_np(ours), _np(branch + torch.relu(tx)), rtol=1e-6, atol=1e-6)
    assert np.abs(_np(branch + tx) - ref).max() > 1e-1


@pytest.mark.parametrize("audio", [True, False], ids=["va", "vv"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_tpavi_matches_jax_with_gradients(audio, train):
    """TPAVI on (B, T, H, W, C), with the audio broadcast or on the visual
    map alone, W_z_bn on running stats (eval) or batch stats (train, its
    running stats updated as flax does): outputs, the aligned audio, the
    gradients of every parameter, of x and of the audio."""
    from avmoe_tpu.heads.avs import TPAVIModule as JT

    from avmoe_tpu_torch.heads.avs import TPAVIModule

    B, T, H, W, C = 2, 3, 4, 5, 16
    rng = np.random.RandomState(15)
    x = rng.randn(B, T, H, W, C).astype(np.float32)
    a = rng.randn(B, T, 128).astype(np.float32) if audio else None
    dz = rng.randn(B, T, H, W, C).astype(np.float32)
    jm = JT(C)
    jargs = (jnp.asarray(x), None if a is None else jnp.asarray(a))
    variables = jax_variables(jm, *jargs, seed=16)
    if not audio:    # the vv-only block never builds align_channel
        assert "align_channel" not in variables["params"]
    pm = TPAVIModule(C)
    if not audio:
        del pm.align_channel
    load_jax_variables(pm, variables)

    def jloss(params, xx, aa):
        (z, ja), upd = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                xx, aa, train=train, mutable=["batch_stats"])
        return jnp.sum(z * dz), (z, ja, upd)

    argnums = (0, 1, 2) if audio else (0, 1)
    (_, (jz, ja, upd)), jg = jax.value_and_grad(jloss, argnums=argnums, has_aux=True)(
        to_jax(variables["params"]), *jargs)
    tx = torch.from_numpy(x).requires_grad_()
    ta = torch.from_numpy(a).requires_grad_() if audio else None
    z, pa = pm(tx, ta, train)
    (z * torch.from_numpy(dz)).sum().backward()
    np.testing.assert_allclose(_np(z), np.asarray(jz), **FWD_TOL)
    assert (pa is None) == (ja is None)
    if audio:
        np.testing.assert_allclose(_np(pa), np.asarray(ja), **FWD_TOL)
        np.testing.assert_allclose(_np(ta.grad), np.asarray(jg[2]), **FWD_TOL)
    _grads_match(pm, jax.tree_util.tree_map(np.asarray, jg[0]), tx.grad, jg[1],
                 variables["batch_stats"])
    if train:
        stats = upd["batch_stats"]["W_z_bn"]
        np.testing.assert_allclose(_np(pm.W_z_bn.running_mean), np.asarray(stats["mean"]),
                                   **FWD_TOL)
        np.testing.assert_allclose(_np(pm.W_z_bn.running_var), np.asarray(stats["var"]),
                                   **FWD_TOL)


def test_tpavi_with_flax_zero_init_is_the_layer_norm_of_its_input():
    """W_z_conv's kernel and W_z_bn's scale start at zero (flax's
    initializers): the block then adds only W_z_bn's bias before its
    LayerNorm, whatever the attention computes, which is why the parity
    tests noise that scale."""
    from avmoe_tpu_torch.heads.avs import TPAVIModule
    from avmoe_tpu_torch.models.ave import init_parameters
    from avmoe_tpu_torch.ops.norm import layer_norm

    pm = TPAVIModule(8)
    init_parameters(pm, torch.Generator().manual_seed(0))
    with torch.no_grad():
        pm.W_z_bn.weight.zero_()
        x = torch.randn(1, 2, 3, 3, 8)
        z, _ = pm(x, torch.randn(1, 2, 128))
    torch.testing.assert_close(z, layer_norm(x, pm.norm_layer.weight, pm.norm_layer.bias))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_multiscale_temporal_attention_matches_jax(train, monkeypatch):
    """Four levels (maps (B*T, s, s, C) at s = 6, 3, 2, 1), the BiLSTMs,
    transformer encoders and gates; train deterministic
    (AVMOE_DETERMINISTIC_TRAIN=1) on both sides."""
    from avmoe_tpu.heads.avs import MultiScaleTemporalAttention as JM

    from avmoe_tpu_torch.heads.avs import MultiScaleTemporalAttention

    monkeypatch.setenv("AVMOE_DETERMINISTIC_TRAIN", "1")
    B, T, C = 2, 3, 32
    rng = np.random.RandomState(17)
    maps = [rng.randn(B * T, s, s, C).astype(np.float32) for s in (6, 3, 2, 1)]
    audio = rng.randn(B, T, 128).astype(np.float32)
    jm = JM(d_model=C, num_segments=T, gamma=0.1)
    jargs = ([jnp.asarray(m) for m in maps], jnp.asarray(audio))
    variables = jax_variables(jm, *jargs, seed=18)
    pm = MultiScaleTemporalAttention(d_model=C, num_segments=T, gamma=0.1)
    load_jax_variables(pm, variables)
    j_maps, j_audio = jm.apply(to_jax(variables), *jargs, train=train,
                               rngs={"dropout": jax.random.PRNGKey(0)})
    with torch.no_grad():
        p_maps, p_audio = pm([torch.from_numpy(m) for m in maps], torch.from_numpy(audio),
                             train, torch.Generator().manual_seed(0))
    for ours, ref in zip(p_maps, j_maps):
        np.testing.assert_allclose(_np(ours), np.asarray(ref), **FWD_TOL)
    np.testing.assert_allclose(_np(p_audio), np.asarray(j_audio), **FWD_TOL)
    assert np.abs(_np(p_audio) - audio.reshape(B * T, -1)).max() > 1e-3


def _loss_inputs(seed: int = 19):
    rng = np.random.RandomState(seed)
    BT, M = 6, 24
    logits = rng.randn(BT, M, M).astype(np.float32) * 2
    maps = [np.abs(rng.randn(BT, s, s, 8)).astype(np.float32) for s in (12, 6, 4, 3)]
    a_fea = [rng.randn(3, 2, 8).astype(np.float32) for _ in range(4)]
    return logits, maps, a_fea


FLAVOURS = [(kind, closer, thr, norm, setting)
            for kind in ("cosine", "euclidean", "kl") for closer in (False, True)
            for thr in (False, True) for norm in (False, True) for setting in ("s4", "ms3")]


@pytest.mark.parametrize("pooling", ["avg", "max"])
@pytest.mark.parametrize("kind,closer,thr,norm,setting", FLAVOURS)
def test_masked_av_loss_matches_jax(kind, closer, thr, norm, setting, pooling):
    from avmoe_tpu.losses.avs import masked_av_loss as j_loss

    from avmoe_tpu_torch.losses.avs import masked_av_loss

    logits, maps, a_fea = _loss_inputs()
    kw = dict(pooling=pooling, norm_fea=norm, threshold=thr, kind=kind, closer=closer,
              setting=setting)
    stages = (0, 1, 2, 3)
    ours = masked_av_loss(torch.from_numpy(logits), [torch.from_numpy(a) for a in a_fea],
                          [torch.from_numpy(m) for m in maps], stages, **kw)
    ref = j_loss(jnp.asarray(logits), [jnp.asarray(a) for a in a_fea],
                 [jnp.asarray(m) for m in maps], stages, **kw)
    np.testing.assert_allclose(float(ours), float(ref), **EXACT)


def test_sigmoid_order_of_s4_and_ms3_differs():
    """S4 takes the sigmoid of the full-size masks before pooling, MS3 of the
    pooled logits: the orders do not commute."""
    from avmoe_tpu_torch.losses.avs import _masked_visual_feature

    logits, maps, _ = _loss_inputs()
    lg, m = torch.from_numpy(logits), torch.from_numpy(maps[0])
    s4 = _masked_visual_feature(lg, m, "avg", False, sigmoid_after_pool=False)
    ms3 = _masked_visual_feature(lg, m, "avg", False, sigmoid_after_pool=True)
    assert (s4 - ms3).abs().max() > 1e-3


@pytest.mark.parametrize("setting", ["s4", "ms3"])
def test_iou_semantic_aware_loss_matches_jax(setting):
    from avmoe_tpu.losses.avs import iou_semantic_aware_loss as j_loss

    from avmoe_tpu_torch.losses.avs import iou_semantic_aware_loss

    logits, maps, a_fea = _loss_inputs()
    rng = np.random.RandomState(20)
    gt = (rng.rand(3, 24, 24) > 0.6 if setting == "s4"
          else rng.rand(3, 2, 24, 24) > 0.6).astype(np.float32)
    kw = dict(setting=setting, num_frames=2, lambda_1=0.5, count_stages=(0, 2),
              sa_loss_flag=True, kind="kl" if setting == "ms3" else "cosine")
    ours, aux = iou_semantic_aware_loss(
        torch.from_numpy(logits), torch.from_numpy(gt), [torch.from_numpy(a) for a in a_fea],
        [torch.from_numpy(m) for m in maps], **kw)
    ref, j_aux = j_loss(jnp.asarray(logits), jnp.asarray(gt), [jnp.asarray(a) for a in a_fea],
                        [jnp.asarray(m) for m in maps], **kw)
    np.testing.assert_allclose(float(ours), float(ref), **EXACT)
    assert set(aux) == set(j_aux) == {"iou_loss", "sa_loss"}
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(j_aux[k]), **EXACT)


def test_mask_iou_and_fmeasure_match_jax_with_an_empty_ground_truth():
    from avmoe_tpu.metrics.avs import eval_fmeasure as j_f, mask_iou as j_iou

    from avmoe_tpu_torch.metrics.avs import eval_fmeasure, mask_iou

    rng = np.random.RandomState(21)
    logits = rng.randn(5, 20, 20).astype(np.float32) * 3
    gt = (rng.rand(5, 20, 20) > 0.5).astype(np.float32)
    gt[2] = 0.0
    for lg, y in ((logits, gt), (logits[2:3], gt[2:3])):   # with one empty, only empty
        np.testing.assert_allclose(float(mask_iou(torch.from_numpy(lg), torch.from_numpy(y))),
                                   float(j_iou(jnp.asarray(lg), jnp.asarray(y))), **EXACT)
        np.testing.assert_allclose(
            float(eval_fmeasure(torch.from_numpy(lg), torch.from_numpy(y))),
            float(j_f(jnp.asarray(lg), jnp.asarray(y))), **EXACT)
    # an empty ground truth scores the background IoU of the prediction
    empty = float(mask_iou(torch.from_numpy(logits[2:3]), torch.from_numpy(gt[2:3])))
    assert empty == pytest.approx(float((logits[2] <= 0).mean()), rel=1e-6)


@pytest.fixture(scope="module")
def tiny_trees():
    """The JAX tiny AVS parameter tree (zeros shaped by eval_shape) and the
    port's tiny AVSModel, both backbones at depths 1-1-1-1 (the counts hold
    at any depth; the JAX trace is the fixture's cost)."""
    from avmoe_tpu import config as jc
    from avmoe_tpu.models.avs import AVSModel as JAVS

    from avmoe_tpu_torch import config as pc
    from avmoe_tpu_torch.models.avs import AVSModel

    def cut(cfg):
        return dataclasses.replace(
            cfg, swin=dataclasses.replace(cfg.swin, depths=(1, 1, 1, 1)),
            htsat=dataclasses.replace(cfg.htsat, depths=(1, 1, 1, 1)))

    shapes = jax.eval_shape(lambda: JAVS(cut(jc.tiny_avs_config())).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 64, 64, 3)), jnp.zeros((1, 2, 4000))))
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes["params"])
    return params, AVSModel(cut(pc.tiny_avs_config()), device="cpu", seed=0)


@pytest.mark.parametrize("scopes", [("swin",), ("swin", "htsat")], ids=["s4", "ms3"])
def test_freeze_scopes_match_jax_param_report(tiny_trees, scopes):
    """S4 trains HTS-AT (its reference freezes only Swin), MS3 freezes both:
    the counts of the port's tiny AVS model against the JAX package's
    param_report over the same tree."""
    from avmoe_tpu.train.freeze import param_report as j_report

    from avmoe_tpu_torch.config import tiny_avs_config
    from avmoe_tpu_torch.models.avs import avs_frozen_scopes
    from avmoe_tpu_torch.train.freeze import freeze, param_report

    params, pm = tiny_trees
    j_counts = j_report(params, scopes)
    ours = param_report(pm, scopes)
    for key in ("trainable", "frozen", "total"):
        assert ours[key] == j_counts[key] > 0, key
    trainable = freeze(pm, scopes)
    assert any(n.startswith("encoder.htsat.") for n in trainable) == (scopes == ("swin",))
    assert not any(n.startswith("encoder.swin.") for n in trainable)
    cfg = dataclasses.replace(tiny_avs_config(), setting="s4" if len(scopes) == 1 else "ms3")
    assert avs_frozen_scopes(cfg) == scopes
