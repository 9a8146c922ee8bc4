"""The port's AVSBench baseline (avmoe_tpu_torch/models/avs_baseline.py
`AVSBaselineModel`, with backbones/pvt.py, backbones/resnet.py and
heads/avs.py `ASPPClassifier`) against the JAX package's, on the CPU.

Each encoder runs at a cut depth: the JAX module's `pvt_v2_b5` is patched to
PVT-v2-b0's widths at depths 1-1-1-1 and `B2ResNet` to depths 1-1-1-1 (the
JAX source is unchanged; the port takes the same encoder through its
`encoder` argument), with 64-px frames, T = 2 segments, 2 clips. Per encoder
one JAX compile, in a module fixture, gives the eval forward (with the
encoder's pyramid and the four ASPP outputs captured) and the S4 train
step's loss, gradients and updated batch statistics.

The encoder's weights come from one seeded reference-layout state dict
(tests/torch_reference_layout.py `pvt_v2_state_dict` /
`b2_resnet_state_dict`) through each package's converter (`convert_pvt_v2`,
`convert_b2_resnet`); the rest of the tree is seeded noise, TPAVI's W_z
non-zero, so every leaf gets a gradient. The JAX side runs in float64
(`jax.enable_x64`): its own float32 train-mode gradient of the ResNet case
is 2.5% (of a leaf's largest element) off its float64 one, the flax
BatchNorm's batch statistics in float32, where the port's float32 gradient
is within 2e-5 of it. Tolerances, the port in float32: activations
FWD_TOL (rtol 2e-3, atol 1e-4), the loss rtol 1e-5; a gradient leaf within
1e-3 of its largest |element| and at a cosine >= 0.9999, where that largest
element is above 1e-6 of the whole gradient's (the conv biases before
TPAVI's train-mode BatchNorm have an exact gradient of zero: there the
port's is below 1e-6 of the largest too); the running statistics FWD_TOL.
The full-width trees are held to the JAX ones in
tests/test_torch_avs_baseline_trees.py.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

import torch_reference_layout as ref
from torch_port_harness import FWD_TOL
from torch_train_harness import cos, flat

from avmoe_tpu.backbones import pvt as jpvt
from avmoe_tpu.backbones import resnet as jres
from avmoe_tpu.checkpoint import convert as jcv
from avmoe_tpu.heads.avs import ASPPClassifier as JASPP
from avmoe_tpu.losses import avs as jloss
from avmoe_tpu.models import avs_baseline as jab
from avmoe_tpu_torch.backbones.pvt import PVTv2
from avmoe_tpu_torch.backbones.resnet import B2ResNet
from avmoe_tpu_torch.checkpoint import convert as pcv
from avmoe_tpu_torch.convert import export_jax_variables, load_jax_variables
from avmoe_tpu_torch.models.avs_baseline import AVSBaselineModel, make_avs_baseline_loss_fn

torch.set_num_threads(2)

B, T, PX, CHANNEL = 2, 2, 64, 32
PVT_TINY = dict(dims=(32, 64, 160, 256), depths=(1, 1, 1, 1), mlp_ratios=(8, 8, 4, 4),
                drop_path_rate=0.0)
RESNET_DEPTHS = (1, 1, 1, 1)
ENCODERS = ("pvt", "resnet")


def _inputs(seed: int):
    rng = np.random.RandomState(seed)
    imgs = rng.rand(B, T, PX, PX, 3).astype(np.float32)
    audio = rng.randn(B, T, 128).astype(np.float32)
    mask = (rng.rand(B, PX, PX) > 0.6).astype(np.float32)
    return imgs, audio, mask


def _port_encoder(backbone: str):
    return PVTv2(**PVT_TINY) if backbone == "pvt" else B2ResNet(depths=RESNET_DEPTHS)


def _jax_model(backbone: str, mp):
    """The JAX baseline at the cut encoder (its constructors patched)."""
    mp.setattr(jab, "pvt_v2_b5", lambda: jpvt.PVTv2(**PVT_TINY))
    mp.setattr(jab, "B2ResNet", functools.partial(jres.B2ResNet, depths=RESNET_DEPTHS))
    return jab.AVSBaselineModel(backbone=backbone, channel=CHANNEL, num_segments=T)


def _convert(cv, backbone: str, sd):
    if backbone == "pvt":
        return cv.convert_pvt_v2(sd, depths=PVT_TINY["depths"]), None
    return cv.convert_b2_resnet(sd, depths=RESNET_DEPTHS)


def _captured(inter, name):
    return [np.asarray(a) for a in inter[name]["__call__"][0]] if name == "encoder_backbone" \
        else np.asarray(inter[name]["__call__"][0])


@pytest.fixture(scope="module", params=ENCODERS)
def case(request):
    """backbone -> the reference dict, both converters' encoder trees, the
    variables, and JAX's eval outputs, captured pyramid / ASPP outputs, S4
    loss, gradients and updated batch statistics."""
    backbone = request.param
    imgs, audio, mask = _inputs(3)
    with pytest.MonkeyPatch.context() as mp:
        model = _jax_model(backbone, mp)
        shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), imgs, audio)
        variables = ref.seeded_variables({k: dict(v) for k, v in shapes.items()}, seed=11)
        seeded = (variables["params"]["encoder_backbone"],
                  variables["batch_stats"].get("encoder_backbone"))
        if backbone == "pvt":
            sd = ref.pvt_v2_state_dict(seeded[0])
        else:
            sd = ref.b2_resnet_state_dict(*seeded)
        jtree, ptree = _convert(jcv, backbone, sd), _convert(pcv, backbone, sd)
        variables["params"]["encoder_backbone"] = jtree[0]
        if jtree[1] is not None:
            variables["batch_stats"]["encoder_backbone"] = jtree[1]
        keep = lambda mdl, method: method == "__call__" and isinstance(
            mdl, (jpvt.PVTv2, jres.B2ResNet, JASPP))
        f64 = lambda tree: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)

        def run(v, x, a, m):
            out, inter = model.apply(v, x, a, capture_intermediates=keep,
                                     mutable=["intermediates"])

            def loss(params):
                o, upd = model.apply({"params": params, "batch_stats": v["batch_stats"]}, x, a,
                                     train=True, mutable=["batch_stats"])
                total, _ = jloss.iou_semantic_aware_loss(
                    o["mask_logits"], m, o["a_fea_list"], o["feature_map_list"], setting="s4",
                    num_frames=T)
                return total, upd

            (total, upd), grads = jax.value_and_grad(loss, has_aux=True)(v["params"])
            return out, inter["intermediates"], total, grads, upd["batch_stats"]

        with jax.enable_x64(True):
            got = jax.jit(run)(f64(variables), *f64((imgs, audio, mask)))
            out, inter, total, grads, stats = jax.tree_util.tree_map(np.asarray, got)
    return dict(backbone=backbone, sd=sd, seeded=seeded, jtree=jtree, ptree=ptree,
                variables=variables,
                inputs=(imgs, audio, mask), out=out, inter=inter, loss=float(total),
                grads=grads, stats=stats)


def _port_model(case):
    model = AVSBaselineModel(case["backbone"], channel=CHANNEL, num_segments=T, device="cpu",
                             seed=None, encoder=_port_encoder(case["backbone"]))
    v = case["variables"]
    params = dict(v["params"], encoder_backbone=case["ptree"][0])
    stats = dict(v["batch_stats"])
    if case["ptree"][1] is not None:
        stats["encoder_backbone"] = case["ptree"][1]
    load_jax_variables(model, {"params": params, "batch_stats": stats})
    return model


def _leaves_equal(ours, theirs):
    a, b = flat(ours), flat(theirs)
    assert sorted(a) == sorted(b) and a
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_converter_equals_jax(case):
    """The port's converter gives JAX's tree leaf for leaf (dtype and value),
    and that tree is the one the reference dict was written from."""
    for ours, theirs in zip(case["ptree"], case["jtree"]):
        if theirs is None:
            assert ours is None
            continue
        _leaves_equal(ours, jax.tree_util.tree_map(np.asarray, theirs))
        for x in jax.tree_util.tree_leaves(ours):
            assert isinstance(x, np.ndarray) and x.dtype == np.float32
    for ours, seeded in zip(case["ptree"], case["seeded"]):
        if seeded is not None:
            _leaves_equal(ours, seeded)


def test_converted_encoder_round_trip(case):
    """The converted encoder tree loads into the port's encoder (strictly)
    and exports back to itself."""
    enc = _port_encoder(case["backbone"])
    variables = {"params": case["ptree"][0]}
    if case["ptree"][1] is not None:
        variables["batch_stats"] = case["ptree"][1]
    load_jax_variables(enc, variables)
    back = export_jax_variables(enc)
    _leaves_equal(back["params"], case["ptree"][0])
    if case["ptree"][1] is not None:
        _leaves_equal(back["batch_stats"], case["ptree"][1])


def test_eval_forward_matches_jax(case):
    """The encoder's pyramid, the four ASPP projections, the mask logits, the
    four feature maps after TPAVI and the aligned audio, at FWD_TOL."""
    model = _port_model(case)
    imgs, audio, _ = (torch.from_numpy(a) for a in case["inputs"])
    out = model(imgs, audio)
    ref_out = case["out"]
    np.testing.assert_allclose(out["mask_logits"].numpy(), np.asarray(ref_out["mask_logits"]),
                               **FWD_TOL)
    assert out["mask_logits"].shape == (B * T, PX, PX)
    for ours, theirs in zip(out["feature_map_list"], ref_out["feature_map_list"]):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **FWD_TOL)
    for ours, theirs in zip(out["a_fea_list"], ref_out["a_fea_list"]):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **FWD_TOL)
    with torch.no_grad():
        pyramid = model.encoder_backbone(imgs.reshape(B * T, PX, PX, 3))
        assert [p.shape[1] for p in pyramid] == [PX // 4, PX // 8, PX // 16, PX // 32]
        for ours, theirs in zip(pyramid, _captured(case["inter"], "encoder_backbone")):
            np.testing.assert_allclose(ours.numpy(), theirs, **FWD_TOL)
        for i, p in enumerate(pyramid):
            np.testing.assert_allclose(model.convs[i](p).numpy(),
                                       _captured(case["inter"], f"conv{i + 1}"), **FWD_TOL)


def _grad_leaves(model, grads):
    """The gradients (in the parameters' order) as flat flax-layout leaves
    (copied: an exported leaf may share the parameter's storage)."""
    with torch.no_grad():
        params = [p for _, p in model.named_parameters()]
        saved = [p.detach().clone() for p in params]
        for p, g in zip(params, grads):
            p.copy_(g)
        out = flat(export_jax_variables(model)["params"])
        for p, s in zip(params, saved):
            p.copy_(s)
    return out


def test_train_step_gradients_match_jax(case):
    """The S4 loss of a train forward (BatchNorm on batch statistics), its
    gradient on every leaf, and the running statistics the forward leaves."""
    model = _port_model(case)
    imgs, audio, mask = (torch.from_numpy(a) for a in case["inputs"])
    loss, _ = make_avs_baseline_loss_fn(model)(
        model, {"images": imgs, "audio_feature": audio, "mask": mask}, None)
    np.testing.assert_allclose(float(loss.detach()), case["loss"], rtol=1e-5)
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    ours, theirs = _grad_leaves(model, grads), flat(case["grads"])
    assert sorted(ours) == sorted(theirs)
    top = max(np.abs(g).max() for g in theirs.values())
    dead = [k for k in ours if np.abs(theirs[k]).max() <= 1e-6 * top]
    assert all(k[-2:] == ("W_z_conv", "bias") for k in dead), dead
    for k in ours:
        scale = np.abs(theirs[k]).max()
        if k in dead:
            assert np.abs(ours[k]).max() <= 1e-6 * top, k
            continue
        assert np.abs(ours[k] - theirs[k]).max() <= 1e-3 * scale, k
        assert cos(ours[k], theirs[k]) >= 0.9999, k
    stats = flat(export_jax_variables(model)["batch_stats"])
    want = flat(case["stats"])
    assert sorted(stats) == sorted(want)
    for k in stats:
        np.testing.assert_allclose(stats[k], want[k], **FWD_TOL, err_msg=str(k))
