"""The port's legacy surface modules against the JAX package's, on the CPU:
avmoe_tpu_torch/backbones/legacy.py (`BasicBlock` inside `ResNet18`,
`NetVLAD`, `AVENet`, `SimpleViT`, `PHMLinear`) and heads/audio_guided.py
(`AudioGuidedAttention`); the attention zoo is
tests/test_torch_attention_zoo.py's.

Each module gets seeded variables shaped by the JAX module's `eval_shape`,
loaded through `convert.py` `load_jax_variables`, and runs on the same
numpy-seeded inputs in float32 as the jitted JAX apply: outputs at FWD_TOL
(rtol 2e-3, atol 1e-4; tests/torch_port_harness.py `check_module`). ResNet-18 also runs in train mode (BatchNorm on batch statistics,
the running statistics updated as flax updates them), and its weights come
from one seeded torchvision-layout state dict
(tests/torch_reference_layout.py `resnet18_state_dict`) through both
packages' `convert_resnet18`, leaf for leaf, with the round trip.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

import torch_reference_layout as ref
from torch_port_harness import FWD_TOL, check_module, seeded_array
from torch_train_harness import flat

from avmoe_tpu.backbones import legacy as jlg
from avmoe_tpu.checkpoint import convert as jcv
from avmoe_tpu.heads import audio_guided as jag
from avmoe_tpu_torch.backbones import legacy as plg
from avmoe_tpu_torch.checkpoint import convert as pcv
from avmoe_tpu_torch.convert import export_jax_variables, load_jax_variables
from avmoe_tpu_torch.heads import audio_guided as pag

torch.set_num_threads(2)


# ------------------------------------------------------------------ ResNet-18


@pytest.fixture(scope="module")
def resnet18():
    """Seeded ResNet-18 variables (5 classes), the torchvision-layout dict,
    both converters' trees, and JAX's eval logits and train-mode map with
    its updated batch statistics (one compile each)."""
    x = seeded_array(1, 4, 64, 64, 3)
    model = jlg.ResNet18(num_classes=5)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x)
    variables = ref.seeded_variables({k: dict(v) for k, v in shapes.items()}, seed=5)
    sd = ref.resnet18_state_dict(variables["params"], variables["batch_stats"])
    jtree, ptree = jcv.convert_resnet18(sd), pcv.convert_resnet18(sd)
    jvars = {"params": jtree[0], "batch_stats": jtree[1]}
    logits = np.asarray(jax.jit(model.apply)(jvars, x))
    fmap_model = jlg.ResNet18(layer4_stride=2, return_map=True)
    trunk = {c: {k: v for k, v in jvars[c].items() if k != "fc"} for c in jvars}
    fmap, upd = jax.jit(lambda v, x: fmap_model.apply(v, x, train=True,
                                                      mutable=["batch_stats"]))(trunk, x)
    return dict(x=x, variables=variables, sd=sd, jtree=jtree, ptree=ptree, logits=logits,
                fmap=np.asarray(fmap), stats=jax.tree_util.tree_map(np.asarray, upd))


def test_convert_resnet18_equals_jax(resnet18):
    for ours, theirs, seeded in zip(resnet18["ptree"], resnet18["jtree"],
                                    (resnet18["variables"]["params"],
                                     resnet18["variables"]["batch_stats"])):
        a, b, c = flat(ours), flat(jax.tree_util.tree_map(np.asarray, theirs)), flat(seeded)
        assert sorted(a) == sorted(b) == sorted(c) and a
        for k in a:
            assert np.array_equal(a[k], b[k]) and np.array_equal(a[k], c[k]), k


def _port_resnet18(resnet18, **kw):
    model = plg.ResNet18(**kw)
    params, stats = resnet18["ptree"]
    if model.fc is None:
        params = {k: v for k, v in params.items() if k != "fc"}
    load_jax_variables(model, {"params": params, "batch_stats": stats})
    return model


def test_resnet18_eval_logits_and_round_trip(resnet18):
    model = _port_resnet18(resnet18, num_classes=5)
    back = export_jax_variables(model)
    for ours, seeded in zip((back["params"], back["batch_stats"]), resnet18["ptree"]):
        a, b = flat(ours), flat(seeded)
        assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
    with torch.no_grad():
        out = model(torch.from_numpy(resnet18["x"]))
    assert tuple(out.shape) == (4, 5)
    np.testing.assert_allclose(out.numpy(), resnet18["logits"], **FWD_TOL)


def test_resnet18_train_map_and_running_stats(resnet18):
    """layer4 at stride 2, the map returned, BatchNorm in train mode (16
    values a channel at layer4): the map and every updated running
    statistic."""
    model = _port_resnet18(resnet18, layer4_stride=2, return_map=True)
    with torch.no_grad():
        out = model(torch.from_numpy(resnet18["x"]), train=True)
    assert tuple(out.shape) == (4, 2, 2, 512)
    np.testing.assert_allclose(out.numpy(), resnet18["fmap"], **FWD_TOL)
    got, want = flat(export_jax_variables(model)["batch_stats"]), flat(resnet18["stats"]
                                                                          ["batch_stats"])
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], **FWD_TOL, err_msg=str(k))


# ------------------------------------------------------------ other backbones


def test_netvlad_matches_jax():
    x = seeded_array(2, 2, 4, 4, 8)
    check_module(jlg.NetVLAD(num_clusters=4, dim=8), plg.NetVLAD(num_clusters=4, dim=8), x, seed=3)


def test_avenet_matches_jax():
    spec = seeded_array(3, 2, 32, 16, 1)
    check_module(jlg.AVENet(embed_dim=24), plg.AVENet(embed_dim=24), spec, seed=4)


def test_simple_vit_matches_jax():
    x = seeded_array(4, 2, 32, 32, 3)
    check_module(jlg.SimpleViT(embed_dim=16, depth=2, num_heads=2, patch=8),
           plg.SimpleViT(embed_dim=16, depth=2, num_heads=2, patch=8, num_patches=16), x, seed=5)


def test_phm_linear_matches_jax():
    x = seeded_array(5, 3, 8)
    check_module(jlg.PHMLinear(n=2, in_features=8, out_features=6), plg.PHMLinear(2, 8, 6), x, seed=6)
    with pytest.raises(ValueError):
        plg.PHMLinear(3, 8, 6)


# ------------------------------------------------------ audio-guided attention


def test_audio_guided_attention_matches_jax():
    video, audio = seeded_array(19, 2, 2, 3, 3, 16), seeded_array(20, 2, 2, 8)
    check_module(jag.AudioGuidedAttention(video_dim=16, audio_dim=8, hidden_dim=12),
           pag.AudioGuidedAttention(video_dim=16, audio_dim=8, hidden_dim=12), video, audio,
           seed=10)
