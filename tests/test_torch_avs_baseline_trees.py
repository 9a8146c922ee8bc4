"""The full-width encoder trees of the port's AVSBench baseline against the
JAX package's, on the CPU, by `jax.eval_shape` alone (no compile): the
port's `pvt_v2_b0` / `b2` / `b5` (avmoe_tpu_torch/backbones/pvt.py) and
`B2ResNet` (backbones/resnet.py, ResNet-50 with both branches) give the
JAX constructors' parameter and statistics shapes and hyper-parameters.
The tiny baseline's numerics are tests/test_torch_avs_baseline.py's.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from avmoe_tpu.backbones import pvt as jpvt
from avmoe_tpu.backbones import resnet as jres
from avmoe_tpu_torch.backbones.pvt import pvt_v2_b0, pvt_v2_b2, pvt_v2_b5
from avmoe_tpu_torch.backbones.resnet import B2ResNet
from avmoe_tpu_torch.convert import export_jax_variables


def _shape_tree(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_shape_tree(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = tuple(v.shape)
    return out


@pytest.mark.parametrize("name", ["b0", "b2", "b5"])
def test_pvt_constructors_match_jax(name):
    """pvt_v2_b0 / b2 / b5 build the JAX constructors' trees (parameter
    shapes, by eval_shape at 32 px) and hyper-parameters."""
    port = {"b0": pvt_v2_b0, "b2": pvt_v2_b2, "b5": pvt_v2_b5}[name]()
    jm = getattr(jpvt, f"pvt_v2_{name}")()
    assert port.widths == tuple(jm.dims) and port.depths == tuple(jm.depths)
    x = np.zeros((1, 32, 32, 3), np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    assert _shape_tree(export_jax_variables(port)["params"]) == _shape_tree(shapes["params"])
    dpr = [blk.drop_path for _, blocks, _ in port.stages for blk in blocks]
    assert dpr[0] == 0.0 and dpr[-1] == pytest.approx(jm.drop_path_rate)


def test_resnet50_tree_matches_jax():
    """B2ResNet() with both branches holds JAX's full ResNet-50 tree, branch
    1 and branch 2 together (parameter and statistics shapes)."""
    port = export_jax_variables(B2ResNet(branches=(1, 2)))
    jm = jres.B2ResNet()
    x = np.zeros((1, 32, 32, 3), np.float32)
    want = {}
    for branch in (1, 2):
        s = jax.eval_shape(functools.partial(jm.init, branch=branch), jax.random.PRNGKey(0), x)
        for col in ("params", "batch_stats"):
            want.update({(col,) + k: v for k, v in _shape_tree(s[col]).items()})
    got = {(col,) + k: v for col in ("params", "batch_stats")
           for k, v in _shape_tree(port[col]).items()}
    assert got == want


def test_baseline_rejects_an_unknown_backbone():
    from avmoe_tpu_torch.models.avs_baseline import AVSBaselineModel

    with pytest.raises(ValueError, match="backbone"):
        AVSBaselineModel("vit", device="cpu", seed=None)
