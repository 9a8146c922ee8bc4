"""The port's VGGish (avmoe_tpu_torch/backbones/vggish.py) against the JAX
package's, on the CPU; its front end is tests/test_torch_vggish_frontend.py.

  * the HTK mel scale (audio/frontend.py) at rtol 1e-12;
  * `VGGish` from one seeded torchvggish-layout state dict
    (tests/torch_reference_layout.py `vggish_state_dict`) through both
    packages' `convert_vggish` (leaf for leaf, and the round trip through
    the port's model), then on the examples of two waves: embeddings at
    FWD_TOL, one JAX compile;
  * the PCA postprocessor and `convert_vggish_pca` (float32 products) at
    FWD_TOL.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import torch_reference_layout as ref
from torch_port_harness import FWD_TOL
from torch_train_harness import flat

from avmoe_tpu.audio import frontend as jfe
from avmoe_tpu.backbones import vggish as jvg
from avmoe_tpu.checkpoint import convert as jcv
from avmoe_tpu_torch.audio import frontend as pfe
from avmoe_tpu_torch.backbones import vggish as pvg
from avmoe_tpu_torch.checkpoint import convert as pcv
from avmoe_tpu_torch.convert import export_jax_variables, load_jax_variables

torch.set_num_threads(2)



def _waves(seed: int, length: int, n: int = 2) -> np.ndarray:
    rng = np.random.RandomState(seed)
    t = np.arange(length) / 16_000.0
    tone = np.sin(2 * np.pi * rng.uniform(200, 3000, (n, 1)) * t)
    return (0.3 * tone + 0.05 * rng.randn(n, length)).astype(np.float32)


@pytest.mark.parametrize("fn", ["_hz_to_mel_htk", "_mel_to_hz_htk"])
def test_htk_mel_scale_matches_jax(fn):
    x = np.linspace(0.0, 8000.0, 257)
    np.testing.assert_allclose(getattr(pfe, fn)(x), getattr(jfe, fn)(x), rtol=1e-12)


@pytest.fixture(scope="module")
def vggish():
    """The seeded variables, the reference dict, both converters' trees, the
    examples of two 5-s waves and JAX's embeddings of them."""
    x = jvg.waveform_to_examples(_waves(5, 80_000)[0])[:, :, :, None]
    model = jvg.VGGish()
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x)
    variables = ref.seeded_variables({k: dict(v) for k, v in shapes.items()}, seed=21)
    sd = ref.vggish_state_dict(variables["params"])
    jtree, ptree = jcv.convert_vggish(sd), pcv.convert_vggish(sd)
    emb = np.array(jax.jit(model.apply)({"params": jtree}, x))
    return dict(variables=variables, sd=sd, jtree=jtree, ptree=ptree, x=x, emb=emb)


def test_convert_vggish_equals_jax(vggish):
    ours, theirs = flat(vggish["ptree"]), flat(jax.tree_util.tree_map(np.asarray,
                                                                       vggish["jtree"]))
    assert sorted(ours) == sorted(theirs) and len(ours) == 18
    for k in ours:
        assert np.array_equal(ours[k], theirs[k]), k
    model = pvg.VGGish()
    load_jax_variables(model, {"params": vggish["ptree"]})
    back = flat(export_jax_variables(model)["params"])
    want = flat(vggish["variables"]["params"])
    assert sorted(back) == sorted(want)
    for k in back:
        assert np.array_equal(back[k], want[k]), k


def test_vggish_embeddings_match_jax(vggish):
    model = pvg.VGGish()
    load_jax_variables(model, {"params": vggish["ptree"]})
    with torch.no_grad():
        out = model(torch.from_numpy(vggish["x"]))
    assert tuple(out.shape) == (5, pvg.EMBEDDING_SIZE) and bool((out >= 0).all())
    np.testing.assert_allclose(out.numpy(), vggish["emb"], **FWD_TOL)


def test_postprocessor_and_its_converter_match_jax(vggish):
    pca = ref.vggish_pca_params(3)
    emb = np.random.RandomState(4).randn(7, 128).astype(np.float32)
    want = jcv.convert_vggish_pca(pca)(emb)
    ours = pcv.convert_vggish_pca(pca)
    np.testing.assert_allclose(ours(torch.from_numpy(emb)).numpy(), want, **FWD_TOL)
    direct = pvg.VGGishPostprocessor(pca["pca_eigen_vectors"], pca["pca_means"])
    np.testing.assert_array_equal(direct(torch.from_numpy(emb)).numpy(),
                                  ours(torch.from_numpy(emb)).numpy())
    got = ours(torch.from_numpy(vggish["emb"]))
    assert float(got.min()) >= 0.0 and float(got.max()) <= 255.0
