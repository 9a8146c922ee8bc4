"""The port's fused bottleneck-rank MoE combine in eval, against the JAX
package's fused combine and against the port's own materialized mixture.

The JAX side runs its fused route under AVMOE_FUSED_MOE=1 (set with
monkeypatch for the one call); the port takes `MoEAdapter(...,
fused_moe=True)`. Both are fed the same seeded variables (gates, latent
tokens and running statistics all non-trivial) and inputs. The cases are
those of `tests/test_fused_moe.py`: (use_bn, post_layernorm) at float32, and
the unimodal self-attention kinds (none, token, bmm, mha) each with
before_layernorm on and off. Bounds: JAX's own, rtol 2e-4 / atol 2e-4 for
the combine and 3e-4 for the trunks, in float32.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from torch_port_harness import jax_variables, to_jax  # noqa: E402

from avmoe_tpu_torch.convert import load_jax_variables  # noqa: E402

torch.set_num_threads(2)

B, N, C, M, CO = 2, 24, 32, 16, 48
COMBINE_TOL = dict(rtol=2e-4, atol=2e-4)
TRUNK_TOL = dict(rtol=3e-4, atol=3e-4)


def _cfgs(**adapter):
    from avmoe_tpu.config import AdapterConfig as JA, MoEConfig as JM

    from avmoe_tpu_torch.config import AdapterConfig, MoEConfig

    akw = dict(downsample=4, num_conv_group=2, num_tokens=4, **adapter)
    mkw = dict(num_multimodal_experts=2, num_singlemodal_experts=2)
    return JM(adapter=JA(**akw), **mkw), MoEConfig(adapter=AdapterConfig(**akw), **mkw)


def _run(monkeypatch, seed: int, tol, **adapter):
    """JAX fused vs port fused, and port fused vs port materialized."""
    from avmoe_tpu.moe.adapter import MoEAdapter as JMoE

    from avmoe_tpu_torch.moe.adapter import MoEAdapter

    jcfg, cfg = _cfgs(**adapter)
    rng = np.random.RandomState(seed)
    x = rng.randn(B, N, C).astype(np.float32)
    other = rng.randn(B, M, CO).astype(np.float32)
    jm = JMoE(dim=C, other_dim=CO, num_tokens=N, other_num_tokens=M, cfg=jcfg)
    variables = jax_variables(jm, jnp.asarray(x), jnp.asarray(other), False, seed=seed)
    monkeypatch.setenv("AVMOE_FUSED_MOE", "1")
    ref, jaux = jm.apply(to_jax(variables), jnp.asarray(x), jnp.asarray(other), False)
    monkeypatch.delenv("AVMOE_FUSED_MOE")

    fused = MoEAdapter(C, CO, N, M, cfg, fused_moe=True)
    plain = MoEAdapter(C, CO, N, M, cfg)
    load_jax_variables(fused, variables)
    load_jax_variables(plain, variables)
    xt, ot = torch.from_numpy(x), torch.from_numpy(other)
    with torch.no_grad():
        out, aux = fused(xt, ot)
        mat, _ = plain(xt, ot)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **tol)
    np.testing.assert_allclose(aux["gating_probs"].numpy(), np.asarray(jaux["gating_probs"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), mat.numpy(), **tol)
    # the fused route really left the materialized one: not bit-equal
    assert not torch.equal(out, mat)


@pytest.mark.parametrize("use_bn,post_ln", [(True, True), (True, False),
                                            (False, True), (False, False)])
def test_fused_combine_matches_jax(monkeypatch, use_bn, post_ln):
    _run(monkeypatch, 0, COMBINE_TOL, use_bn=use_bn, post_layernorm=post_ln)


@pytest.mark.parametrize("sa", ["none", "token", "bmm", "mha"])
def test_fused_trunk_matches_jax(monkeypatch, sa):
    for before_ln in (True, False):
        _run(monkeypatch, 1, TRUNK_TOL, use_bn=True, post_layernorm=True,
             before_layernorm=before_ln, self_attention=sa)
