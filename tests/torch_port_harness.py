"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

The JAX modules' variable trees are taken from `jax.eval_shape` of their
init (no init compile) and every leaf is filled with seeded numpy noise of
a sensible scale for its role: the JAX init leaves adapter gates at zero,
which would make the adapters contribute nothing to a parity check.
"""

from __future__ import annotations

import numpy as np

FWD_TOL = dict(rtol=2e-3, atol=1e-4)   # the JAX suite's activation tolerance


def _leaf_noise(path, shape, rng: np.random.RandomState) -> np.ndarray:
    name = path[-1]
    n = lambda: rng.standard_normal(shape)
    if path[0] == "batch_stats":
        if "bn0" in path:  # per-mel-bin stats of log-mel dB values
            return -30.0 + 5.0 * n() if name == "mean" else 200.0 + 50.0 * np.abs(n())
        return 0.1 * n() if name == "mean" else 0.5 + 0.2 * np.abs(n())
    if name in ("gate", "gate_av", "gate_self"):
        return 0.5 + 0.2 * n()
    if name == "scale":
        return 1.0 + 0.1 * n()
    if name == "latent_tokens":
        return rng.uniform(0.0, 1.0, shape)
    if name == "logit_scale":
        return np.log(10.0) + 0.3 * n()
    if name == "relative_position_bias_table":
        return 0.1 * n()
    if name == "token_proj_kernel":
        return n() / np.sqrt(shape[-1])
    if name in ("kernel", "qkv_kernel", "fc_kernel"):
        mha = "self_attention" in path                  # the AVS expert's, (E, ...) stacked
        if (len(shape) == 3 or mha) and path[-2] == "out":   # MHA out (H, D, C)
            fan_in = shape[-3] * shape[-2]
        elif (len(shape) == 3 or mha) and path[-2] in ("query", "key", "value"):
            fan_in = shape[-3]                          # MHA (C, H, D)
        else:
            fan_in = shape[-2]                          # Dense / grouped / conv
            if len(shape) == 4 and "bottleneck" not in path:
                fan_in = shape[0] * shape[1] * shape[2]  # conv HWIO
        return n() / np.sqrt(fan_in)
    return 0.1 * n()                                    # biases


def randomize(shape_tree, seed: int):
    """Nested dict of numpy float32 noise matching a tree of shape structs."""
    rng = np.random.RandomState(seed)

    def walk(tree, path):
        if hasattr(tree, "shape") and not isinstance(tree, dict):
            return _leaf_noise(path, tuple(tree.shape), rng).astype(np.float32)
        return {k: walk(tree[k], path + (k,)) for k in sorted(tree)}

    return walk(dict(shape_tree), ())


def jax_variables(module, *args, seed: int = 0, **kwargs):
    """Seeded-noise variables for a flax module, shaped by eval_shape(init)."""
    import jax

    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    return randomize({k: dict(v) for k, v in shapes.items()}, seed)


def port_variables(model, seed: int = 0):
    """The same seeded noise as `jax_variables`, shaped by the port model's
    flax tree (`export_jax_variables`) instead of a JAX eval_shape trace:
    for models whose tree the convert round-trip tests hold equal to the
    JAX one."""
    from avmoe_tpu_torch.convert import export_jax_variables

    tree = export_jax_variables(model)
    return randomize({k: v for k, v in tree.items() if v}, seed)


def to_jax(tree):
    import jax.numpy as jnp

    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def attn_inputs(nW, B, H, N, D, seed):
    """q, k, v (nW*B, H, N, D) and a float32 (nW, H, N, N) bias; with nW > 1
    windows 1.. carry a shifted block's -100 mask folded into the bias."""
    rng = np.random.RandomState(seed)
    BW = nW * B
    q = rng.randn(BW, H, N, D).astype(np.float32) * 0.3
    k = rng.randn(BW, H, N, D).astype(np.float32) * 0.3
    v = rng.randn(BW, H, N, D).astype(np.float32)
    bias = rng.randn(nW, H, N, N).astype(np.float32) * 0.2
    bias[1:, :, : N // 2, N // 2:] -= 100.0
    return q, k, v, bias


def seeded_array(seed: int, *shape) -> np.ndarray:
    """Standard-normal float32 noise of `shape` from numpy seed `seed`."""
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def check_module(jmod, pmod, *args, seed: int = 0, **kwargs) -> None:
    """Seeded variables (`jax_variables`) loaded into both the flax module
    and the port's; the port's outputs (a tensor or a tuple) against the
    jitted JAX apply's on the same numpy inputs (None allowed) at FWD_TOL."""
    import jax
    import torch

    from avmoe_tpu_torch.convert import load_jax_variables

    variables = jax_variables(jmod, *args, seed=seed, **kwargs)
    load_jax_variables(pmod, variables)
    want = jax.jit(lambda v, *a: jmod.apply(v, *a, **kwargs))(variables, *args)
    with torch.no_grad():
        got = pmod(*(None if a is None else torch.from_numpy(np.asarray(a)) for a in args),
                   **kwargs)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.detach().numpy(), b, **FWD_TOL)


def max_err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))
