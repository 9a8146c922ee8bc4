"""Shared helpers of the port's train-step parity tests: flax trees as flat
{path: float64 array} dicts, JAX's Adam moments, the port's Adam first
moment in the flax layout, the port's train state set to a JAX train state,
and the comparisons (live leaves, cosines, the elementwise bound).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from avmoe_tpu_torch.convert import export_jax_variables, load_jax_variables
from avmoe_tpu_torch.train.freeze import FROZEN_SCOPES

LIVE = 1e-6


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.array(v, np.float64)
    return out


def adam_moment(opt_state, moment: str):
    """JAX's Adam moment ('mu' or 'nu') as {flax path: array}."""
    import jax

    out = {}
    for path, v in jax.tree_util.tree_flatten_with_path(opt_state)[0]:
        names = [getattr(p, "name", None) for p in path]
        if moment in names:
            rest = path[names.index(moment) + 1:]
            out[tuple(p.key for p in rest)] = np.asarray(v, np.float64)
    return out


def tree(flat_dict):
    out = {}
    for path, v in flat_dict.items():
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.asarray(v, np.float32)
    return out


def port_mu(model, state, frozen_scopes: Tuple[str, ...] = FROZEN_SCOPES):
    """The port's Adam first moment of every trainable parameter, as a flat
    flax tree."""
    with torch.no_grad():
        saved = {n: p.detach().clone() for n, p in state.trainable.items()}
        for p in state.trainable.values():
            p.copy_(state.optimizer.state[p]["exp_avg"])
        out = flat(export_jax_variables(model, trainable_only=True,
                                        frozen_scopes=frozen_scopes)["params"])
        for n, p in state.trainable.items():
            p.copy_(saved[n])
    return out


def load_jax_state(model, state, jstate, updates: int):
    """The port's model and train state set to a JAX train state: all the
    parameters and batch stats, and, after `updates` > 0 steps, Adam's
    moments and step count (each moment read through the converter, as a
    parameter tree, so that it takes the port's layout)."""
    import jax

    from avmoe_tpu.train.freeze import merge_params

    frozen = jax.tree_util.tree_map(np.asarray, jstate.frozen)
    stats = jax.tree_util.tree_map(np.asarray, jstate.batch_stats)
    trainable = jax.tree_util.tree_map(np.asarray, jstate.trainable)
    load_jax_variables(model, {"params": merge_params(trainable, frozen), "batch_stats": stats})
    state.optimizer.state.clear()
    if updates:
        moments = {}
        for moment in ("mu", "nu"):
            load_jax_variables(model, {"params": merge_params(
                tree(adam_moment(jstate.opt_state, moment)), frozen), "batch_stats": stats})
            moments[moment] = {n: p.detach().clone() for n, p in state.trainable.items()}
        load_jax_variables(model, {"params": merge_params(trainable, frozen),
                                   "batch_stats": stats})
        for n, p in state.trainable.items():
            state.optimizer.state[p] = {"step": torch.tensor(float(updates)),
                                        "exp_avg": moments["mu"][n],
                                        "exp_avg_sq": moments["nu"][n]}
    state.updates = state.step = updates


def live(ref):
    """The leaves whose rms is above LIVE of the largest leaf's, and that rms."""
    rms = {k: np.sqrt(np.mean(v ** 2)) for k, v in ref.items()}
    top = max(rms.values())
    return {k for k, r in rms.items() if r > LIVE * top}, top


def cos(a, b):
    return a.ravel() @ b.ravel() / np.linalg.norm(a) / np.linalg.norm(b)


def outside(ours, ref):
    return np.abs(ours - ref) > 1e-6 + 2e-3 * np.abs(ref)
