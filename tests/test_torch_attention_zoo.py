"""The port's attention zoo (avmoe_tpu_torch/ops/attention_zoo.py:
scaled dot-product, additive, location-aware and multi-head attention)
against the JAX package's, on the CPU: seeded variables shaped by the JAX
module's `eval_shape` loaded into the port, the same numpy-seeded float32
inputs, outputs and attention weights at FWD_TOL (rtol 2e-3, atol 1e-4).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from torch_port_harness import check_module, seeded_array

from avmoe_tpu.ops import attention_zoo as jaz
from avmoe_tpu_torch.ops import attention_zoo as paz

torch.set_num_threads(2)


@pytest.mark.parametrize("masked", [False, True])
def test_scaled_dot_product_attention_matches_jax(masked):
    q, k, v = seeded_array(6, 2, 3, 8), seeded_array(7, 2, 5, 8), seeded_array(8, 2, 5, 4)
    mask = (np.random.RandomState(9).rand(2, 3, 5) > 0.3) if masked else None
    check_module(jaz.ScaledDotProductAttention(), paz.ScaledDotProductAttention(), q, k, v, mask)


def test_additive_attention_matches_jax():
    q, k, v = seeded_array(10, 2, 3, 8), seeded_array(11, 2, 5, 6), seeded_array(12, 2, 5, 7)
    check_module(jaz.AdditiveAttention(hidden_dim=4), paz.AdditiveAttention(8, 6, 4), q, k, v, seed=7)


@pytest.mark.parametrize("smoothing", [False, True])
@pytest.mark.parametrize("with_last", [False, True])
def test_location_aware_attention_matches_jax(smoothing, with_last):
    q, v = seeded_array(13, 2, 8), seeded_array(14, 2, 5, 6)
    last = np.random.RandomState(15).dirichlet(np.ones(5), 2).astype(np.float32) \
        if with_last else None
    check_module(jaz.LocationAwareAttention(hidden_dim=4, conv_out_channel=3, smoothing=smoothing),
           paz.LocationAwareAttention(8, 6, 4, conv_out_channel=3, smoothing=smoothing),
           q, v, last, seed=8)


def test_multi_head_attention_matches_jax():
    q, k, v = seeded_array(16, 2, 3, 10), seeded_array(17, 2, 5, 6), seeded_array(18, 2, 5, 7)
    check_module(jaz.MultiHeadAttention(dim=8, num_heads=2), paz.MultiHeadAttention(10, 6, 7, 8, 2),
           q, k, v, seed=9)
