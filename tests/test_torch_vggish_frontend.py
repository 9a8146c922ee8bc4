"""The port's VGGish front end against the JAX package's, on the CPU: the
HTK filterbank (avmoe_tpu_torch/audio/frontend.py `mel_filterbank_htk`)
and `backbones/vggish.py` `waveform_to_examples`, batched on tensors,
against the JAX package's host numpy on each wave, to 1e-6 in float64
(waves of 5 s, 2.5 s, 1 s and shorter than one example). No JAX compile.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from avmoe_tpu.audio import frontend as jfe
from avmoe_tpu.backbones import vggish as jvg
from avmoe_tpu_torch.audio import frontend as pfe
from avmoe_tpu_torch.backbones import vggish as pvg

F64 = dict(rtol=1e-6, atol=1e-6)
EXAMPLES = {80_000: 5, 40_000: 2, 16_000: 1, 15_000: 0, 300: 0}   # wave length -> examples


def _waves(seed: int, length: int, n: int = 2) -> np.ndarray:
    rng = np.random.RandomState(seed)
    t = np.arange(length) / 16_000.0
    tone = np.sin(2 * np.pi * rng.uniform(200, 3000, (n, 1)) * t)
    return (0.3 * tone + 0.05 * rng.randn(n, length)).astype(np.float32)


@pytest.mark.parametrize("args", [(16_000, 512, 64, 125.0, 7_500.0),
                                  (16_000, 400, 40, 0.0, 8_000.0),
                                  (32_000, 1024, 96, 50.0, 14_000.0)])
def test_mel_filterbank_htk_matches_jax(args):
    ours, theirs = pfe.mel_filterbank_htk(*args), jfe.mel_filterbank_htk(*args)
    assert ours.dtype == theirs.dtype == np.float32 and ours.shape == theirs.shape
    np.testing.assert_allclose(ours.astype(np.float64), theirs.astype(np.float64), **F64)
    assert not ours[0].any()                      # the DC row is zero


@pytest.mark.parametrize("length", sorted(EXAMPLES))
def test_waveform_to_examples_matches_jax(length):
    """(B, L) on tensors against the JAX function's (L,) numpy, clip by clip;
    a single (L,) wave gives the unbatched shape."""
    waves = _waves(length % 97, length)
    ours = pvg.waveform_to_examples(torch.from_numpy(waves))
    want = np.stack([jvg.waveform_to_examples(w) for w in waves])
    assert ours.dtype == torch.float32 and tuple(ours.shape) == want.shape
    assert want.shape[1] == EXAMPLES[length]
    np.testing.assert_allclose(ours.numpy().astype(np.float64), want.astype(np.float64), **F64)
    single = pvg.waveform_to_examples(torch.from_numpy(waves[0]))
    assert torch.equal(single, ours[0])
