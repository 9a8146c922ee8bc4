"""The port's helpers against the JAX package's: t-SNE, the LogMelFrontend
bundle, the torch.profiler trace scope and the two figures.

  * `tsne` on 60 seeded points in 3 clusters: `_cond_probs` equal to JAX's
    exactly (the same numpy code). The KL gradient is float32 in both, so
    the descents part by float32 rounding only, but at the default learning
    rate (200) the descent on 60 points is chaotic: a 3e-8 difference after
    one iteration grows to 1% of the embedding's extent by iteration 10, and
    the two runs end in different local minima. So the default descent is
    held for its first 3 iterations (within 1e-5 of the extent; measured
    1.1e-6), and 300 iterations (the exaggeration phase and the momentum
    switch included) at learning rate 5, where the descent is stable,
    within 1e-3 of the extent (measured 1.8e-4).
  * `LogMelFrontend` (its log-mel and its fold) against JAX's, rtol 2e-3 /
    atol 1e-4, the suite's activation bound.
  * `profiler_trace` writes a Chrome trace of a CPU op.
  * `plot_prediction_timeline` and `plot_tsne` write their PNGs (matplotlib
    is on this host; the card's machine has none and never calls them).
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

torch.set_num_threads(2)


def _clusters(n: int = 60, d: int = 16, seed: int = 0):
    rng = np.random.RandomState(seed)
    labels = np.repeat(np.arange(3), n // 3)
    centers = 4.0 * rng.randn(3, d)
    return (centers[labels] + rng.randn(n, d)).astype(np.float32), labels


def test_tsne_matches_jax():
    from avmoe_tpu.utils import tsne as jtsne

    from avmoe_tpu_torch.utils import tsne as ptsne

    x, _ = _clusters()
    xd = x.astype(np.float64) - x.astype(np.float64).mean(0)
    sq = (xd * xd).sum(1)
    dists = np.maximum(sq[:, None] + sq[None, :] - 2 * xd @ xd.T, 0.0)
    np.testing.assert_array_equal(ptsne._cond_probs(dists, 15.0), jtsne._cond_probs(dists, 15.0))
    for n_iter, lr, bound in ((3, 200.0, 1e-5), (300, 5.0, 1e-3)):
        ours = ptsne.tsne(x, perplexity=15.0, n_iter=n_iter, learning_rate=lr, device="cpu")
        ref = jtsne.tsne(x, perplexity=15.0, n_iter=n_iter, learning_rate=lr)
        assert ours.shape == ref.shape == (60, 2) and ours.dtype == np.float32
        np.testing.assert_allclose(ours, ref, rtol=0, atol=bound * np.abs(ref).max())


def test_log_mel_frontend_matches_jax():
    from avmoe_tpu.audio.frontend import LogMelFrontend as JFront
    from avmoe_tpu.config import _tiny_frontend as jtiny

    from avmoe_tpu_torch.audio.frontend import LogMelFrontend
    from avmoe_tpu_torch.config import _tiny_frontend

    wave = (0.1 * np.random.RandomState(1).randn(3, 4000)).astype(np.float32)
    ours, ref = LogMelFrontend(_tiny_frontend(), 64), JFront(jtiny(), 64)
    assert ours.freq_ratio == ref.freq_ratio
    spec, jspec = ours(torch.from_numpy(wave)), ref(jnp.asarray(wave))
    np.testing.assert_allclose(spec.numpy(), np.asarray(jspec), rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(ours.fold(spec).numpy(), np.asarray(ref.fold(jspec)),
                               rtol=2e-3, atol=1e-4)


def test_profiler_trace_writes_a_trace(tmp_path):
    from avmoe_tpu_torch.utils.runtime import profiler_trace

    with profiler_trace(str(tmp_path)):
        torch.randn(64, 64) @ torch.randn(64, 64)
    traces = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(traces) == 1
    events = json.loads((tmp_path / traces[0]).read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_figures_are_written(tmp_path):
    pytest.importorskip("matplotlib")
    from avmoe_tpu_torch.utils.visualize import plot_prediction_timeline, plot_tsne

    timeline = tmp_path / "timeline" / "clip.png"
    plot_prediction_timeline(np.array([0, 1, 1, 28]), np.array([0, 1, 2, 28]), 28,
                             str(timeline), title="clip")
    x, labels = _clusters(n=30)
    emb = plot_tsne(x, labels, str(tmp_path / "tsne.png"), device="cpu")
    assert emb.shape == (30, 2) and np.isfinite(emb).all()
    for png in (timeline, tmp_path / "tsne.png"):
        assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
