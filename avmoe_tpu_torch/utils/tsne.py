"""t-SNE of features, for the expert and feature figures.

Counterpart of `avmoe_tpu/utils/tsne.py` (the reference's TorchTSNE,
AVMOE/AVE/utils/mytsne.py:129): exact pairwise affinities with a binary
search of each row's bandwidth for the target perplexity (`_cond_probs`,
host numpy, the JAX module's own code), then gradient descent on the KL
divergence with momentum (0.5, then 0.8 from iteration 250) and early
exaggeration (12 for the first 100 iterations). The KL gradient runs in
float32 on `device`, as the JAX module's jitted `kl_grad` runs it; the
velocity and the embedding stay on the device in float64, as the JAX
module keeps them in host float64, so the loop never waits on the host.
"""

from __future__ import annotations

import numpy as np
import torch


def _cond_probs(dists: np.ndarray, perplexity: float, tol: float = 1e-5,
                max_iter: int = 50) -> np.ndarray:
    """Row-wise binary search for sigmas hitting the target perplexity."""
    n = dists.shape[0]
    target = np.log(perplexity)
    P = np.zeros((n, n))
    for i in range(n):
        lo, hi = -np.inf, np.inf
        beta = 1.0
        di = np.delete(dists[i], i)
        for _ in range(max_iter):
            p = np.exp(-di * beta)
            s = p.sum() + 1e-12
            h = np.log(s) + beta * (di * p).sum() / s
            if abs(h - target) < tol:
                break
            if h > target:
                lo = beta
                beta = beta * 2 if hi == np.inf else (beta + hi) / 2
            else:
                hi = beta
                beta = beta / 2 if lo == -np.inf else (beta + lo) / 2
        row = np.exp(-dists[i] * beta)
        row[i] = 0.0
        P[i] = row / (row.sum() + 1e-12)
    return P


def _kl_grad(y: torch.Tensor, P: torch.Tensor, exaggeration: float) -> torch.Tensor:
    """The KL divergence's gradient at the embedding y (N, k), float32."""
    n = y.shape[0]
    d = (y * y).sum(dim=1)
    num = 1.0 / (1.0 + d[:, None] + d[None, :] - 2.0 * y @ y.T)
    num = num * (1.0 - torch.eye(n, dtype=y.dtype, device=y.device))
    Q = torch.clamp(num / num.sum(), min=1e-12)
    PQ = (P * exaggeration - Q) * num
    return 4.0 * ((torch.diag(PQ.sum(dim=1)) - PQ) @ y)


def joint_probs(features: np.ndarray, perplexity: float = 30.0) -> np.ndarray:
    """The symmetrized (N, N) affinities P of (N, D) features, float64."""
    x = np.asarray(features, np.float64)
    x = x - x.mean(0)
    sq = (x * x).sum(1)
    dists = np.maximum(sq[:, None] + sq[None, :] - 2 * x @ x.T, 0.0)
    P = _cond_probs(dists, perplexity)
    P = (P + P.T) / (2 * P.shape[0])
    return np.maximum(P, 1e-12)


def tsne(features: np.ndarray, n_components: int = 2, perplexity: float = 30.0,
         n_iter: int = 500, learning_rate: float = 200.0, seed: int = 0,
         device="cuda") -> np.ndarray:
    """(N, D) features -> (N, n_components) float32 embedding, the descent on
    `device` (the card by default; raises if it is absent)."""
    from avmoe_tpu_torch import resolve_device

    dev = resolve_device(device)
    P = joint_probs(features, perplexity)
    rng = np.random.RandomState(seed)
    n = P.shape[0]
    Y = torch.from_numpy(rng.randn(n, n_components) * 1e-4).to(dev)
    P32 = torch.from_numpy(P).to(dev, torch.float32)
    vel = torch.zeros_like(Y)
    for it in range(n_iter):
        exag = 12.0 if it < 100 else 1.0
        momentum = 0.5 if it < 250 else 0.8
        g = _kl_grad(Y.float(), P32, exag)
        vel = momentum * vel - learning_rate * g.double()
        Y = Y + vel
        Y = Y - Y.mean(dim=0)
    return Y.float().cpu().numpy()
