"""Prediction and feature figures.

Counterpart of `avmoe_tpu/utils/visualize.py` (the reference's
AVMOE/AVE/utils/vis_pred.py:20 per-clip prediction-vs-ground-truth
timelines and the t-SNE feature plots of AVS test_v2.py:225-232).
matplotlib is imported inside the functions, as in the JAX module: a
machine without it imports this module and never calls them.
"""

from __future__ import annotations

import os

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_prediction_timeline(pred: np.ndarray, target: np.ndarray, num_classes: int,
                             save_path: str, title: str = "") -> None:
    """Two-row timeline (ground truth over prediction), one cell a segment;
    pred and target are (T,) class indices."""
    plt = _pyplot()
    T = len(pred)
    fig, ax = plt.subplots(figsize=(max(6, T * 0.6), 1.6))
    cmap = plt.get_cmap("tab20", num_classes + 1)
    for t in range(T):
        ax.add_patch(plt.Rectangle((t, 1.05), 1, 0.9, color=cmap(int(target[t]))))
        ax.add_patch(plt.Rectangle((t, 0.0), 1, 0.9, color=cmap(int(pred[t]))))
    ax.set_xlim(0, T)
    ax.set_ylim(0, 2)
    ax.set_yticks([0.45, 1.5])
    ax.set_yticklabels(["pred", "gt"])
    ax.set_xlabel("segment")
    if title:
        ax.set_title(title)
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, bbox_inches="tight", dpi=120)
    plt.close(fig)


def plot_tsne(features: np.ndarray, labels: np.ndarray, save_path: str,
              perplexity: float = 30.0, title: str = "t-SNE", device="cuda") -> np.ndarray:
    """Embed (N, D) features with `utils/tsne.py` on `device` and scatter them
    coloured by their (N,) int labels; returns the 2-D embedding."""
    from avmoe_tpu_torch.utils.tsne import tsne

    emb = tsne(features, perplexity=min(perplexity, max(len(features) // 4, 2)), device=device)
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 6))
    sc = ax.scatter(emb[:, 0], emb[:, 1], c=labels, cmap="tab20", s=8)
    ax.set_title(title)
    fig.colorbar(sc, ax=ax, shrink=0.8)
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, bbox_inches="tight", dpi=120)
    plt.close(fig)
    return emb
