"""Contrastive loss library of the AVE reference's criterion (instantiated
beside the main criterion, never called on its main path).

Counterpart of `avmoe_tpu/losses/contrastive.py:31-150`: `contrastive_loss`
(margin pair loss), `info_nce_loss` (video-level InfoNCE, a clip's T
segments mutual positives across the two modalities), `yb_loss` (the
modality-swap ratio loss over pooled class probabilities), `yb_loss2` (the
augmented-sample selection BCE: 'vision' / 'audio', 'mix' / 'yybag') and
`mask_info_nce_loss` (InfoNCE with a given positive mask). This module's
`yb_loss` and `yb_loss2` are not `losses/yb.py`'s: each package keeps both,
as the JAX package does. In `yb_loss` a pair index that repeats writes its
row's positive bag more than once; which write stays is undefined in both
packages, so callers pass distinct indices.
"""

from __future__ import annotations

import torch


def _l2norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True), min=1e-12)


def contrastive_loss(x0: torch.Tensor, x1: torch.Tensor, y: torch.Tensor,
                     margin: float = 1.0) -> torch.Tensor:
    """y = 1: pull together (squared distance); y = 0: push beyond margin."""
    diff = x0 - x1
    dist_sq = (diff * diff).sum(dim=1)
    dist = torch.sqrt(torch.clamp(dist_sq, min=1e-12))
    mdist = torch.clamp(margin - dist, min=0.0)
    y = y.to(x0.dtype)
    loss = y * dist_sq + (1 - y) * mdist * mdist
    return loss.sum() / 2.0 / x0.shape[0]


def _nce(sim: torch.Tensor, pos_w: torch.Tensor, tau: float) -> torch.Tensor:
    e = torch.exp(sim / tau)
    pos = (e * pos_w).sum(dim=1)
    neg = (e * (1.0 - pos_w)).sum(dim=1)
    return torch.mean(-torch.log(pos / (pos + neg + 1e-8) + 1e-8))


def info_nce_loss(q: torch.Tensor, k: torch.Tensor, tau: float = 0.05,
                  segments: int = 10) -> torch.Tensor:
    """(B, T, C) audio / visual features; the positives of a segment are the
    T segments of its clip in the other modality."""
    B = q.shape[0]
    qf = _l2norm(q.reshape(B * segments, -1))
    kf = _l2norm(k.reshape(B * segments, -1))
    clip_id = torch.arange(B, device=q.device).repeat_interleave(segments)
    return _nce(qf @ kf.T, (clip_id[:, None] == clip_id[None, :]).to(q.dtype), tau)


def _pool_seg(x: torch.Tensor, how: str) -> torch.Tensor:
    return x.amax(dim=1) if how == "max" else x.mean(dim=1)


def yb_loss(all_prob: torch.Tensor, audio_idx: torch.Tensor, vis_idx: torch.Tensor,
            target: torch.Tensor, *, exp: bool = False, pos_pool: str = "max",
            neg_pool: str = "max") -> torch.Tensor:
    """all_prob (N, S, 2, C) per-segment class probabilities, dim 2 = (audio,
    visual); rows [R:], R = N - len(audio_idx), are the augmented negatives;
    target (R, C). Pairs count where their targets are class-disjoint."""
    K = audio_idx.shape[0]
    R, C = all_prob.shape[0] - K, all_prob.shape[-1]
    target = target.to(all_prob.dtype)
    gate = ((target[audio_idx] * target[vis_idx]).sum(-1) == 0).to(all_prob.dtype)[:, None]
    pos_a = _pool_seg(all_prob[audio_idx, :, 0, :], pos_pool)             # (K, C)
    pos_v = _pool_seg(all_prob[vis_idx, :, 1, :], pos_pool)
    neg = _pool_seg(all_prob[R:], neg_pool)                               # (K, 2, C)
    if exp:
        pos_a, pos_v, neg = torch.exp(pos_a), torch.exp(pos_v), torch.exp(neg)
    neg_a, neg_v = neg[:, 1, :], neg[:, 0, :]
    zeros = all_prob.new_zeros((R, C))
    a_pos = zeros.index_put((audio_idx,), gate * pos_a) * target
    v_pos = zeros.index_put((vis_idx,), gate * pos_v) * target
    a_neg = zeros.index_add(0, audio_idx, gate * neg_a) * target
    v_neg = zeros.index_add(0, vis_idx, gate * neg_v) * target

    def ratio_term(pos, negv):
        m = ((pos != 0) & (negv != 0)).to(pos.dtype)
        term = -torch.log(pos / (pos + negv + 1e-12) + 1e-12)
        return (term * m).sum() / torch.clamp(m.sum(), min=1.0)

    return ratio_term(v_pos, v_neg) + ratio_term(a_pos, a_neg)


def yb_loss2(prob_x1: torch.Tensor, prob_x2: torch.Tensor, rand_idx: torch.Tensor,
             sample_idx: torch.Tensor, target: torch.Tensor, *, aug_type: str = "vision",
             eps: float = 1e-7) -> torch.Tensor:
    """'vision' / 'audio': mean BCE(prob_x2[i], target[sample_idx[i]]).
    'mix' / 'yybag': prob_x1 / prob_x2 hold 4 augmentation variants stacked
    on dim 0 (variant j of pair i at row i + j K); per pair the variant whose
    largest target-masked probability is largest, BCE'd against the pair's
    target."""
    K = sample_idx.shape[0]
    target = target.to(prob_x2.dtype)

    def bce(p, t):
        p = torch.clamp(p, eps, 1.0 - eps)
        return -(t * torch.log(p) + (1 - t) * torch.log(1 - p)).mean(dim=-1)

    if aug_type in ("vision", "audio"):
        return bce(prob_x2[:K], target[sample_idx]).mean()
    if aug_type in ("mix", "yybag"):
        v_x2 = prob_x2[:4 * K].reshape(4, K, -1)
        v_x1 = prob_x1[:4 * K].reshape(4, K, -1)
        t_s, t_r = target[sample_idx], target[rand_idx]
        j_s = torch.argmax((v_x2 * t_s[None]).amax(dim=-1), dim=0)      # (K,)
        j_r = torch.argmax((v_x1 * t_r[None]).amax(dim=-1), dim=0)
        rows = torch.arange(K, device=prob_x2.device)
        return torch.cat([bce(v_x2[j_s, rows], t_s), bce(v_x1[j_r, rows], t_r)]).mean()
    raise ValueError(aug_type)


def mask_info_nce_loss(q: torch.Tensor, k: torch.Tensor, mask: torch.Tensor,
                       tau: float = 0.05) -> torch.Tensor:
    """InfoNCE with a given positive mask; rows beyond the mask are negatives."""
    qf = _l2norm(q.reshape(q.shape[0], -1), dim=1)
    kf = _l2norm(k.reshape(k.shape[0], -1), dim=1)
    sim = qf @ kf.T
    mask = mask.to(sim.dtype)
    pad = sim.shape[0] - mask.shape[0]
    if pad > 0:
        mask = torch.cat([mask, mask.new_zeros((pad, sim.shape[1]))], dim=0)
    return _nce(sim, mask, tau)
