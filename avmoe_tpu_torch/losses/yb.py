"""YB contrastive-bag losses of the AVE reference's criterion (instantiated
by its train loop, never called on its main path).

Counterpart of `avmoe_tpu/losses/yb.py:44` `yb_loss` and `:93` `yb_loss2`
(every `aug_type`: 'vision', 'audio', 'ada', 'mimix'), the same masked
arithmetic on tensors:

* `yb_loss`: for each (audio_i, visual_i) pair with disjoint multi-hot
  targets, the positive bag is the pooled own-modality probability and the
  negative bag the pooled swapped-modality probability of the tail
  (augmented) rows; a masked mean of -log(pos / (pos + neg)) over the
  target-active classes. Among selected pairs that hit one row the last one's
  positive bag wins and the negative bags add up, as in the JAX function.
  Pair indices index the main rows, [0, B_main); others write nothing (JAX's
  scatter drops them too).
* `yb_loss2`: 'vision' / 'audio' the mean BCE of prob_x2[i] against
  target[sample_idx[i]]; 'ada' a label-correlation InfoNCE over
  L2-normalized features; 'mimix' an InfoNCE with a binarized
  self-correlation mask of target[rand_idx] (the reference's row-sum quirk
  included). The reference's 'mix' / 'yybag' branches read undefined names;
  as in the JAX package they raise here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _bce(p: torch.Tensor, t: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    p = torch.clamp(p, eps, 1.0 - eps)
    return -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p))


def _pool(x: torch.Tensor, kind: str, dim: int) -> torch.Tensor:
    return x.amax(dim=dim) if kind == "max" else x.mean(dim=dim)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def yb_loss(all_prob: torch.Tensor, audio_idx: torch.Tensor, vis_idx: torch.Tensor,
            target: torch.Tensor, *, exp: bool = False, pos_pool: str = "max",
            neg_pool: str = "max", eps: float = 1e-12) -> torch.Tensor:
    """all_prob (B_ext, S, 2, C), its last len(audio_idx) rows the augmented
    negatives; target (B, C) multi-hot. Returns the scalar loss."""
    n = audio_idx.shape[0]
    target = target.to(all_prob.dtype)
    sel = (target[audio_idx] * target[vis_idx]).sum(-1) == 0        # (n,) disjoint pairs
    a_pos_v = _pool(all_prob[audio_idx, :, 0, :], pos_pool, 1)       # (n, C)
    v_pos_v = _pool(all_prob[vis_idx, :, 1, :], pos_pool, 1)
    tail = _pool(all_prob[-n:], neg_pool, 1)                        # (n, 2, C)
    a_neg_v, v_neg_v = tail[:, 1, :], tail[:, 0, :]
    if exp:
        a_pos_v, v_pos_v = torch.exp(a_pos_v), torch.exp(v_pos_v)
        a_neg_v, v_neg_v = torch.exp(a_neg_v), torch.exp(v_neg_v)
    B_main = all_prob.shape[0] - n
    rows = torch.arange(B_main, device=all_prob.device)

    def scatter(idx, pos_v, neg_v):
        """(positive bags: the last selected pair's per row, negative bags
        summed over the selected pairs per row, rows written)."""
        oh = (idx[:, None] == rows[None, :]) & sel[:, None]          # (n, B_main)
        written = oh.any(0)
        last = (n - 1) - torch.argmax(oh.flip(0).to(torch.int32), dim=0)
        pos = torch.where(written[:, None], pos_v[last], torch.zeros_like(pos_v[last]))
        neg = oh.to(neg_v.dtype).T @ torch.where(sel[:, None], neg_v, torch.zeros_like(neg_v))
        return pos, neg, written

    a_pos, a_neg, a_m = scatter(audio_idx, a_pos_v, a_neg_v)
    v_pos, v_neg, v_m = scatter(vis_idx, v_pos_v, v_neg_v)
    t = target[:B_main]
    cls = t != 0

    def stream(pos, neg, written):
        m = cls & written[:, None]
        term = -torch.log(torch.clamp(pos, min=eps) / torch.clamp(pos + neg, min=eps))
        return (term * m).sum() / torch.clamp(m.sum(), min=1)

    return stream(v_pos * t, v_neg * t, v_m) + stream(a_pos * t, a_neg * t, a_m)


def yb_loss2(aug_type: str, *, prob_x1: Optional[torch.Tensor] = None,
             prob_x2: Optional[torch.Tensor] = None, rand_idx: Optional[torch.Tensor] = None,
             sample_idx: Optional[torch.Tensor] = None, target: Optional[torch.Tensor] = None,
             target_pair: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
             x1: Optional[torch.Tensor] = None, x2: Optional[torch.Tensor] = None,
             smooth: float = 1.0, tmp: float = 0.1, eps: float = 1e-10) -> torch.Tensor:
    """'vision' / 'audio': prob_x2 (n, C) vs target[sample_idx]. 'ada': x1 /
    x2 (n, D) features, target_pair = (target_audio, target_vis). 'mimix':
    x1 / x2 (n, D), target (B, C) whose rand_idx rows make the mask."""
    if aug_type in ("vision", "audio"):
        n = sample_idx.shape[0]
        return _bce(prob_x2[:n], target[sample_idx].to(prob_x2.dtype)).mean()
    if aug_type == "ada":
        ta, tv = target_pair
        corr = torch.where(ta.to(x1.dtype) @ tv.to(x1.dtype).T != 0, smooth, 0.0)
        sim = torch.exp(_unit(x1) @ _unit(x2).T / tmp)
        pos = (sim * corr).sum(1) + eps
        neg = (sim * (1.0 - corr)).sum(1) + eps
        return (-torch.log(pos / (pos + neg))).mean()
    if aug_type == "mimix":
        t = target.to(x1.dtype)
        tr = torch.clamp(t[rand_idx] * 2.0, 0.0, 1.0)
        corr_copy = torch.where(tr @ tr.T != 0, 1.0, 0.0)
        exact_same = t[sample_idx].sum(-1)                           # (n,)
        corr = torch.where(corr_copy == exact_same[None, :], 1.0, corr_copy)
        sim = torch.exp(_unit(x1) @ _unit(x2).T / tmp)
        pos = (sim * corr).sum(1) + eps
        neg = (sim * (1.0 - corr_copy)).sum(1)
        return (-torch.log(pos / (pos + neg))).mean()
    raise ValueError(f"unsupported aug_type {aug_type!r} "
                     "(the reference's 'mix'/'yybag' branches are dead code)")
