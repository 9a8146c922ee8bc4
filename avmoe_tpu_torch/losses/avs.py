"""AVS segmentation losses.

Counterpart of `avmoe_tpu/losses/avs.py`: S4's first-frame IoU-BCE and
MS3's all-frame one, the masked audio-visual loss in its cosine, euclidean
and KL flavours (with the nearest-audio `closer` pairing), and their sum.
Masks are (B*T, H, W) logits, ground truths binary; feature maps (B*T, h,
w, C) and aligned audio (B, T, C).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from avmoe_tpu_torch.parallel.mesh import world_size


def _bce(probs: torch.Tensor, targets: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    p = probs.clamp(eps, 1 - eps)
    return -(targets * torch.log(p) + (1 - targets) * torch.log(1 - p)).mean()


def f1_iou_bce_loss(pred_logits: torch.Tensor, first_gt: torch.Tensor,
                    num_frames: int = 5) -> torch.Tensor:
    """BCE on the first frame of each clip (S4): pred (B*T, H, W), first_gt
    (B, H, W)."""
    pred = torch.sigmoid(pred_logits)
    first = pred.reshape(-1, num_frames, *pred.shape[1:])[:, 0]
    return _bce(first, first_gt)


def f5_iou_bce_loss(pred_logits: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """BCE on every frame (MS3): gt (B*T, H, W) or (B, T, H, W)."""
    return _bce(torch.sigmoid(pred_logits), gt.reshape(pred_logits.shape))


def _masked_visual_feature(pred_logits: torch.Tensor, v_map: torch.Tensor, pooling: str,
                           threshold: bool, sigmoid_after_pool: bool) -> torch.Tensor:
    """The masks pooled to the map's size, the map masked and averaged:
    (B*T, C). S4 takes the sigmoid before pooling, MS3 after; the two
    orders differ."""
    BT, H, W, C = v_map.shape
    x = pred_logits if sigmoid_after_pool else torch.sigmoid(pred_logits)
    ph, pw = x.shape[1] // H, x.shape[2] // W
    xg = x.reshape(BT, H, ph, W, pw)
    down = xg.mean(dim=(2, 4)) if pooling == "avg" else xg.amax(dim=(2, 4))
    if sigmoid_after_pool:
        down = torch.sigmoid(down)
    down = down[..., None]
    if threshold:
        down = (down > 0.5).to(v_map.dtype)
        return (v_map * down).sum(dim=(1, 2)) / (down.sum(dim=(1, 2)) + 1e-6)
    return (v_map * down).mean(dim=(1, 2))


def _unit(t: torch.Tensor) -> torch.Tensor:
    return t / torch.linalg.vector_norm(t, dim=-1, keepdim=True).clamp_min(1e-12)


def masked_av_loss(pred_logits: torch.Tensor, a_fea_list: Sequence[Optional[torch.Tensor]],
                   v_map_list: Sequence[torch.Tensor], count_stages: Sequence[int], *,
                   pooling: str = "avg", norm_fea: bool = True, threshold: bool = True,
                   kind: str = "cosine", closer: bool = False, setting: str = "s4"
                   ) -> torch.Tensor:
    """Audio <-> masked-visual matching loss, averaged over `count_stages`:
    'cosine' -log(relu(cos) + 1e-6), 'euclidean' distance or 'kl'
    KL(softmax(target) || softmax(v)). With `closer` the audio only picks
    each row's nearest other audio row, and v is held against that row's
    visual feature (always the soft-mask mean)."""
    if closer and world_size() > 1:
        raise ValueError("masked_av_loss: closer=True pairs rows across the batch; it is not "
                         "ported to more than one process")
    total = pred_logits.new_zeros(())
    for stage in count_stages:
        a = a_fea_list[stage].reshape(-1, a_fea_list[stage].shape[-1])
        v = _masked_visual_feature(pred_logits, v_map_list[stage], pooling,
                                   threshold and not closer, setting == "ms3")
        if norm_fea:
            a, v = _unit(a), _unit(v)
        if closer:
            dists = torch.linalg.vector_norm(a[:, None] - a[None, :], dim=-1)
            dists = dists + 10.0 * torch.eye(a.shape[0], device=a.device, dtype=dists.dtype)
            target = v[torch.argmin(dists, dim=0)]
        else:
            target = a
        if kind == "cosine":
            total = total + (-torch.log(F.relu((v * target).sum(-1)) + 1e-6)).mean()
        elif kind == "euclidean":
            total = total + torch.linalg.vector_norm(target - v, dim=-1).mean()
        elif kind == "kl":
            p, q = torch.softmax(v, dim=-1), torch.softmax(target, dim=-1)
            # a sum over the batch's rows: scaled by the ranks, so that their
            # mean over the ranks (the gradients') is the global batch's sum
            kl = (q * (torch.log(q + 1e-12) - torch.log(p + 1e-12))).sum()
            total = total + kl * world_size()
        else:
            raise ValueError(f"masked_av_loss kind {kind!r}")
    return total / max(len(count_stages), 1)


def iou_semantic_aware_loss(pred_logits: torch.Tensor, gt_mask: torch.Tensor,
                            a_fea_list: Sequence[Optional[torch.Tensor]],
                            v_map_list: Sequence[torch.Tensor], *, setting: str = "s4",
                            num_frames: int = 5, lambda_1: float = 0.0,
                            count_stages: Sequence[int] = (), sa_loss_flag: bool = False,
                            pooling: str = "avg", kind: str = "cosine", closer: bool = False,
                            norm_fea: bool = True, threshold: bool = True
                            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The IoU-BCE loss of the setting, plus lambda_1 times the masked
    audio-visual loss when it is on: (total, {"iou_loss", ["sa_loss"]})."""
    if setting == "s4":
        iou = f1_iou_bce_loss(pred_logits, gt_mask, num_frames)
    else:
        iou = f5_iou_bce_loss(pred_logits, gt_mask)
    total, aux = iou, {"iou_loss": iou}
    if sa_loss_flag and lambda_1 > 0 and count_stages:
        sa = masked_av_loss(pred_logits, a_fea_list, v_map_list, count_stages, pooling=pooling,
                            kind=kind, closer=closer, norm_fea=norm_fea, threshold=threshold,
                            setting=setting)
        total = total + lambda_1 * sa
        aux["sa_loss"] = sa
    return total, aux
