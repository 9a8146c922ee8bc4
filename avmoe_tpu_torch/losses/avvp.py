"""AVVP training loss.

Counterpart of `avmoe_tpu/losses/avvp.py`:

  BCE(global_prob, weak labels) + BCE(audio probs, labels, no smoothing)
  + BCE(visual probs, labels smoothed by 0.1) + CE(each class token's
  logits, its own class) + lb_weight * the summed router load-balance loss.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from avmoe_tpu_torch.losses.classification import binary_cross_entropy, cross_entropy_with_logits


def avvp_loss(outputs: Dict, labels: torch.Tensor, *, smooth_a: float = 0.0,
              smooth_v: float = 0.1, lb_weight: float = 1.0
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """labels (B, 25) weak multi-labels in {0, 1}."""
    eps = 1e-7
    global_prob = torch.clamp(outputs["global_prob"], eps, 1 - eps)
    a_prob = torch.clamp(outputs["a_prob"], eps, 1 - eps)
    v_prob = torch.clamp(outputs["v_prob"], eps, 1 - eps)
    labels = labels.to(global_prob.dtype)
    pa = (1.0 - smooth_a) * labels + smooth_a * 0.5
    pv = (1.0 - smooth_v) * labels + smooth_v * 0.5

    loss_av = binary_cross_entropy(global_prob, labels)
    loss_a = binary_cross_entropy(a_prob, pa)
    loss_v = binary_cross_entropy(v_prob, pv)
    n_cls = outputs["aud_cls_logits"].shape[-1]
    diag = torch.arange(n_cls, device=labels.device)
    loss_cls_aud = cross_entropy_with_logits(outputs["aud_cls_logits"], diag)
    loss_cls_vis = cross_entropy_with_logits(outputs["vis_cls_logits"], diag)

    lb = outputs["telemetry"]["lb_loss"]
    loss = loss_av + loss_a + loss_v + loss_cls_aud + loss_cls_vis + lb_weight * lb
    aux = {"loss_av": loss_av, "loss_a": loss_a, "loss_v": loss_v,
           "loss_cls_aud": loss_cls_aud, "loss_cls_vis": loss_cls_vis, "loss_lb": lb}
    return loss, aux
