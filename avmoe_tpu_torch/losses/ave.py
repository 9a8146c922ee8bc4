"""AVE training loss: segment BCE + clip-level CE on the event class + CAS CE.

Counterpart of `avmoe_tpu/losses/ave.py`. From (B, T, C+1) one-hot labels
(background last):
  labels_bce   (B, T)  any-foreground indicator per segment,
  labels_event (B,)    clip event class (the largest foreground argmax over time),
then loss = BCE(is_event) + CE(event_logits) + CE(av_score) [+ lb_weight lb].
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from avmoe_tpu_torch.losses.classification import (
    binary_cross_entropy_with_logits, cross_entropy_with_logits)


def ave_labels(labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, C+1) one-hot -> (labels_bce (B, T), labels_event (B,))."""
    fg = labels[..., :-1]
    labels_bce = fg.amax(dim=-1)
    seg_cls = torch.argmax(fg, dim=-1)              # background rows -> 0
    return labels_bce, seg_cls.amax(dim=-1)


def ave_loss(outputs: Dict, labels: torch.Tensor,
             lb_weight: float = 0.0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    labels_bce, labels_event = ave_labels(labels)
    loss_is_event = binary_cross_entropy_with_logits(outputs["is_event_logits"], labels_bce)
    loss_event_class = cross_entropy_with_logits(outputs["event_logits"], labels_event)
    loss_cas = cross_entropy_with_logits(outputs["av_score"], labels_event)
    loss = loss_is_event + loss_event_class + loss_cas
    aux = {"loss_is_event": loss_is_event, "loss_event_class": loss_event_class,
           "loss_cas": loss_cas}
    if lb_weight:
        lb = outputs["telemetry"]["lb_loss"]
        loss = loss + lb_weight * lb
        aux["loss_lb"] = lb
    return loss, aux
