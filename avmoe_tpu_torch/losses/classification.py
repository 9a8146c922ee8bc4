"""Classification losses: the three the AVE and AVVP losses use, AVVP's
label-smoothed BCE and the asymmetric multi-label loss.

Counterpart of `avmoe_tpu/losses/classification.py:9-54`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def binary_cross_entropy_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid BCE (optax sigmoid_binary_cross_entropy, then the mean)."""
    return F.binary_cross_entropy_with_logits(logits, targets.to(logits.dtype))


def cross_entropy_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax CE with integer labels."""
    return F.cross_entropy(logits, labels.long())


def binary_cross_entropy(probs: torch.Tensor, targets: torch.Tensor,
                         eps: float = 1e-7) -> torch.Tensor:
    """Mean BCE on probabilities clipped to [eps, 1 - eps] (torch's BCELoss
    on clipped inputs)."""
    p = torch.clamp(probs, eps, 1.0 - eps)
    t = targets.to(p.dtype)
    return -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p)).mean()


def label_smoothed_bce(probs: torch.Tensor, targets: torch.Tensor, smooth: float) -> torch.Tensor:
    """BCE on probabilities against targets smoothed as (1 - a) t + a / 2."""
    return binary_cross_entropy(probs, (1.0 - smooth) * targets + smooth / 2.0)


def asymmetric_loss(probs: torch.Tensor, targets: torch.Tensor, gamma_neg: float = 4.0,
                    gamma_pos: float = 1.0, clip: float = 0.05, eps: float = 1e-8
                    ) -> torch.Tensor:
    """Asymmetric multi-label loss on PROBABILITIES: negatives margin-shifted
    by `clip` and focused harder (gamma_neg); the focal weight carries no
    gradient."""
    t = targets.to(probs.dtype)
    p_neg = torch.clamp(1.0 - probs + clip, max=1.0)
    loss_pos = t * torch.log(torch.clamp(probs, min=eps))
    loss_neg = (1.0 - t) * torch.log(torch.clamp(p_neg, min=eps))
    pt = probs * t + p_neg * (1.0 - t)
    gamma = gamma_pos * t + gamma_neg * (1.0 - t)
    focus = torch.pow(1.0 - pt, gamma).detach()
    return -(focus * (loss_pos + loss_neg)).mean()
