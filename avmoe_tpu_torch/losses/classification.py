"""Classification losses the AVE and AVVP losses use.

Counterpart of `avmoe_tpu/losses/classification.py:9-24` (the three that
`losses/ave.py` and `losses/avvp.py` read).
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
