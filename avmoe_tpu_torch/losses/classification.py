"""Classification losses the AVE loss uses.

Counterpart of `avmoe_tpu/losses/classification.py:9-18` (the two that
`losses/ave.py` reads).
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
