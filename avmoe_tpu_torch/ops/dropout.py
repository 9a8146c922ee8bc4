"""Train-time random masks: dropout and DropPath (stochastic depth).

Counterparts of flax's `nn.Dropout` and `avmoe_tpu/ops/swin.py:187`
`DropPath`. The masks come from an explicit `torch.Generator` on the
tensors' device; they cannot match the JAX package's bits, so the parity
tests turn them off (`utils/runtime.py` `dropout_det`, zero DropPath rates).
"""

from __future__ import annotations

from typing import Optional

import torch

from avmoe_tpu_torch.utils.runtime import dropout_det


def _need(generator: Optional[torch.Generator], what: str) -> torch.Generator:
    if generator is None:
        raise ValueError(f"{what} in train mode needs a torch.Generator")
    return generator


def dropout(x: torch.Tensor, rate: float, *, train: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax nn.Dropout: x / keep where a Bernoulli(keep) mask is set, else 0;
    the identity in eval, at rate 0 and under dropout_det."""
    if rate == 0.0 or dropout_det(train):
        return x
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=_need(generator, "dropout"), device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def drop_path_scale(frames: int, rate: float, *, train: bool,
                    generator: Optional[torch.Generator],
                    device) -> Optional[torch.Tensor]:
    """DropPath's per-frame float32 scale s (mask / keep), or None where the
    branch is kept whole (eval, rate 0). The residual is x + s ⊙ branch."""
    if rate == 0.0 or not train:
        return None
    keep = 1.0 - rate
    u = torch.rand((frames,), generator=_need(generator, "DropPath"), device=device)
    return torch.where(u < keep, 1.0 / keep, 0.0).to(torch.float32)
