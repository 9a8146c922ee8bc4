"""Parameter freezing: frozen backbones, trainable adapters and heads.

Counterpart of `avmoe_tpu/train/freeze.py`. The port's parameters carry the
flax tree's names (module path "encoder.swin.block_0_0.attn" is the flax
scope encoder/swin/block_0_0/attn), so the JAX package's path rule applies
to them as it is; `freeze` turns it into requires_grad flags, and the frozen
backbones then get no gradient buffers and no optimizer state.

`frozen_scopes` names the backbones that freeze: both by default (AVE, AVVP,
AVQA, AVS MS3); AVS S4 passes ("swin",), since its reference recipe trains
HTS-AT.
"""

from __future__ import annotations

from typing import Dict, Tuple

from torch import nn

FROZEN_SCOPES = ("swin", "htsat")
# adapter / MoE modules inside the encoder scope stay trainable
TRAINABLE_MARKERS = ("moe", "adapter")


def is_trainable_path(path: Tuple[str, ...],
                      frozen_scopes: Tuple[str, ...] = FROZEN_SCOPES) -> bool:
    """True if the parameter at `path` trains: anything under a backbone scope
    in `frozen_scopes` is frozen unless the path also crosses an adapter /
    MoE scope; everything else (heads, temporal attention, adapters) trains."""
    if any(any(m in part for m in TRAINABLE_MARKERS) for part in path):
        return True
    return not any(part in frozen_scopes for part in path)


def partition(model: nn.Module, frozen_scopes: Tuple[str, ...] = FROZEN_SCOPES
              ) -> Tuple[Dict[str, nn.Parameter], Dict[str, nn.Parameter]]:
    """(trainable, frozen) parameters by name."""
    trainable, frozen = {}, {}
    for name, p in model.named_parameters():
        path = tuple(name.split("."))
        (trainable if is_trainable_path(path, frozen_scopes) else frozen)[name] = p
    return trainable, frozen


def freeze(model: nn.Module, frozen_scopes: Tuple[str, ...] = FROZEN_SCOPES
           ) -> Dict[str, nn.Parameter]:
    """Set requires_grad from the path rule; returns the trainable parameters."""
    trainable, frozen = partition(model, frozen_scopes)
    for p in trainable.values():
        p.requires_grad_(True)
    for p in frozen.values():
        p.requires_grad_(False)
    return trainable


def count_params(params: Dict[str, nn.Parameter]) -> int:
    return sum(p.numel() for p in params.values())


def param_report(model: nn.Module,
                 frozen_scopes: Tuple[str, ...] = FROZEN_SCOPES) -> Dict[str, float]:
    """Trainable / frozen / total parameter counts and shares, as the JAX
    package reports them."""
    trainable, frozen = partition(model, frozen_scopes)
    t, f = count_params(trainable), count_params(frozen)
    total = t + f
    return {"trainable": t, "frozen": f, "total": total,
            "trainable_pct": 100.0 * t / total, "additional_pct": 100.0 * t / max(f, 1)}
