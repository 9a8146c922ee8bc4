"""Train and eval steps.

Counterpart of `avmoe_tpu/train/steps.py`. The loss is differentiated with
respect to the trainable parameters only (`torch.autograd.grad`): a frozen
backbone's activations still carry gradients back to the adapters, through
K1b and K2b on the card, but no parameter gradient is made for it; a
trainable backbone (AVS S4's HTS-AT) gets its weights' gradients from the
same kernels (K1b's bias gradient, K2b's six parameter gradients). The
forward updates the BN running statistics in the model's buffers, which is
where the next step and the eval step read them. Under a process group
(`parallel/mesh.py`) the step all-reduces the trainable gradients to their
mean over the ranks before the update, and its scalar metrics likewise.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from avmoe_tpu_torch.parallel.mesh import average_gradients, mean_scalars
from avmoe_tpu_torch.train.state import TrainState


def make_train_step(loss_fn: Callable) -> Callable:
    """loss_fn: (model, batch, generator) -> (loss, aux). Returns
    train_step(state, batch, generator) -> (state, metrics)."""

    def train_step(state: TrainState, batch: Dict, generator: Optional[torch.Generator]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        loss, aux = loss_fn(state.model, batch, generator)
        params = list(state.trainable.values())
        grads = average_gradients(torch.autograd.grad(loss, params, allow_unused=True))
        state.apply_gradients(grads)
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}
        return state, mean_scalars(metrics)

    return train_step


def make_eval_step(eval_fn: Callable) -> Callable:
    """eval_fn: batch -> metrics. Returns eval_step(state, batch), gradient-free."""

    def eval_step(state: TrainState, batch: Dict) -> Dict:
        with torch.no_grad():
            return eval_fn(batch)

    return eval_step
