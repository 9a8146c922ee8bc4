"""Train state: the model, its trainable parameters and the optimizer.

Counterpart of `avmoe_tpu/train/state.py`: Adam (optax's defaults: betas
0.9 / 0.999, eps 1e-8, no weight decay) over the trainable parameters only,
a step-decay learning rate counted in applied updates, a separate
`mlp_class` group at `lr_mlp`, and gradient accumulation that averages over
`accum_steps` micro-steps as `optax.MultiSteps` does (a running mean,
acc += (g - acc) / (n + 1)), not the sum of the original recipe.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from avmoe_tpu_torch.config import TrainConfig
from avmoe_tpu_torch.train.freeze import FROZEN_SCOPES, freeze


def step_decay_schedule(base_lr: float, gamma: float, step_size_epochs: int,
                        steps_per_epoch: int) -> Callable[[int], float]:
    """StepLR: base_lr * gamma ** (epoch // step_size), epoch = count // steps_per_epoch."""

    def schedule(count: int) -> float:
        epoch = count // max(steps_per_epoch, 1)
        return base_lr * gamma ** (epoch // step_size_epochs)

    return schedule


def param_groups(trainable: Dict[str, nn.Parameter], cfg: TrainConfig,
                 steps_per_epoch: int = 1) -> List[Tuple[List[nn.Parameter], Callable]]:
    """[(params, schedule)]: one group at `lr`, and with lr_mlp != lr the
    parameters whose name has a 'mlp_class' part at `lr_mlp`. Schedules
    count applied updates (micro-steps // accum_steps per epoch)."""
    updates_per_epoch = max(steps_per_epoch // max(cfg.accum_steps, 1), 1)

    def sched(lr: float) -> Callable[[int], float]:
        return step_decay_schedule(lr, cfg.decay, cfg.decay_epoch, updates_per_epoch)

    if cfg.lr_mlp == cfg.lr:
        return [(list(trainable.values()), sched(cfg.lr))]
    mlp = [p for n, p in trainable.items() if any("mlp_class" in part for part in n.split("."))]
    base = [p for n, p in trainable.items()
            if not any("mlp_class" in part for part in n.split("."))]
    return [(ps, sched(lr)) for ps, lr in ((base, cfg.lr), (mlp, cfg.lr_mlp)) if ps]


@dataclass
class TrainState:
    """What a train step reads and updates. `step` counts micro-steps,
    `updates` applied optimizer updates; the running BN statistics live in
    the model's buffers (`batch_stats`)."""

    model: nn.Module
    trainable: Dict[str, nn.Parameter]
    optimizer: torch.optim.Optimizer
    schedules: List[Callable[[int], float]]
    accum_steps: int = 1
    step: int = 0
    updates: int = 0
    mini_step: int = 0
    acc_grads: Optional[List[torch.Tensor]] = field(default=None, repr=False)

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        return {name: buf for name, buf in self.model.named_buffers()
                if name.rsplit(".", 1)[-1] in ("running_mean", "running_var")}

    def apply_gradients(self, grads: Sequence[Optional[torch.Tensor]]) -> None:
        """One micro-step: accumulate (running mean), and every accum_steps-th
        call set the mean as the gradient and take an Adam step."""
        params = list(self.trainable.values())
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        if self.accum_steps > 1:
            if self.acc_grads is None:
                self.acc_grads = [torch.zeros_like(p) for p in params]
            n = self.mini_step
            for acc, g in zip(self.acc_grads, grads):
                acc.add_((g - acc) / (n + 1))
            if n < self.accum_steps - 1:
                self.mini_step += 1
                self.step += 1
                return
            grads = self.acc_grads
        for group, sched in zip(self.optimizer.param_groups, self.schedules):
            group["lr"] = sched(self.updates)
        for p, g in zip(params, grads):
            p.grad = g.clone() if self.accum_steps > 1 else g
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        if self.accum_steps > 1:
            for acc in self.acc_grads:
                acc.zero_()
        self.mini_step = 0
        self.updates += 1
        self.step += 1


def make_optimizer(groups: List[Tuple[List[nn.Parameter], Callable]]) -> torch.optim.Adam:
    return torch.optim.Adam([{"params": ps, "lr": sched(0)} for ps, sched in groups],
                            betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)


def create_train_state(model: nn.Module, cfg: TrainConfig, steps_per_epoch: int = 1,
                       frozen_scopes: Tuple[str, ...] = FROZEN_SCOPES) -> TrainState:
    """Freeze the backbones in `frozen_scopes` (requires_grad), and build
    Adam over the rest."""
    trainable = freeze(model, frozen_scopes)
    groups = param_groups(trainable, cfg, steps_per_epoch)
    ordered = {id(p): n for n, p in trainable.items()}
    # the state's parameter order is the optimizer's: group by group
    trainable = {ordered[id(p)]: p for ps, _ in groups for p in ps}
    return TrainState(model=model, trainable=trainable, optimizer=make_optimizer(groups),
                      schedules=[s for _, s in groups], accum_steps=max(cfg.accum_steps, 1))
