"""Full train-state checkpoints with resume, on torch.save.

Counterpart of `avmoe_tpu/checkpoint/manager.py` (orbax there). A
checkpoint holds the whole train state (`train/state.py` `TrainState`):

  * `model`: `model.state_dict()`, the trainable and frozen float32 master
    weights and the BatchNorm running statistics;
  * `optimizer`: `optimizer.state_dict()`, Adam's moments and counts;
  * `step`, `updates`, `mini_step` and `acc_grads`, the half-accumulated
    gradient of an accumulation window (optax.MultiSteps keeps it too);
  * `trainable`: the trainable parameters' names and shapes in the
    optimizer's order, checked on restore (the optimizer matches its state
    to parameters by position).

The learning-rate schedules are not saved: they are rebuilt from the
config. Each step is a directory `<step>/state.pt`, written under a
temporary name and moved into place with `os.replace`, so an interrupted
save never becomes the latest. The `max_to_keep` latest steps are kept;
`best.json` holds {"step": ..., "metric": ...} of the best save. Files are
read with `torch.load(..., weights_only=True)`.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Dict, List, Mapping, Optional

import torch

from avmoe_tpu_torch.parallel.mesh import is_main
from avmoe_tpu_torch.train.state import TrainState

STATE_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._best_path = os.path.join(self.directory, "best.json")

    # -- full-state save / resume ------------------------------------------

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def all_steps(self) -> List[int]:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.isfile(os.path.join(self.directory, d,
                                                                     STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState, metrics: Optional[Dict] = None) -> None:
        payload = {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": int(state.step), "updates": int(state.updates),
            "mini_step": int(state.mini_step), "accum_steps": int(state.accum_steps),
            "acc_grads": state.acc_grads,
            "trainable": [(n, list(p.shape)) for n, p in state.trainable.items()],
        }
        tmp = os.path.join(self.directory, f".tmp.{int(step)}.{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, STATE_FILE))
        if metrics is not None:
            with open(os.path.join(tmp, "metrics.json"), "w") as f:
                json.dump({k: float(v) for k, v in metrics.items()}, f)
        final = self.step_dir(step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self.step_dir(old))

    def load(self, step: Optional[int] = None, map_location=None) -> Dict:
        """The saved payload of `step` (default: the latest)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self.directory}")
        return torch.load(os.path.join(self.step_dir(step), STATE_FILE),
                          map_location=map_location, weights_only=True)

    def restore(self, state: TrainState, step: Optional[int] = None,
                params_only: bool = False) -> TrainState:
        """Restore `state` in place (and return it). With params_only only
        the model's parameters and running statistics are taken, as for an
        evaluation of a checkpoint trained with another optimizer setting
        (another accum_steps)."""
        device = next(state.model.parameters()).device
        payload = self.load(step, map_location=device)
        state.model.load_state_dict(payload["model"])
        if params_only:
            return state
        want = [(n, list(p.shape)) for n, p in state.trainable.items()]
        got = [(n, list(s)) for n, s in payload["trainable"]]
        if got != want:
            raise ValueError("checkpoint's trainable parameters (names, shapes, order) differ "
                             "from the state's")
        if payload["accum_steps"] != state.accum_steps:
            raise ValueError(f"checkpoint trained with accum_steps {payload['accum_steps']}, "
                             f"state has {state.accum_steps}; restore with params_only=True")
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step, state.updates = payload["step"], payload["updates"]
        state.mini_step, state.acc_grads = payload["mini_step"], payload["acc_grads"]
        return state

    # -- best-metric tracking ------------------------------------------------

    def save_if_best(self, step: int, state: TrainState, metric: float) -> bool:
        """Save `state` and record it in best.json if `metric` is at least
        the best so far; True if it saved. Under a process group only rank
        0 saves (the others return False)."""
        if not is_main():
            return False
        best = self.best_metric()
        if best is None or metric >= best:
            self.save(step, state, metrics={"metric": float(metric)})
            with open(self._best_path, "w") as f:
                json.dump({"step": int(step), "metric": float(metric)}, f)
            return True
        return False

    def best_metric(self) -> Optional[float]:
        if os.path.exists(self._best_path):
            with open(self._best_path) as f:
                return float(json.load(f)["metric"])
        return None

    # -- partial load / remap surgery ---------------------------------------

    @staticmethod
    def load_partial(params: Mapping, donor: Mapping, *, include: Optional[str] = None,
                     exclude: Optional[str] = None,
                     rename: Optional[Dict[str, str]] = None) -> Dict:
        """Copy donor entries into a copy of `params` where names match.

        Both are flat dicts keyed by '/'- or '.'-joined names (a
        `state_dict()` or a flattened flax tree). include / exclude are
        regexes and `rename` maps donor name prefixes to target prefixes,
        all over the '/'-joined names; an entry is copied where the renamed
        name exists in `params` with the same shape."""
        canon = {k.replace(".", "/"): k for k in params}
        out = dict(params)
        inc = re.compile(include) if include else None
        exc = re.compile(exclude) if exclude else None
        applied = 0
        for k, v in donor.items():
            path = k.replace(".", "/")
            for src, dst in (rename or {}).items():
                if path.startswith(src):
                    path = dst + path[len(src):]
                    break
            if inc and not inc.search(path):
                continue
            if exc and exc.search(path):
                continue
            key = canon.get(path)
            if key is not None and tuple(out[key].shape) == tuple(v.shape):
                out[key] = v
                applied += 1
        if not applied:
            raise AssertionError("load_partial matched nothing")
        return out
