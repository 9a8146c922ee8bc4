"""Metric writers with one .log(dict) interface.

Counterpart of `avmoe_tpu/telemetry/writers.py`: JSONLWriter always works;
WandbWriter and TensorboardWriter become no-ops, with a warning, where
their packages are absent.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

log = logging.getLogger("avmoe_tpu_torch.telemetry")


class JSONLWriter:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def log(self, metrics: Dict) -> None:
        rec = {"time": time.time(), **{k: float(v) if hasattr(v, "__float__") else v
                                       for k, v in metrics.items()}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class WandbWriter:
    def __init__(self, project: str, name: Optional[str] = None, config=None):
        try:
            import wandb

            self._run = wandb.init(project=project, name=name, config=config)
        except ImportError:
            log.warning("wandb not installed; WandbWriter is a no-op")
            self._run = None

    def log(self, metrics: Dict) -> None:
        if self._run is not None:
            self._run.log(metrics)

    def close(self) -> None:
        if self._run is not None:
            self._run.finish()


class TensorboardWriter:
    def __init__(self, logdir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._w = SummaryWriter(logdir)
        except Exception:
            log.warning("tensorboard not available; TensorboardWriter is a no-op")
            self._w = None
        self._step = 0

    def log(self, metrics: Dict) -> None:
        self._step += 1
        if self._w is None:
            return
        for k, v in metrics.items():
            if hasattr(v, "__float__"):
                self._w.add_scalar(k, float(v), self._step)

    def close(self) -> None:
        if self._w is not None:
            self._w.close()


class MultiWriter:
    def __init__(self, *writers):
        self.writers = [w for w in writers if w is not None]

    def log(self, metrics: Dict) -> None:
        for w in self.writers:
            w.log(metrics)

    def close(self) -> None:
        for w in self.writers:
            w.close()
