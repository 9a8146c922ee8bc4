"""Timing and averaging utilities.

Counterpart of `avmoe_tpu/telemetry/meters.py`.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict


class AverageMeter:
    """Running averages for scalar metrics."""

    def __init__(self):
        self._sum: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)

    def add(self, **values: float) -> None:
        for k, v in values.items():
            self._sum[k] += float(v)
            self._count[k] += 1

    def get(self, key: str) -> float:
        return self._sum[key] / max(self._count[key], 1)

    def count(self, key: str) -> int:
        return self._count.get(key, 0)

    def pop(self, key: str) -> float:
        v = self.get(key)
        self._sum.pop(key, None)
        self._count.pop(key, None)
        return v

    def averages(self) -> Dict[str, float]:
        return {k: self.get(k) for k in self._sum}


class Timer:
    """Wall-clock interval timer."""

    def __init__(self):
        self.start = time.monotonic()
        self.last = self.start

    def lap(self) -> float:
        now = time.monotonic()
        dt = now - self.last
        self.last = now
        return dt

    def total(self) -> float:
        return time.monotonic() - self.start
