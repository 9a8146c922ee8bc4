"""AVQA accuracy: overall and per question type.

Counterpart of `avmoe_tpu/metrics/avqa.py` (the port keeps its own numpy
copy): predicted against true answer ids, counted overall and under each
(modality, question-type) string the reader gives a question.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

import numpy as np


class AVQAAccuracy:
    """Accumulates overall and per-question-type accuracy."""

    def __init__(self):
        self.correct = defaultdict(int)
        self.total = defaultdict(int)

    def update(self, pred: np.ndarray, answer: np.ndarray, qtypes: List[str]) -> None:
        for p, a, t in zip(np.asarray(pred), np.asarray(answer), qtypes):
            ok = int(p == a)
            self.correct["overall"] += ok
            self.total["overall"] += 1
            if t:
                self.correct[t] += ok
                self.total[t] += 1

    def summary(self) -> Dict[str, float]:
        """Percent correct per key: 'overall' and every question type seen."""
        return {k: 100.0 * self.correct[k] / max(self.total[k], 1) for k in self.total}
