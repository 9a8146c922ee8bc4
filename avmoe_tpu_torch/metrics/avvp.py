"""AVVP evaluation: segment-level and event-level F1 suites.

Counterpart of `avmoe_tpu/metrics/avvp.py` (the port keeps its own numpy
copy): per clip, per-class F1 over 25 classes x 10 one-second segments, for
the audio, visual, audio-visual and combined streams. Event-level scores
first extract contiguous event intervals and match them at IoU >= 0.5.
Classes with no prediction and no ground truth are excluded; a clip that is
all true negatives scores 1.0. Host-side numpy, run over eval outputs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

NUM_CLASSES = 25
NUM_SEGMENTS = 10


def _f1_per_class(tp: np.ndarray, fp: np.ndarray, fn: np.ndarray) -> float:
    mask = (tp + fp != 0) | (tp + fn != 0)
    if not mask.any():
        return 1.0  # all true negatives
    f = 2 * tp[mask] / (2 * tp[mask] + fp[mask] + fn[mask])
    return float(f.mean())


def segment_level(
    so_a: np.ndarray, so_v: np.ndarray, so_av: np.ndarray,
    gt_a: np.ndarray, gt_v: np.ndarray, gt_av: np.ndarray,
) -> Tuple[float, float, float, float]:
    """All arrays (25, 10) binary. Returns (f_a, f_v, f_joint, f_av)."""

    def counts(so, gt):
        tp = (so * gt).sum(axis=1)
        fn = ((1 - so) * gt).sum(axis=1)
        fp = (so * (1 - gt)).sum(axis=1)
        return tp, fp, fn

    tp_a, fp_a, fn_a = counts(so_a, gt_a)
    tp_v, fp_v, fn_v = counts(so_v, gt_v)
    tp_av, fp_av, fn_av = counts(so_av, gt_av)
    f_a = _f1_per_class(tp_a, fp_a, fn_a)
    f_v = _f1_per_class(tp_v, fp_v, fn_v)
    f_joint = _f1_per_class(tp_a + tp_v, fp_a + fp_v, fn_a + fn_v)
    f_av = _f1_per_class(tp_av, fp_av, fn_av)
    return f_a, f_v, f_joint, f_av


def extract_events(seq: np.ndarray) -> List[Tuple[int, int]]:
    """Contiguous [start, end) runs of 1s in a binary (T,) sequence."""
    events = []
    t = 0
    T = len(seq)
    while t < T:
        if seq[t] == 1:
            start = t
            while t < T and seq[t] == 1:
                t += 1
            events.append((start, t))
        else:
            t += 1
    return events


def _match_events(pred: List[Tuple[int, int]], gt: List[Tuple[int, int]],
                  T: int) -> Tuple[int, int, int]:
    """TP/FP/FN with IoU >= 0.5 interval matching (each pred may match any gt)."""

    def vec(ev):
        x = np.zeros(T)
        x[ev[0]: ev[1]] = 1
        return x

    tp = fp = fn = 0
    for p in pred:
        xp = vec(p)
        if any((xp * vec(g)).sum() >= 0.5 * np.maximum(xp, vec(g)).sum() for g in gt):
            tp += 1
        else:
            fp += 1
    for g in gt:
        xg = vec(g)
        if not any((xg * vec(p)).sum() >= 0.5 * np.maximum(xg, vec(p)).sum() for p in pred):
            fn += 1
    return tp, fp, fn


def event_level(
    so_a: np.ndarray, so_v: np.ndarray, so_av: np.ndarray,
    gt_a: np.ndarray, gt_v: np.ndarray, gt_av: np.ndarray,
) -> Tuple[float, float, float, float]:
    """Event-level F1 with IoU-0.5 matching of contiguous intervals."""
    n = so_a.shape[0]
    tp = {k: np.zeros(n) for k in "av joint only_av".split()}
    counters = {}
    for key, so, gt in (("a", so_a, gt_a), ("v", so_v, gt_v), ("av", so_av, gt_av)):
        tps, fps, fns = np.zeros(n), np.zeros(n), np.zeros(n)
        T = so.shape[1]
        for c in range(n):
            t, f, m = _match_events(extract_events(so[c]), extract_events(gt[c]), T)
            tps[c], fps[c], fns[c] = t, f, m
        counters[key] = (tps, fps, fns)
    tp_a, fp_a, fn_a = counters["a"]
    tp_v, fp_v, fn_v = counters["v"]
    tp_av, fp_av, fn_av = counters["av"]
    f_a = _f1_per_class(tp_a, fp_a, fn_a)
    f_v = _f1_per_class(tp_v, fp_v, fn_v)
    f_joint = _f1_per_class(tp_a + tp_v, fp_a + fp_v, fn_a + fn_v)
    f_av = _f1_per_class(tp_av, fp_av, fn_av)
    return f_a, f_v, f_joint, f_av


class AVVPEvaluator:
    """Accumulates per-clip F1s and reports the reference's 10-number suite
    (ref printout: AVMOE/AVVP/main.py:212-238)."""

    def __init__(self):
        self.seg: Dict[str, List[float]] = {k: [] for k in ("a", "v", "joint", "av")}
        self.event: Dict[str, List[float]] = {k: [] for k in ("a", "v", "joint", "av")}

    def add_clip(
        self,
        global_prob: np.ndarray,    # (25,) weak-label probs
        a_frame_prob: np.ndarray,   # (10, 25)
        v_frame_prob: np.ndarray,   # (10, 25)
        gt_a: np.ndarray,           # (25, 10) binary
        gt_v: np.ndarray,           # (25, 10) binary
    ) -> None:
        o = (global_prob >= 0.5).astype(np.int64)  # (25,)
        pa = (a_frame_prob >= 0.5).astype(np.int64) * o[None, :]  # (10, 25)
        pv = (v_frame_prob >= 0.5).astype(np.int64) * o[None, :]
        so_a, so_v = pa.T, pv.T
        so_av = so_a * so_v
        gt_av = gt_a * gt_v
        for store, fn in ((self.seg, segment_level), (self.event, event_level)):
            f_a, f_v, f_joint, f_av = fn(so_a, so_v, so_av, gt_a, gt_v, gt_av)
            store["a"].append(f_a)
            store["v"].append(f_v)
            store["joint"].append(f_joint)
            store["av"].append(f_av)

    def summary(self) -> Dict[str, float]:
        def pct(xs):
            return 100.0 * float(np.mean(xs)) if xs else 0.0

        seg_a, seg_v, seg_av = pct(self.seg["a"]), pct(self.seg["v"]), pct(self.seg["av"])
        ev_a, ev_v, ev_av = pct(self.event["a"]), pct(self.event["v"]), pct(self.event["av"])
        return {
            "seg_a": seg_a,
            "seg_v": seg_v,
            "seg_av": seg_av,
            "seg_type_avg": (seg_a + seg_v + seg_av) / 3.0,
            "seg_event_avg": pct(self.seg["joint"]),
            "event_a": ev_a,
            "event_v": ev_v,
            "event_av": ev_av,
            "event_type_avg": (ev_a + ev_v + ev_av) / 3.0,
            "event_event_avg": pct(self.event["joint"]),
        }
