"""The arithmetic of the end-to-end metrics and of the device's busy time.

``LatencyRecorder`` is a copy of the port's ``utils/telemetry.py`` recorder
(percentiles by numpy's linear interpolation), kept here so that a change of
the program cannot change how the benchmark reads it.
"""

from __future__ import annotations

import numpy as np


class LatencyRecorder:
    def __init__(self):
        self.samples_ms: list[float] = []

    def add(self, seconds: float):
        self.samples_ms.append(seconds * 1000.0)

    def summary(self) -> dict:
        if not self.samples_ms:
            return {}
        a = np.asarray(self.samples_ms)
        return {
            "n": int(a.size),
            "mean_ms": float(a.mean()),
            "p50_ms": float(np.percentile(a, 50)),
            "p90_ms": float(np.percentile(a, 90)),
            "p99_ms": float(np.percentile(a, 99)),
            "max_ms": float(a.max()),
        }


def window_ms_per_step(window_s: float, steps: int) -> float:
    """The window's seconds x 1000 over the control steps completed in it."""
    if steps < 1:
        raise ValueError("no control step completed in the window")
    return window_s * 1000.0 / steps


def union_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, start: float, end: float):
    """The gaps in [start, end] that no interval covers, as (start, end)."""
    gaps, cur = [], start
    for s, e in sorted(intervals):
        if s > cur:
            gaps.append((cur, min(s, end)))
        cur = max(cur, e)
        if cur >= end:
            break
    if cur < end:
        gaps.append((cur, end))
    return [(s, e) for s, e in gaps if e > s]
