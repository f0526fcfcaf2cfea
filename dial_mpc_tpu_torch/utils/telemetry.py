"""Solve-latency telemetry.

Every control-step latency is recorded; ``summary()`` reports the histogram
percentiles that matter for a real-time controller.
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
            "hz_p50": float(1000.0 / max(np.percentile(a, 50), 1e-9)),
        }

    def report(self, label: str = "solve") -> str:
        s = self.summary()
        if not s:
            return f"{label}: no samples"
        return (
            f"{label}: n={s['n']} p50={s['p50_ms']:.1f}ms "
            f"p90={s['p90_ms']:.1f}ms p99={s['p99_ms']:.1f}ms "
            f"max={s['max_ms']:.1f}ms ({s['hz_p50']:.1f} Hz median)"
        )
