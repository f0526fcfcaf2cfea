"""The traced stretch: ``torch.profiler`` over whole control steps, with the
benchmark's own spans, reduced to what the per-layer metrics read.

Spans (``record_function``, from this harness only): ``runner.step`` around
each control step of the stretch, and ``physics`` around every call of the
env instance's ``pipeline_step``, which the harness wraps for the stretch
alone. A device operation belongs to the physics when the host call that
launched it (matched by the profiler's correlation id) lies inside a
``physics`` span; where the trace holds no launch record for it, when it
lies inside the span's device-side range.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile

from port_bench.harness.stats import idle_gaps, union_seconds

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class DeviceOp:
    name: str
    cat: str
    start: float  # seconds, on the trace's clock
    end: float
    in_physics: bool


@dataclasses.dataclass
class TracedStretch:
    steps: int
    start: float  # the first traced step's start, seconds
    end: float  # the last one's end
    ops: list  # DeviceOp
    physics_launches: list  # (batch, physics steps) of each pipeline_step call
    host_events: list  # (start, end, name) of the host thread's events, for naming gaps
    unattributed: int  # device ops with neither a launch record nor a device-side span

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def busy_seconds(self) -> float:
        return union_seconds([(max(o.start, self.start), min(o.end, self.end))
                              for o in self.ops if o.end > self.start and o.start < self.end])

    def top_device_ops(self, n=10):
        by = {}
        for o in self.ops:
            by[o.name] = by.get(o.name, 0.0) + (o.end - o.start)
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]

    def longest_idle_gaps(self, n=10):
        """The ``n`` longest stretches of the window in which the device ran
        nothing, each named by the innermost host event open at its middle
        (``host idle`` where none is)."""
        gaps = idle_gaps([(o.start, o.end) for o in self.ops], self.start, self.end)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        ev = sorted(self.host_events)
        out = []
        for s, e in gaps:
            mid = 0.5 * (s + e)
            inner = [h for h in ev if h[0] <= mid <= h[1]]
            name = max(inner)[2] if inner else "host idle"  # the latest to open
            out.append([name, e - s])
        return out


def _intervals(events, name):
    return sorted((e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0)) * 1e-6)
                  for e in events if e.get("name") == name and e.get("ph") == "X")


def _inside(spans, starts, t):
    k = bisect.bisect_right(starts, t) - 1
    return k >= 0 and spans[k][0] <= t <= spans[k][1]


def reduce_trace(trace: dict, physics_launches: list, steps: int) -> TracedStretch:
    """A chrome trace of the profiler (as ``export_chrome_trace`` writes it)
    -> the stretch's device operations with their layer."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    host = [e for e in events if e.get("cat") == "user_annotation"]
    step_spans = _intervals(host, "runner.step")
    if len(step_spans) != steps:
        raise RuntimeError(f"the trace holds {len(step_spans)} runner.step spans, expected {steps}")
    phys = _intervals(host, "physics")
    phys_starts = [s for s, _ in phys]
    dev_phys = sorted(
        (e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0)) * 1e-6)
        for e in events if e.get("cat") == "gpu_user_annotation" and e.get("name") == "physics"
    )
    dev_phys_starts = [s for s, _ in dev_phys]
    launch_ts = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = e["ts"] * 1e-6
    ops, unattributed = [], 0
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        start = e["ts"] * 1e-6
        end = start + e.get("dur", 0) * 1e-6
        corr = (e.get("args") or {}).get("correlation")
        if corr in launch_ts:
            in_phys = _inside(phys, phys_starts, launch_ts[corr])
        elif dev_phys:
            in_phys = _inside(dev_phys, dev_phys_starts, start)
        else:
            in_phys, unattributed = False, unattributed + 1
        ops.append(DeviceOp(e.get("name", "?"), e["cat"], start, end, in_phys))
    host_events = [
        (e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0)) * 1e-6, e.get("name", "?"))
        for e in events if e.get("cat") in HOST_CATS
    ]
    return TracedStretch(
        steps=steps, start=step_spans[0][0], end=step_spans[-1][1], ops=ops,
        physics_launches=list(physics_launches), host_events=host_events,
        unattributed=unattributed,
    )


def trace_steps(env, n_frames: int, do_step, steps: int) -> TracedStretch:
    """Run ``steps`` control steps (``do_step()`` each) under the profiler,
    with the spans above, and reduce the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    launches = []
    inner = env.pipeline_step

    def pipeline_step(d, ctrl):
        launches.append((int(d.qpos.shape[0]), n_frames))
        with record_function("physics"):
            return inner(d, ctrl)

    env.pipeline_step = pipeline_step  # the instance's, for the stretch alone
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                with record_function("runner.step"):
                    do_step()
            torch.cuda.synchronize()
    finally:
        del env.pipeline_step
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    return reduce_trace(trace, launches, steps)
