"""What the per-layer metric readers (``metrics/<name>.py``) read: the
window's host spans and the traced stretch, with the frozen counts and the
device's peaks. A reader takes a :class:`LayerData` and returns a number, or
None where it finds nothing to read."""

from __future__ import annotations

import dataclasses
import json
import os

import torch

from port_bench.harness.cells import BENCH_DIR, Cell
from port_bench.harness.counts import launch_cost
from port_bench.reference.tasks import make_task


def device_peaks(kind: str):
    """The peaks of a device kind from ``harness/peaks.json``, or None."""
    with open(os.path.join(BENCH_DIR, "harness", "peaks.json")) as f:
        return json.load(f)["devices"].get(kind)


@dataclasses.dataclass
class LayerData:
    step_s: list  # the window's control steps, seconds each
    enqueue_s: list  # host seconds inside control_step, each step
    readback_s: list  # host seconds from control_step's return to the readback's end
    traced: object  # TracedStretch
    launch_ops: list  # (operations, bytes) of each physics launch of the stretch
    peaks: dict  # {"flops_per_s": ..., "bytes_per_s": ...} or None

    @classmethod
    def from_run(cls, run, cell: Cell, kind: str) -> "LayerData":
        model = make_task(cell.config["config"], "cpu", torch.float32).sys
        cost = {}
        for launch in run.traced.physics_launches:
            if launch not in cost:
                cost[launch] = launch_cost(model, *launch)
        return cls(
            step_s=run.step_s, enqueue_s=run.enqueue_s, readback_s=run.readback_s,
            traced=run.traced, launch_ops=[cost[x] for x in run.traced.physics_launches],
            peaks=device_peaks(kind),
        )

    def physics_device_s(self) -> float:
        return sum(o.end - o.start for o in self.traced.ops if o.in_physics)

    def least_physics_s(self):
        """The least time of the stretch's physics launches at the device's
        peaks: each launch bound by its operations or its bytes."""
        if self.peaks is None:
            return None
        return sum(
            max(ops / self.peaks["flops_per_s"], nbytes / self.peaks["bytes_per_s"])
            for ops, nbytes in self.launch_ops
        )
