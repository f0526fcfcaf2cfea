"""The readings the correctness limits are set from, at a cell's own size.

    python3 port_bench/control.py --workload <name> --seconds <s> --seeds <n> ...
        [--control-seeds <n> ...] [--out <file.jsonl>]

For each seed, one run of the cell (a window of ``--seconds``) gives the
program's readings: its numbers compared against the float64 reference. For
each control seed, the control then stands in the program's place: the
reference itself, computed in the precision next below the configuration's
on the same checked steps, judged by the same comparison: TF32 for the
planner's matrix products (float32 with TF32 off in the configuration), and
bfloat16 for the physics (float32 on CUDA cores, where TF32 does not apply).
The limits of ``limits/<workload>.json`` lie between the two: above the
program's largest reading, below the control's smallest. One JSON line per
reading is printed (and appended to ``--out``). Needs a CUDA device.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


CONTROLS = {
    # the planner's matrix products run in float32 with TF32 off: TF32
    "tf32": (torch.float32, True),
    # the physics kernel computes in float32 on CUDA cores, where TF32 does
    # not apply: bfloat16
    "bf16": (torch.bfloat16, False),
}


def _tf32(on: bool):
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def control_readings(run, seed, device, control="tf32"):
    """The readings of a control on the run's executed and checked steps:
    the reference put in the program's place, all of it computed at the
    control's precision, judged as the program is."""
    from port_bench.harness.check import Judge, worst
    from port_bench.harness.loop import draw_eps

    dtype, tf32 = CONTROLS[control]
    n_sample = int(run.config["Nsample"])
    judge = Judge(run.config, n_sample, device)
    stand_in = Judge(run.config, n_sample, device, dtype=dtype)
    _tf32(tf32)
    try:
        r = stand_in.task.reset().data
    finally:
        _tf32(False)
    _tf32(tf32)
    try:
        executed = stand_in.executed_outputs(run.executed)
    finally:
        _tf32(False)
    readings = [{"reset": judge.reset_gap(r.qpos, r.qvel, r.x_pos)}, judge.advance_readings(executed)]
    for rec in run.checked:
        shape = (rec.n_diffuse, n_sample, rec.Y_in.shape[0], rec.Y_in.shape[1])
        eps = draw_eps(seed, rec.draw, shape, device, torch.float32)
        _tf32(tf32)
        try:
            out = stand_in.outputs(rec, eps)
        finally:
            _tf32(False)
        readings.append(judge.readings(out, eps))
    return worst(readings)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--controls", nargs="+", default=sorted(CONTROLS), choices=sorted(CONTROLS))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    os.environ["DIAL_MPC_BUILD_DIR"] = os.path.join(BENCH_DIR, ".build")
    sys.path.insert(0, ROOT)

    from port_bench.harness.cells import find_cell
    from port_bench.harness.loop import run_cell

    if not torch.cuda.is_available():
        raise SystemExit("control.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = find_cell(args.workload)

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    for seed in args.seeds + [s for s in args.control_seeds if s not in args.seeds]:
        t0 = time.perf_counter()
        run = run_cell(cell, seed, args.seconds, False, t0, device="cuda")
        t1 = time.perf_counter()
        emit({"workload": cell.name, "side": "program", "seed": seed, "readings": run.readings,
              "steps": len(run.step_s), "checked_t": [r.t for r in run.checked],
              "run_s": t1 - t0, "window_s": run.window_s, "failed": run.failed})
        if seed in args.control_seeds:
            for control in args.controls:
                t1 = time.perf_counter()
                readings = control_readings(run, seed, torch.device("cuda"), control)
                emit({"workload": cell.name, "side": f"control_{control}", "seed": seed, "readings": readings,
                      "seconds": time.perf_counter() - t1})


if __name__ == "__main__":
    main()
