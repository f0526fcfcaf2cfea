"""The benchmark of dial_mpc_tpu_torch: one run of one cell.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``BENCHMARK.json`` there names the cell; its
configuration, traffic mix, limits and per-layer metric readers are files
under ``port_bench/`` (see ``harness/cells.py``). The run needs as many CUDA
devices as the cell asks for and never falls back to the CPU. It prints, as
the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number the
correctness check compared, beside its limit. The same numbers end standard
error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "dial_mpc_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()


def fail(msg: str, code: int = 2):
    print(f"port_bench: {msg}", file=sys.stderr)
    sys.exit(code)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build of the program's kernels goes to one fixed directory of the
    # checkout, so only a cell's first run there compiles
    os.environ["DIAL_MPC_BUILD_DIR"] = os.path.join(BENCH_DIR, ".build")
    sys.path.insert(0, ROOT)

    from port_bench.harness.cells import find_cell, load_benchmark, metric_reader

    bench = load_benchmark(ROOT)
    cell = find_cell(args.workload, bench)
    try:
        import dial_mpc_tpu_torch  # noqa: F401  the system under test
    except ImportError as e:
        fail(f"the program is not in this checkout: {e}")

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this benchmark runs on CUDA devices only")
    if torch.cuda.device_count() < cell.chips:
        fail(f"the cell asks for {cell.chips} devices, torch.cuda.device_count() is {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from port_bench.harness import stats
    from port_bench.harness.loop import run_cell
    from port_bench.harness.layers import LayerData

    run = run_cell(cell, args.seed, args.seconds, bool(args.trace), T_START, device="cuda")
    found = forbidden_modules()
    if found:
        fail(f"modules of {found} were loaded in the benchmark's process")

    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": cell.chips,
        "memory_peak_bytes": run.memory_peak_bytes,
    }
    result = {"correct": run.correct, "attempted": len(run.step_s), "failed": run.failed}
    lines = [
        f"card: {card()}",
        f"window: {len(run.step_s)} control steps in {run.window_s} s, {run.step_t.count(0)} of them "
        f"an episode's first; set-up {run.setup_s} s; "
        f"check {run.check_s} s over {len(run.checked)} control steps",
    ]
    if args.trace:
        data = LayerData.from_run(run, cell, device["kind"])
        metrics = {}
        for m in cell.per_layer:
            value = metric_reader(m["name"])(data)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        device["busy_s"] = run.traced.busy_seconds()
        device["window_s"] = run.traced.seconds
        result["breakdown"] = {
            "device_ops": run.traced.top_device_ops(10),
            "idle_gaps": run.traced.longest_idle_gaps(10),
        }
        lines.append(f"traced stretch: {run.traced.steps} control steps in {run.traced.seconds} s, "
                     f"{len(run.traced.ops)} device operations, {run.traced.unattributed} without a launch record")
    else:
        latency = stats.LatencyRecorder()
        for s in run.step_s:
            latency.add(s)
        values = {
            "control_step_ms": stats.window_ms_per_step(run.window_s, len(run.step_s)),
            "control_step_p90_ms": latency.summary()["p90_ms"],
            "setup_s": run.setup_s,
        }
        lines.append(f"control_step_p90_ms over {len(run.step_s)} steps")
        result["metrics"] = {
            m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end
        }
    result["device"] = device
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in run.limits_rows}
    lines.append("not compared: " + ", ".join(
        f"{k} {v}" for k, v in run.readings.items() if k not in cell.limits))
    for line in lines:
        print(line, file=sys.stderr)
    for name, v, lim in run.limits_rows:
        print(f"check {name}: {v} (limit {lim})", file=sys.stderr)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
