"""The harness on the CPU: finding a cell's files by name, the arithmetic of
the metrics, the reduction of a trace, the frozen counts, and the refusals
of the command (no card, a checkout without the program, JAX loaded)."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from port_bench.harness import cells, stats
from port_bench.harness.cells import find_cell, load_benchmark, metric_reader
from port_bench.harness.layers import LayerData
from port_bench.harness.trace import reduce_trace

ROOT = cells.ROOT
BENCH = cells.BENCH_DIR


def test_every_cell_finds_its_files():
    bench = load_benchmark()
    for w in bench["workloads"]:
        cell = find_cell(w["name"], bench)
        assert cell.config["name"] == w["config"]
        assert cell.traffic["planner"]["Nsample"] > 0
        assert cell.limits, "a cell compares at least one number"
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        for m in cell.per_layer:
            assert callable(metric_reader(m["name"]))
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))


def test_a_new_cell_is_new_files_only(tmp_path):
    """A throwaway configuration of a new env (its reference task a new
    file), traffic mix, limits and metric, added as new files and a new
    workloads entry, are found without editing a file."""
    from port_bench.reference.tasks import make_task

    bench_dir = tmp_path / "port_bench"
    shutil.copytree(BENCH, bench_dir, ignore=shutil.ignore_patterns("__pycache__", ".build"))
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    bench = load_benchmark()
    cfg = json.loads((bench_dir / "configs" / "allegro_reorient.json").read_text())
    cfg["name"] = "allegro_spin_b"
    cfg["config"]["env_name"] = "allegro_spin_b"
    (bench_dir / "configs" / "allegro_spin_b.json").write_text(json.dumps(cfg))
    (bench_dir / "reference" / "tasks" / "allegro_spin_b.py").write_text(
        "from port_bench.reference.task import BaseTask\n"
        "from port_bench.reference.tasks import task_class\n\n\n"
        "class Task(task_class('allegro_reorient')):\n"
        "    def reset_info(self):\n"
        "        info = super().reset_info()\n"
        "        info['ang_vel_tar'] = -info['ang_vel_tar']\n"
        "        return info\n"
    )
    (bench_dir / "traffic" / "sync_n64.json").write_text(
        json.dumps({"why": "tiny", "planner": {"Nsample": 64}, "trace_steps": 1, "check_steps": 1, "check_within": 1})
    )
    (bench_dir / "limits" / "allegro_spin_b.sync_n64.json").write_text(
        json.dumps({"limits": {"plan": {"limit": 1e-4}}})
    )
    (bench_dir / "metrics" / "host.steps.py").write_text("def read(data):\n    return float(len(data.step_s))\n")
    bench["configs"].append(dict(bench["configs"][0], name="allegro_spin_b", file="port_bench/configs/allegro_spin_b.json"))
    bench["workloads"].append({"name": "allegro_spin_b.sync_n64", "config": "allegro_spin_b",
                               "traffic": "sync_n64", "chips": 1, "why": "a throwaway cell"})
    bench["per_layer"].append({"name": "host.steps", "unit": "steps", "better": "higher", "source": "host_clock",
                               "layer": "runner", "moves": "control_step_ms", "workloads": ["allegro_spin_b.sync_n64"]})
    cell = find_cell("allegro_spin_b.sync_n64", bench, str(bench_dir))
    assert cell.traffic["planner"]["Nsample"] == 64 and cell.limits == {"plan": {"limit": 1e-4}}
    assert "host.steps" in [m["name"] for m in cell.per_layer]
    assert metric_reader("host.steps", str(bench_dir))(LayerData([0.1, 0.2], [], [], None, [], None)) == 2.0
    task = make_task(cell.config["config"], "cpu", torch.float64, str(bench_dir / "reference" / "tasks"))
    assert task.reset().info["ang_vel_tar"].tolist() == [[0.0, 0.0, -0.5]]
    # the old cells do not report the new cell's metric
    assert "host.steps" not in [m["name"] for m in find_cell("allegro_reorient.sync_n2048", bench, str(bench_dir)).per_layer]
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"


def test_window_rate_and_p90_over_every_step():
    # 20 steps of 100 ms and one stall of 1 s: the rate takes the stall's
    # whole time, the p90 reads the tail of all 21 steps
    steps = [0.1] * 20 + [1.0]
    window = sum(steps)
    assert stats.window_ms_per_step(window, len(steps)) == pytest.approx(3000.0 / 21)
    rec = stats.LatencyRecorder()
    for s in steps:
        rec.add(s)
    assert rec.summary()["p90_ms"] == pytest.approx(100.0)
    steps = [0.1] * 8 + [0.5, 1.0]
    rec = stats.LatencyRecorder()
    for s in steps:
        rec.add(s)
    assert rec.summary()["p90_ms"] == pytest.approx(550.0)  # numpy's linear interpolation
    with pytest.raises(ValueError):
        stats.window_ms_per_step(1.0, 0)


def test_union_and_idle_share_with_a_stall():
    busy = [(0.0, 1.0), (0.5, 2.0), (2.0, 2.5), (4.0, 5.0)]  # a stall of 1.5 s between 2.5 and 4
    assert stats.union_seconds(busy) == pytest.approx(3.5)
    assert stats.idle_gaps(busy, 0.0, 6.0) == [(2.5, 4.0), (5.0, 6.0)]
    assert stats.idle_gaps(busy, -1.0, 4.5) == [(-1.0, 0.0), (2.5, 4.0)]


def _trace():
    """Two control steps; each launches a physics kernel inside a physics span
    and one glue kernel outside it; step 2's physics has no launch record
    and is placed by its device-side range."""
    us = lambda s: s * 1e6
    ev = []
    add = lambda **k: ev.append(dict(ph="X", **k))
    for k, t in enumerate((0.0, 1.0)):
        add(cat="user_annotation", name="runner.step", ts=us(t), dur=us(0.9))
        add(cat="user_annotation", name="physics", ts=us(t + 0.1), dur=us(0.2))
        add(cat="cpu_op", name="aten::cat", ts=us(t + 0.5), dur=us(0.3))
        add(cat="cuda_runtime", name="cudaLaunchKernel", ts=us(t + 0.55), dur=us(0.01), args={"correlation": 10 * k + 2})
        add(cat="kernel", name="glue", ts=us(t + 0.6), dur=us(0.1), args={"correlation": 10 * k + 2})
        if k == 0:
            add(cat="cuda_runtime", name="cudaLaunchKernel", ts=us(t + 0.15), dur=us(0.01), args={"correlation": 1})
        add(cat="gpu_user_annotation", name="physics", ts=us(t + 0.2), dur=us(0.35))
        add(cat="kernel", name="engine_step_kernel", ts=us(t + 0.2), dur=us(0.3), args={"correlation": 10 * k + 1})
    return {"traceEvents": ev}


def test_trace_reduction():
    t = reduce_trace(_trace(), [(9, 4), (9, 4)], 2)
    assert t.steps == 2 and t.seconds == pytest.approx(1.9) and t.unattributed == 0
    phys = [o.name for o in t.ops if o.in_physics]
    assert phys == ["engine_step_kernel", "engine_step_kernel"]
    assert t.busy_seconds() == pytest.approx(0.8)
    data = LayerData([0.9, 0.9], [0.5, 0.5], [0.1, 0.1], t, [(67e9, 0), (67e9, 3.35e9)],
                     {"flops_per_s": 67e12, "bytes_per_s": 3.35e12})
    assert metric_reader("physics.device_ms")(data) == pytest.approx(300.0)
    assert metric_reader("env.kernels_per_step")(data) == 1.0
    assert metric_reader("device.idle_share")(data) == pytest.approx(1 - 0.8 / 1.9)
    # least time 1 ms + 1 ms against 600 ms of physics
    assert metric_reader("physics.step_roofline")(data) == pytest.approx(100 * 0.002 / 0.6)
    assert metric_reader("planner.enqueue_ms")(data) == pytest.approx(500.0)
    assert metric_reader("runner.readback_wait_ms")(data) == pytest.approx(100.0)
    assert t.top_device_ops(1) == [["engine_step_kernel", pytest.approx(0.6)]]
    # the longest gap runs from step 1's glue kernel (ends 0.7) to step 2's
    # physics kernel (1.2); at its middle the host was between the steps
    gaps = t.longest_idle_gaps(2)
    assert gaps[0] == ["host idle", pytest.approx(0.5)]
    # a device kind without peaks gives no roofline
    data.peaks = None
    assert metric_reader("physics.step_roofline")(data) is None
    with pytest.raises(RuntimeError):
        reduce_trace(_trace(), [], 3)


@pytest.mark.parametrize("config,scene", [
    ("allegro_reorient", ("wonik_allegro", "scene_left.xml")),
])
def test_frozen_counts_equal_the_ports(config, scene):
    from dial_mpc_tpu_torch.physics import engine_cuda
    from dial_mpc_tpu_torch.physics.compiled_model import load_scene
    from dial_mpc_tpu_torch.physics.model import put_model
    from port_bench.harness import counts
    from port_bench.reference.tasks import make_task

    cfg = json.load(open(os.path.join(BENCH, "configs", f"{config}.json")))["config"]
    ours = make_task(cfg, "cpu", torch.float32).sys
    cm = load_scene(*scene)
    cm.opt.timestep = cfg["timestep"]
    theirs = put_model(cm, "cpu", torch.float32)
    assert counts.step_flops(ours) == engine_cuda.step_flops(theirs)
    rows_in, rows_out = counts.io_rows(ours)
    assert rows_in == theirs.nq + theirs.nv + theirs.nu
    assert rows_out == sum(n for _, n in engine_cuda.out_specs(theirs))
    ops, nbytes = counts.launch_cost(ours, 2049, 4)
    assert ops == engine_cuda.step_flops(theirs) * 2049 * 4 and nbytes == (rows_in + rows_out) * 2049 * 4


def test_episodes_restart_from_the_reset():
    """After the configuration's n_steps control steps the loop starts the
    next episode from the reset; the draws stay keyed by the run's step."""
    import dataclasses
    import time

    from port_bench.harness.loop import run_cell

    torch.set_num_threads(min(4, torch.get_num_threads()))
    cell = find_cell("allegro_reorient.sync_n2048")
    small = {"Nsample": 4, "Hsample": 2, "Hnode": 2, "Ndiffuse": 1, "Ndiffuse_init": 1, "n_steps": 2}
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic, planner=small, check_steps=1, check_within=1),
                               limits={"plan": {"limit": 1e-5}})
    run = run_cell(cell, 2**31 + 5, 0.0, False, time.perf_counter(), device="cpu")
    # warm-up: t = 0, 1, then the next episode's 0; the window's one step is
    # that episode's second (without the restart it would be step 3)
    assert run.step_t == [1] and run.executed.t == [1]
    # the checked step is the window's first, after the 3 warm-up steps
    assert [(r.draw, r.t, r.n_diffuse) for r in run.checked] == [(3, 1, 1)]
    assert run.correct and run.failed == 0, run.limits_rows


def _run(cwd, *args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "port_bench/run.py", *args], cwd=cwd, capture_output=True, text=True, env=env, timeout=300
    )


def test_no_card_no_result():
    """Without a CUDA device the command exits non-zero and prints no result;
    it never falls back to the CPU."""
    r = _run(ROOT, "--workload", "allegro_reorient.sync_n2048", "--seed", "2147483699", "--seconds", "1", "--trace", "0")
    assert r.returncode != 0
    assert "correct" not in r.stdout
    assert "torch.cuda.is_available() is False" in r.stderr


def test_no_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's own
    files, the command exits non-zero and prints no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "port_bench", ignore=shutil.ignore_patterns("__pycache__", ".build"))
    r = _run(tmp_path, "--workload", "allegro_reorient.sync_n2048", "--seed", "5", "--seconds", "1", "--trace", "1")
    assert r.returncode != 0 and "correct" not in r.stdout
    assert "dial_mpc_tpu_torch" in r.stderr


def test_no_jax_after_the_harness_imports():
    """What run.py imports, the port and the reference included, loads no
    jax, jaxlib, flax or dial_mpc_tpu, by whole top-level names."""
    code = (
        "import sys, runpy; sys.path.insert(0, %r);"
        "m = runpy.run_path('port_bench/run.py');"
        "import port_bench.harness.loop, port_bench.harness.trace, port_bench.harness.layers, port_bench.control;"
        "import dial_mpc_tpu_torch.envs, dial_mpc_tpu_torch.core.dial_core, dial_mpc_tpu_torch.core.runner;"
        "print(m['forbidden_modules']())"
    ) % ROOT
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    import runpy

    forbidden_modules = runpy.run_path(os.path.join(BENCH, "run.py"))["forbidden_modules"]
    before = set(forbidden_modules())
    monkeypatch.setitem(sys.modules, "dial_mpc_tpu_torch", sys.modules.get("dial_mpc_tpu_torch", sys))
    monkeypatch.setitem(sys.modules, "jaxtyping", sys.modules.get("jaxtyping", sys))
    monkeypatch.setitem(sys.modules, "flaxen.core", sys)
    assert set(forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "dial_mpc_tpu.core", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys.modules.get("jaxlib", sys))
    assert set(forbidden_modules()) == before | {"dial_mpc_tpu", "jaxlib"}
