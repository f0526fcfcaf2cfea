"""One run of a cell: set-up, warm-up, the measured window of the closed
loop, the traced stretch (``--trace 1``, after the window) and the
correctness check.

The loop is the port's synchronous runner (``core/runner.py::run``): each
control step is ``MBDPI.control_step`` followed by the one readback
``pack_telemetry(...).cpu()``, and an episode is the configuration's
``n_steps`` control steps from the task's reset, the first of them with
``Ndiffuse_init`` levels. After an episode the loop starts the next from the
reset, inside the step that begins it, as a user's next run would; so it
does after a failed step, whose robot state the program froze or which
came back blown up (the step's own readback shows it), since the rest of
that episode would plan from a state that no longer moves. The harness
draws each step's standard-normal noise itself, from the run's seed
and the step's index in the run, and hands it to the planner
(``control_step(..., eps=)``), so that the reference can be given the same
draws.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from port_bench.harness.cells import Cell
from port_bench.harness.check import EXPLODED, Executed, Judge, StepRecord, verdict, worst

WARMUP_STEPS = 3  # the first step (Ndiffuse_init levels) and two of Ndiffuse


def step_seed(seed: int, t: int) -> int:
    """The seed of the draws of the run's control step t (warm-up included):
    any whole seed, 64 bits out."""
    state = np.random.SeedSequence([seed % (1 << 64), t]).generate_state(2, np.uint32)
    return int(state[0]) << 31 | int(state[1]) >> 1


def draw_eps(seed: int, t: int, shape, device, dtype) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(step_seed(seed, t))
    return torch.randn(shape, generator=g, device=device, dtype=dtype)


def planner_config(cell: Cell) -> dict:
    """The configuration as run: the task's flat config, with the planner
    settings the traffic sets (its samples a level)."""
    cfg = dict(cell.config["config"])
    cfg.update(cell.traffic.get("planner", {}))
    return cfg


@dataclasses.dataclass
class Run:
    setup_s: float
    window_s: float  # the window's seconds, less the harness's copies of the checked steps
    step_s: list  # each window step's seconds, start to the end of its readback
    step_t: list  # each window step's index in its episode (0: an episode's first)
    enqueue_s: list  # inside control_step
    readback_s: list  # from control_step's return to the end of the readback
    failed: int
    memory_peak_bytes: int
    traced: object  # TracedStretch or None
    readings: dict
    limits_rows: list
    correct: bool
    checked: list  # the StepRecords checked, on the host
    executed: Executed  # the executed step of every window step that did not fail, on the host
    config: dict  # the configuration as run
    check_s: float  # seconds the correctness check took, after the window


def failed_steps(light: list) -> torch.Tensor:
    """Per window step, whether it failed: the program froze the robot's
    advance (the state did not advance in time: the physics step diverged),
    or the state or the plan came back non-finite or past EXPLODED."""
    if not light:
        return torch.zeros(0, dtype=torch.bool)
    t_in = torch.stack([ps_in.time.reshape(-1)[0] for _, _, ps_in, _, _, _ in light])
    t_out = torch.stack([ps_out.time.reshape(-1)[0] for _, _, _, ps_out, _, _ in light])
    out = torch.stack([
        torch.cat([ps_out.qpos.reshape(-1), ps_out.qvel.reshape(-1), Y_out.reshape(-1)])
        for _, _, _, ps_out, _, Y_out in light
    ])
    sane = (torch.isfinite(out) & (out.abs() < EXPLODED)).all(-1)
    return ((t_out <= t_in) | ~sane).cpu()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
             device="cuda", faults=None) -> Run:
    """Run the cell once. ``t_start`` is the process's start on the
    ``time.perf_counter`` clock. ``faults`` (tests only) patches the planner
    and env after they are built, to break the timed path on purpose."""
    import dial_mpc_tpu_torch.envs as dial_envs
    from dial_mpc_tpu_torch.core.dial_config import DialConfig
    from dial_mpc_tpu_torch.core.dial_core import MBDPI
    from dial_mpc_tpu_torch.core.runner import pack_telemetry
    from dial_mpc_tpu_torch.utils.io_utils import load_dataclass_from_dict

    device = torch.device(device)
    dtype = torch.float32
    cfg = planner_config(cell)
    dial_config = load_dataclass_from_dict(DialConfig, cfg)
    env_config = load_dataclass_from_dict(
        dial_envs.get_config(dial_config.env_name), cfg, convert_list_to_array=True, device=device, dtype=dtype
    )
    env = dial_envs.get_environment(dial_config.env_name, env_config, device=device, dtype=dtype, engine="fused")
    mbdpi = MBDPI(dial_config, env)
    if faults is not None:
        faults(mbdpi, env)
    n_frames = int(round(float(cfg["dt"]) / float(cfg["timestep"])))
    nu = mbdpi.nu
    eps_shape = lambda nd: (nd, dial_config.Nsample, dial_config.Hnode + 1, nu)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    peak = (lambda: int(torch.cuda.max_memory_allocated(device))) if on_card else (lambda: 0)

    generator = torch.Generator(device=device).manual_seed(step_seed(seed, 1 << 40))
    state = env.reset(generator)
    reset = (state.pipeline_state.qpos, state.pipeline_state.qvel, state.pipeline_state.x_pos)
    Y0 = torch.zeros(dial_config.Hnode + 1, mbdpi.nu, device=device, dtype=dtype)
    episode = int(dial_config.n_steps)
    loop = {"state": state, "Y": Y0, "t": 0, "g": 0}

    nx = state.pipeline_state.qpos.shape[-1] + state.pipeline_state.qvel.shape[-1]
    loop["last"] = None  # the robot's state as the last readback gave it

    def step(light=None, spans=None, calls=None):
        """One control step. ``light`` collects each step's (t, draw, input
        and output pipeline state, input and output plan); ``calls``, where
        given, each call of the env's physics step (its state, its control,
        its products). Returns the step's end and (levels, plan in, plan
        out, info, whether it failed by its readback)."""
        if calls is not None:
            inner = env.pipeline_step

            def pipeline_step(d, ctrl):
                out = inner(d, ctrl)
                calls.append((d.qpos, d.qvel, ctrl, out))
                return out

            env.pipeline_step = pipeline_step  # the instance's, for this step alone
        t0 = time.perf_counter()
        if loop["t"] == episode:
            loop.update(state=env.reset(generator), Y=Y0, t=0, last=None)
        t, g = loop["t"], loop["g"]
        nd = dial_config.Ndiffuse_init if t == 0 else dial_config.Ndiffuse
        s_in, Y_in = loop["state"], loop["Y"]
        eps = draw_eps(seed, g, eps_shape(nd), device, dtype)
        t1 = time.perf_counter()
        s_out, Y_out, info = mbdpi.control_step(s_in, Y_in, nd, eps)
        t2 = time.perf_counter()
        x = pack_telemetry(s_out, Y_in[0], info).cpu().numpy()[:nx]
        t3 = time.perf_counter()
        last = loop["last"]
        broke = bool(not np.isfinite(x).all() or np.abs(x).max() >= EXPLODED
                     or (last is not None and np.array_equal(x, last)))
        if calls is not None:
            del env.pipeline_step
        if light is not None:
            light.append((t, g, s_in.pipeline_state, s_out.pipeline_state, Y_in, Y_out))
        if spans is not None:
            spans.append((t3 - t0, t2 - t1, t3 - t2))
        loop.update(state=s_out, Y=Y_out, t=episode if broke else t + 1, g=g + 1, last=x)
        return t3, (nd, Y_in, Y_out, info, broke)

    for _ in range(WARMUP_STEPS):
        step()
    sync()
    setup_s = time.perf_counter() - t_start

    # the checked steps, drawn from the seed among the window's first
    # ``check_within``. A drawn step that cannot be judged (an episode's
    # first, a failed step, or one whose rollouts all blew up in the
    # program) passes its turn to the next step. Each checked step keeps
    # its physics calls, which leave the device after the step: the clock
    # stops while they do, and the memory peak leaves that step out, so
    # neither reads the check's copies
    rng = np.random.default_rng([seed % (1 << 64), 1])
    within = int(cell.traffic["check_within"])
    picked = set(rng.choice(within, size=min(int(cell.traffic["check_steps"]), within), replace=False).tolist())
    light, spans, checked = [], [], []
    due = 0  # drawn steps not yet checked
    mem = peak()
    paused = 0.0
    w0 = time.perf_counter()
    while True:
        due += len(light) in picked
        calls = [] if due else None
        if calls is not None:
            mem = max(mem, peak())
        end, (nd, Y_in, Y_out, info, broke) = step(light, spans, calls)
        if calls is not None:
            t, g = light[-1][:2]
            rollouts = nd * (dial_config.Nsample + 1)
            if t > 0 and not broke and int(info["n_dropped"].sum()) < rollouts:
                checked.append(StepRecord.of(t, g, nd, Y_in, Y_out, info, calls))
                due -= 1
            del calls, info
            if on_card:
                torch.cuda.reset_peak_memory_stats(device)
            paused += time.perf_counter() - end
        if end - w0 - paused >= seconds:
            break
    window_s = end - w0 - paused
    mem = max(mem, peak())

    # the traced stretch follows the window: the profiler's hooks would
    # slow the host in the steps after it
    traced = None
    if trace:
        from port_bench.harness.trace import trace_steps

        traced = trace_steps(env, n_frames, lambda: step(), int(cell.traffic["trace_steps"]))

    bad = failed_steps(light)
    failed = int(bad.sum())
    step_t = [r[0] for r in light]
    ok = [r for r, b in zip(light, bad.tolist()) if not b]
    rows = lambda xs: torch.cat(xs).detach().cpu() if xs else torch.zeros(0)  # B = 1 states -> (steps, n)
    executed = Executed(
        t=[r[0] for r in ok],
        qpos_in=rows([r[2].qpos for r in ok]), qvel_in=rows([r[2].qvel for r in ok]),
        Y_in=torch.stack([r[4] for r in ok]).detach().cpu() if ok else torch.zeros(0),
        qpos_out=rows([r[3].qpos for r in ok]), qvel_out=rows([r[3].qvel for r in ok]),
    )

    # everything of the program goes before the reference runs
    del light, ok, loop, state, mbdpi, env
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    c0 = time.perf_counter()
    judge = Judge(cfg, dial_config.Nsample, device)
    readings = [{"reset": judge.reset_gap(*reset)}, judge.advance_readings(executed)]
    for rec in checked:
        eps = draw_eps(seed, rec.draw, eps_shape(rec.n_diffuse), device, dtype)
        readings.append(judge.readings(rec, eps))
    readings = worst(readings)
    readings["steps_checked"] = float(len(checked))
    check_s = time.perf_counter() - c0
    correct, rows = verdict(readings, cell.limits)
    # a failed step is counted in ``failed`` (the plain reference's physics
    # diverges from the same state too: PERF.md, section 7), and is not
    # judged; every drawn step has to have been checked
    correct = correct and len(checked) == len(picked)
    return Run(
        setup_s=setup_s, window_s=window_s, step_s=[s[0] for s in spans], step_t=step_t,
        enqueue_s=[s[1] for s in spans], readback_s=[s[2] for s in spans], failed=failed,
        memory_peak_bytes=mem, traced=traced, readings=readings, limits_rows=rows, correct=correct,
        checked=checked, executed=executed, config=cfg, check_s=check_s,
    )
