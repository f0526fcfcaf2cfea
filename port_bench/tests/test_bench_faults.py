"""A run of the harness with the timed path broken underneath comes out not
correct, once for each fault a cell of this benchmark can have; the same run
unbroken comes out correct.

The run skips the look for a card and runs the port's plain path on the CPU
(float32) at a small size: the Allegro cell, 64 samples a level, a horizon of
2 control steps. The numbers are held to the cell's own limits
(``limits/allegro_reorient.sync_n2048.json``). No cell of the benchmark
spans chips, so the fault of an exchange between chips left out has no place
here.
"""

import dataclasses
import time

import pytest
import torch

from port_bench.harness.cells import find_cell
from port_bench.harness.loop import run_cell

SMALL = {"Nsample": 64, "Hsample": 2, "Hnode": 2, "Ndiffuse": 1, "Ndiffuse_init": 1}
CELL = "allegro_reorient.sync_n2048"


def small_cell():
    cell = find_cell(CELL)
    return dataclasses.replace(cell, traffic=dict(cell.traffic, planner=SMALL, check_steps=1, check_within=1))


def state_unchanged(mbdpi, env):
    """The physics step returns its state as it was (the control recorded)."""
    env.pipeline_step = lambda d, ctrl: d.replace(ctrl=ctrl.to(d.qpos.dtype))


def half_unstepped(mbdpi, env):
    """The physics step leaves the first half of a batch's samples where
    they were (the batch of rollouts; the robot's own step is stepped)."""
    inner = env.pipeline_step

    def pipeline_step(d, ctrl):
        out = inner(d, ctrl)
        n = d.qpos.shape[0] // 2
        if n == 0:
            return out
        qpos, qvel = out.qpos.clone(), out.qvel.clone()
        qpos[:n], qvel[:n] = d.qpos[:n], d.qvel[:n]
        return out.replace(qpos=qpos, qvel=qvel)

    env.pipeline_step = pipeline_step


def advance_altered(mbdpi, env):
    """The robot's own state is altered where the executed step produces it:
    one joint of the hand moved by 0.01 rad."""
    inner = env.step

    def step(state, action):
        out = inner(state, action)
        if out.pipeline_state.qpos.shape[0] != 1:
            return out
        qpos = out.pipeline_state.qpos.clone()
        qpos[:, 10] += 0.01
        return out.replace(pipeline_state=out.pipeline_state.replace(qpos=qpos))

    env.step = step


def half_the_batch(mbdpi, env):
    """Each level's update takes the weighted mean over the first half of the
    samples only (and the mean plan's row), leaving the rest out."""
    inner = mbdpi.reverse_once

    def reverse_once(state, Ybar_i, noise_scale, eps=None):
        _, info = inner(state, Ybar_i, noise_scale, eps)
        Y0s = mbdpi.sample_nodes(Ybar_i, noise_scale, eps)
        rews = info["rews"]
        keep = torch.zeros_like(rews, dtype=torch.bool)
        keep[: rews.shape[0] // 2] = True
        keep[-1] = True
        r = rews[keep]
        logp = (r - r[-1]) / r.std(unbiased=False).clamp_min(1e-12) / mbdpi.args.temp_sample
        w = torch.softmax(logp, dim=0)
        return torch.einsum("n,nij->ij", w, Y0s[keep]), info

    mbdpi.reverse_once = reverse_once


def plan_altered(mbdpi, env):
    """One node of the plan is altered where the control step produces it."""
    inner = mbdpi.control_step

    def control_step(state, Y, n_diffuse, eps=None):
        state, Y, info = inner(state, Y, n_diffuse, eps)
        Y = Y.clone()
        Y[2, 3] = Y[2, 3] + 0.05 if Y[2, 3] < 0.9 else Y[2, 3] - 0.05
        return state, Y, info

    mbdpi.control_step = control_step


def _run(faults):
    torch.set_num_threads(min(4, torch.get_num_threads()))
    return run_cell(small_cell(), 2718281829, 0.0, False, time.perf_counter(), device="cpu", faults=faults)


def test_unbroken_run_is_correct():
    run = _run(None)
    assert run.correct, run.limits_rows
    assert run.failed == 0 and run.readings["steps_checked"] >= 1


@pytest.mark.parametrize(
    "fault", [state_unchanged, half_unstepped, advance_altered, half_the_batch, plan_altered], ids=lambda f: f.__name__
)
def test_broken_run_is_not_correct(fault):
    run = _run(fault)
    assert not run.correct, run.limits_rows
    if fault is not state_unchanged:  # a state left where it was is a failed step besides
        assert run.failed == 0


def test_a_diverged_step_is_failed_and_restarts_the_episode():
    """Where the robot's own step diverges (the program freezes its state),
    the step counts as failed, the next step starts a new episode, and the
    step drawn for the check passes its turn to the next one it can judge."""
    from port_bench.harness.loop import WARMUP_STEPS

    def diverges_once(mbdpi, env):
        inner, calls = env.step, []

        def step(state, action):
            out = inner(state, action)
            if out.pipeline_state.qpos.shape[0] == 1:
                calls.append(None)
                if len(calls) == WARMUP_STEPS + 1:  # the window's first step
                    qvel = torch.full_like(out.pipeline_state.qvel, float("nan"))
                    return out.replace(pipeline_state=out.pipeline_state.replace(qvel=qvel))
            return out

        env.step = step

    torch.set_num_threads(min(4, torch.get_num_threads()))
    cell = find_cell(CELL)
    tiny = dict(SMALL, Nsample=4)
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic, planner=tiny, check_steps=1, check_within=1))
    run = run_cell(cell, 2718281829, 45.0, False, time.perf_counter(), device="cpu", faults=diverges_once)
    assert run.failed == 1
    assert run.step_t[:3] == [3, 0, 1]  # the failed step, a new episode's first, its second
    assert [r.t for r in run.checked] == [1] and run.checked[0].draw == WARMUP_STEPS + 2
    assert run.correct, run.limits_rows
