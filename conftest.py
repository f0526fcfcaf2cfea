"""The shared running of tests/: one list of slow tests, a time limit for every
test, the port's tests first, and one torch thread.

pytest loads this file before tests/conftest.py (which sets up JAX). Its hooks
act only on the tests under tests/, so port_bench/tests runs as its own
conftest sets it up.
"""

import os
import signal
import threading
from typing import NamedTuple

import pytest

TESTS = "tests/"


class Slow(NamedTuple):
    seconds: int  # cold, on an 8-core CPU without .jax_cache, other test processes sharing the cores
    why: str
    limit: int | None = None  # the test's time limit where DEFAULT_TIMEOUT is too short
    estimated: bool = False  # not run to its end: `seconds` is an estimate from the tests beside it


# node id -> Slow. `-m 'not slow'` deselects these, `-m slow` runs them.
# tests/test_conftest_slow.py holds the keys to the collected node ids.
SLOW = {
    # the JAX package's own tests (cold XLA:CPU compiles of the reference)
    **{f"tests/test_behavior.py::{name}": Slow(
        seconds, "a closed loop of the JAX planner, Nsample 128, 50-150 steps", 1800, estimated)
       for name, seconds, estimated in (
        ("test_go2_trot_tracks_commanded_velocity", 268, False), ("test_go2_seq_jump_advances_stages", 284, False),
        ("test_h1_loco_stays_upright", 269, False), ("test_go2_crate_climb_gains_height", 537, False),
        ("test_h1_jog_tracks_forward_velocity", 600, True), ("test_h1_push_crate_displaces_crate", 600, True),
        ("test_allegro_spins_ball_about_z", 600, True))},
    **{f"tests/test_envs.py::test_env_reset_step[{env}]": Slow(
        seconds, "the JAX env's reset and step jitted", 1800, estimated)
       for env, seconds, estimated in (
        ("allegro_reorient", 532, False), ("unitree_go2_crate_climb", 210, False),
        ("unitree_go2_seq_jump", 111, False), ("unitree_go2_walk", 98, False), ("unitree_h1_loco", 100, False),
        ("unitree_h1_push_crate", 497, False), ("unitree_h1_walk", 500, True))},
    **{f"tests/test_golden.py::test_golden_trajectory[{case}]": Slow(
        seconds, "a planner program of the JAX package", 2400, estimated)
       for case, seconds, estimated in (
        ("unitree_go2_trot", 219, False), ("unitree_go2_seq_jump", 250, False),
        ("unitree_go2_crate_climb", 421, False), ("unitree_h1_jog", 674, False), ("unitree_h1_loco", 201, False),
        ("unitree_h1_push_crate", 600, True), ("allegro_reorient", 600, True))},
    "tests/test_deploy.py::test_publisher_sharded_mesh": Slow(135, "the JAX publisher's planner programs", 600),
    "tests/test_deploy.py::test_publisher_no_retrace_and_steady_state_latency": Slow(
        108, "the JAX publisher's planner programs", 600),
    # its own mark: timeout(600)
    "tests/test_deploy.py::test_sim2sim_sync_integration": Slow(51, "the JAX publisher beside a sim server process"),
    # its own mark: timeout(900)
    "tests/test_multihost.py::test_two_process_mesh_matches_single_process": Slow(
        303, "two JAX processes on one mesh; its waits have no common deadline and leave the workers running "
        "when they run out"),
    "tests/test_runner.py::test_runner_end_to_end": Slow(167, "the JAX runner end to end", 600),
    **{f"tests/test_planner.py::{name}": Slow(seconds, "control steps of the JAX planner", 600)
       for name, seconds in (("test_control_step_deterministic", 185),
                             ("test_control_step_freezes_on_divergence", 147),
                             ("test_reverse_once_improves_plan_reward", 78),
                             ("test_all_nonfinite_rollouts_keep_plan", 59))},
    **{f"tests/test_rewards.py::{name}": Slow(seconds, "the JAX env's step and reward stack jitted", 300)
       for name, seconds in (("test_go2_walk_reward_oracle[0]", 35), ("test_go2_walk_reward_oracle[7]", 35),
                             ("test_go2_seq_jump_contact_reward_oracle", 53),
                             ("test_go2_crate_contact_window_oracle", 41))},
    **{f"tests/test_rewards_h1.py::{name}": Slow(seconds, "the JAX env's step and reward stack jitted", 600)
       for name, seconds in (("test_h1_walk_reward_oracle[0]", 119), ("test_h1_walk_reward_oracle[5]", 119),
                             ("test_h1_push_crate_contact_oracle", 190))},
    **{f"tests/test_physics_smooth.py::test_smooth_dynamics_matches_mujoco[{i}-{scene}]": Slow(
        seconds, "the JAX forward jitted for the scene", 300) for i in (0, 1) for scene, seconds in (
        ("unitree_h1/mjx_scene_h1_walk.xml", 68), ("unitree_h1/mjx_scene_h1_push_crate.xml", 78),
        ("wonik_allegro/scene_left.xml", 36))},
    **{f"tests/test_physics_contact.py::{name}": Slow(seconds, "the JAX step jitted for the scene", 600)
       for name, seconds in (
        ("test_contact_forward_matches_mujoco[0-unitree_h1/mjx_scene_h1_walk.xml]", 105),
        ("test_contact_forward_matches_mujoco[1-unitree_h1/mjx_scene_h1_walk.xml]", 105),
        ("test_step_trajectory_matches_mujoco[unitree_go2/mjx_scene_force.xml]", 37),
        ("test_step_trajectory_matches_mujoco[unitree_h1/mjx_scene_h1_walk.xml]", 136),
        ("test_step_trajectory_matches_mujoco[unitree_h1/mjx_scene_h1_loco.xml]", 35),
        ("test_crate_scene_box_rests_on_floor[unitree_go2/mjx_scene_force_crate.xml]", 105),
        ("test_crate_scene_box_rests_on_floor[unitree_h1/mjx_scene_h1_push_crate.xml]", 183))},
    "tests/test_physics_elliptic.py::test_allegro_smooth_dynamics": Slow(107, "the JAX Allegro step jitted", 600),
    **{f"tests/test_engine_kernel.py::{kernel}[{scene}]": Slow(
        502, "the JAX package's Pallas step kernel in interpret mode", 1800, True)
       for kernel in ("test_engine_kernel_matches_xla", "test_engine_kernel_lanes2d_matches_xla")
       for scene in ("unitree_go2/mjx_scene_force.xml", "unitree_go2/mjx_scene_force_crate.xml",
                     "unitree_h1/mjx_scene_h1_walk.xml", "unitree_h1/mjx_scene_h1_push_crate.xml",
                     "unitree_h1/mjx_scene_h1_loco.xml", "wonik_allegro/scene_left.xml")},
    **{f"tests/test_engine_kernel.py::{name}": Slow(
        502, "the JAX package's Pallas step kernel in interpret mode", 1800, True)
       for name in ("test_elliptic_long_rollout_parity", "test_fused_multistep_matches_sequential[0]",
                    "test_fused_multistep_matches_sequential[2]", "test_unbatched_core_matches_xla[0]",
                    "test_unbatched_core_matches_xla[2]")},
    # the one of these run to its end; the others are estimated at its seconds
    "tests/test_engine_kernel.py::test_engine_kernel_matches_xla[unitree_go2/mjx_scene_force.xml]": Slow(
        502, "the JAX package's Pallas step kernel in interpret mode", 1800),
    "tests/test_pallas.py::test_pallas_solver_matches_xla": Slow(
        171, "the JAX package's Pallas solver in interpret mode", 600),
    "tests/test_sharded.py::test_mesh_shape_invariance": Slow(298, "the JAX ShardedMBDPI on the 8-device mesh", 1200),
    "tests/test_sharded.py::test_sharded_pallas_kernel_matches_xla": Slow(
        700, "the JAX ShardedMBDPI with the Pallas kernels in interpret mode: stopped after 700 s at 30 GB", 2400,
        True),
    "tests/test_sharded.py::test_sharded_plan_is_finite_and_nontrivial": Slow(
        300, "the JAX ShardedMBDPI on the 8-device mesh (its module's set-up, as the first test's)", 1200, True),
    # the stored JAX outputs made anew and held bit for bit (tests/reference_utils.py)
    **{f"tests/test_torch_reference_data.py::test_stored_reference_is_bit_equal_to_the_jax_package[{name}]": Slow(
        seconds, "computes the stored file again from the JAX package", 1200) for name, seconds in (
        ("deploy_schedule", 160), ("parallel_sharded", 107), ("physics_allegro", 169), ("physics_go2", 65),
        ("physics_go2_crate", 110), ("physics_h1_loco", 57), ("physics_h1_push_crate", 255), ("physics_h1_walk", 179),
        ("planner_float64_unitree_go2_crate_climb", 385), ("planner_float64_unitree_h1_loco", 183),
        ("planner_seq_jump_reset", 35), ("solver_elliptic", 24), ("solver_go2_rows", 110), ("solver_synthetic", 35))},
    # the port's tests
    "tests/test_torch_physics.py::test_step_core_reference_matches_pallas_interpret": Slow(
        346, "the JAX package's Pallas step kernel in interpret mode at float64", 1200),
    "tests/test_torch_solver.py::test_plain_step_matches_jax_step_on_pallas_solver": Slow(
        133, "the JAX step with the Pallas solver in interpret mode", 600),
    "tests/test_torch_envs.py::test_allegro_golden_physics_steps": Slow(
        186, "two control steps of the port's Allegro planner on the CPU (its 8 x 8 Newton chain, eager); "
        "test_step_trajectory_matches_jax[allegro] still holds its physics to the reference, "
        "test_allegro_step_matches_jax_on_replayed_data its reward, chip_smoke.py phase 4 its planner", 600),
    "tests/test_torch_envs.py::test_allegro_first_control_step_matches_float64_reference": Slow(
        688, "the reference's Allegro env jitted in float32 and float64 in a process of its own, fed the "
        "port's controls; test_allegro_golden_physics_steps and chip_smoke.py phase 4 still run the task", 2400),
    **{f"tests/test_torch_physics.py::test_float32_flips_are_the_references_own[{key}]": Slow(
        seconds, "the port's plain step at chip_smoke.py's B = 2049 on the CPU, float32 and float64; "
        "chip_smoke.py holds the same departures on the card", 1200) for key, seconds in (
        ("h1_walk", 232), ("go2_crate", 153), ("h1_push_crate", 335), ("allegro", 327))},
}

# seconds a test's setup, call or teardown may take, unless the test carries
# pytest.mark.timeout(seconds) (or its SLOW entry a limit): about three times
# the slowest not-slow test cold on a loaded 8-core CPU (45 s)
DEFAULT_TIMEOUT = 150

# the port's tests run first, the JAX package's own after them: a run cut by
# its time limit then loses the reference's tests, not the port's
PORT_FIRST = ("tests/test_torch_", "tests/test_conftest_")


def _runs_only_tests(config):
    root = str(config.rootpath / TESTS)
    return all(os.path.join(os.path.abspath(arg.split("::")[0]), "").startswith(root) for arg in config.args)


def pytest_configure(config):
    # the port's CPU physics at the tests' batches is launch-bound: torch's
    # pool of a thread a core makes it several times slower than one thread.
    # Set before a test module imports torch; the processes tests start
    # inherit it.
    if _runs_only_tests(config):
        os.environ.setdefault("OMP_NUM_THREADS", "1")


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    ours = [i for i, item in enumerate(items) if item.nodeid.startswith(TESTS)]
    for i in ours:
        slow = SLOW.get(items[i].nodeid)
        if slow is not None:
            items[i].add_marker(pytest.mark.slow)
            if slow.limit is not None and items[i].get_closest_marker("timeout") is None:
                items[i].add_marker(pytest.mark.timeout(slow.limit))
    ordered = sorted((items[i] for i in ours), key=lambda item: not item.nodeid.startswith(PORT_FIRST))
    for i, item in zip(ours, ordered):
        items[i] = item


def _limited(item, when):
    if not item.nodeid.startswith(TESTS) or threading.current_thread() is not threading.main_thread():
        return (yield)
    mark = item.get_closest_marker("timeout")
    limit = float(mark.args[0]) if mark else DEFAULT_TIMEOUT

    def expire(signum, frame):
        pytest.fail(f"{item.nodeid}: {when} ran past its time limit of {limit:g} s", pytrace=False)

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, limit)
    try:
        return (yield)
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    return (yield from _limited(item, "setup"))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    return (yield from _limited(item, "call"))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item):
    return (yield from _limited(item, "teardown"))
