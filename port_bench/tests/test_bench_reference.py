"""The frozen reference held to the port's plain path on the CPU in float64,
at a small batch, for the scene of every configuration: the reset, the physics step with the
task's reward, and one annealing level (rollouts, rewards and the
softmax-weighted update of the plan and of the body positions). The
reference itself imports nothing of the port."""

import json
import os
import subprocess
import sys

import pytest
import torch

from port_bench.harness.cells import BENCH_DIR, ROOT
from port_bench.reference.planner import Planner
from port_bench.reference.task import State
from port_bench.reference.tasks import make_task

F64 = torch.float64
CONFIGS = tuple(sorted(f[:-5] for f in os.listdir(os.path.join(BENCH_DIR, "configs")) if f.endswith(".json")))


def config(name, **planner):
    cfg = json.load(open(os.path.join(BENCH_DIR, "configs", f"{name}.json")))["config"]
    return dict(cfg, **planner)


def port_env(cfg):
    import dial_mpc_tpu_torch.envs as dial_envs
    from dial_mpc_tpu_torch.core.dial_config import DialConfig
    from dial_mpc_tpu_torch.utils.io_utils import load_dataclass_from_dict

    dc = load_dataclass_from_dict(DialConfig, cfg)
    ec = load_dataclass_from_dict(dial_envs.get_config(dc.env_name), cfg, convert_list_to_array=True, device="cpu", dtype=F64)
    return dc, dial_envs.get_environment(dc.env_name, ec, device="cpu", dtype=F64)


def expand(state, n):
    from dial_mpc_tpu_torch.envs.base_env import expand_state

    return expand_state(state, n)


@pytest.mark.parametrize("name", CONFIGS)
def test_physics_step_and_reward(name):
    torch.set_num_threads(min(4, torch.get_num_threads()))
    cfg = config(name)
    _, env = port_env(cfg)
    task = make_task(cfg, "cpu", F64)
    s0 = env.reset(torch.Generator().manual_seed(0))
    r0 = task.reset()
    for field in ("qpos", "qvel", "x_pos", "x_rot", "xd_vel", "site_xpos"):
        torch.testing.assert_close(getattr(r0.data, field), getattr(s0.pipeline_state, field), rtol=0, atol=1e-12)
    B = 3
    act = torch.rand(B, env.action_size, generator=torch.Generator().manual_seed(1), dtype=F64) * 1.6 - 0.8
    s1 = env.step(expand(s0, B), act)
    r1 = task.step(State(_expand(r0.data, B), r0.reward.expand(B), {k: v.expand(B, *v.shape[1:]) for k, v in r0.info.items()}), act)
    for field in ("qpos", "qvel", "x_pos", "xd_vel", "xd_ang", "site_xpos", "qacc"):
        torch.testing.assert_close(getattr(r1.data, field), getattr(s1.pipeline_state, field), rtol=0, atol=1e-9)
    torch.testing.assert_close(r1.data.contact.pos, s1.pipeline_state.contact.pos, rtol=0, atol=1e-9)
    torch.testing.assert_close(r1.reward, s1.reward, rtol=0, atol=1e-9)


def _expand(d, n):
    from port_bench.reference.planner import _expand as ex

    return ex(d, n)


@pytest.mark.parametrize("name", CONFIGS)
def test_one_level_and_its_update(name):
    """One control step of one level at a short horizon: the advance, the
    shift, every rollout's reward, the plan and the weighted body positions."""
    from dial_mpc_tpu_torch.core.dial_core import MBDPI

    torch.set_num_threads(min(4, torch.get_num_threads()))
    n = 4
    cfg = config(name, Nsample=n, Hsample=4, Hnode=2, Ndiffuse=1, Ndiffuse_init=1)
    dc, env = port_env(cfg)
    mb = MBDPI(dc, env)
    task = make_task(cfg, "cpu", F64)
    pl = Planner(cfg, task, n)
    s = env.reset(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(2)
    Y = torch.rand(dc.Hnode + 1, mb.nu, generator=g, dtype=F64) * 0.4 - 0.2
    eps = torch.randn(1, n, dc.Hnode + 1, mb.nu, generator=g, dtype=F64)
    s2, Y2, info = mb.control_step(s, Y, 1, eps)

    ref_in = task.state_at(s.pipeline_state.qpos, s.pipeline_state.qvel, s.reward, 0)
    nxt = pl.advance(ref_in, Y)
    torch.testing.assert_close(nxt.data.qpos, s2.pipeline_state.qpos, rtol=0, atol=1e-10)
    torch.testing.assert_close(nxt.data.qvel, s2.pipeline_state.qvel, rtol=0, atol=1e-9)
    Ys = pl.shift(Y)
    torch.testing.assert_close(Ys, mb.shift(Y), rtol=0, atol=1e-12)
    Y0s = pl.sample_nodes(Ys, pl.diffuse_factors(1)[0], eps[0])
    rews, xss = pl.rollout(nxt, Y0s)
    rews = rews.mean(-1)
    torch.testing.assert_close(rews, info["rews"][0], rtol=0, atol=1e-9)
    Ybar, xbar, dropped = pl.update(rews, Y0s, xss)
    torch.testing.assert_close(Ybar, Y2, rtol=0, atol=1e-10)
    torch.testing.assert_close(xbar, info["xbar"][0], rtol=0, atol=1e-9)
    assert dropped == int(info["n_dropped"][0])


def test_update_guards_non_finite_rollouts():
    cfg = config("allegro_reorient", Nsample=3, Hsample=4, Hnode=2)
    pl = Planner(cfg, make_task(cfg, "cpu", F64), 3)
    Y0s = torch.arange(4 * 3 * 16, dtype=F64).reshape(4, 3, 16) / 100.0
    xss = torch.ones(4, 5, 2, 3, dtype=F64)
    rews = torch.tensor([1.0, float("nan"), 0.5, float("inf")], dtype=F64)
    Ybar, xbar, dropped = pl.update(rews, Y0s, xss)
    assert dropped == 2 and torch.isfinite(Ybar).all()
    Ybar, _, dropped = pl.update(torch.full((4,), float("nan"), dtype=F64), Y0s, xss)
    assert dropped == 4 and torch.equal(Ybar, Y0s[-1])  # every rollout exploded: the plan stays


def test_reference_imports_nothing_of_the_program():
    code = (
        "import sys; sys.path.insert(0, %r);"
        "import port_bench.reference.tasks, port_bench.reference.task, port_bench.reference.planner, port_bench.harness.check, port_bench.harness.counts;"
        "port_bench.reference.tasks.task_class('allegro_reorient');"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'dial_mpc_tpu_torch', 'dial_mpc_tpu', 'jax', 'jaxlib', 'flax'}))"
    ) % ROOT
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
