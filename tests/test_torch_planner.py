"""PyTorch planner, spline and Go2 task against scipy, the JAX package and
the stored golden trajectory.

CPU only (``device="cpu"``), float64 unless said otherwise. Noise is never
drawn twice: where a reference's draw matters, the test takes it from
``jax.random.normal`` and injects it into the port.

Run with:  python -m pytest tests/test_torch_*.py -q
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from scipy.interpolate import InterpolatedUnivariateSpline

import dial_mpc_tpu.envs as jax_envs
from dial_mpc_tpu.core.dial_config import DialConfig as JaxDialConfig
from dial_mpc_tpu.core.dial_core import MBDPI as JaxMBDPI
from dial_mpc_tpu.envs.base_env import State as JaxState
from dial_mpc_tpu.physics import model as jmodel
from dial_mpc_tpu.utils.function_utils import get_foot_step as jax_get_foot_step
from dial_mpc_tpu.utils.spline import FixedSpline as JaxFixedSpline

from tests import reference_utils

import dial_mpc_tpu_torch.envs as torch_envs
from dial_mpc_tpu_torch.core.dial_config import DialConfig
from dial_mpc_tpu_torch.core.dial_core import MBDPI
from dial_mpc_tpu_torch.envs.base_env import expand_state
from dial_mpc_tpu_torch.utils import convert
from dial_mpc_tpu_torch.utils.function_utils import get_foot_step
from dial_mpc_tpu_torch.utils.io_utils import get_example_path, load_dataclass_from_dict
from dial_mpc_tpu_torch.utils.spline import FixedSpline

F64 = torch.float64
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "unitree_go2_trot.npz")
# the settings of tests/golden_utils.py
OVERRIDES = dict(Nsample=8, n_steps=3, Ndiffuse=1, Ndiffuse_init=2)


def _trot_config():
    with open(get_example_path("unitree_go2_trot.yaml")) as f:
        cfgd = yaml.safe_load(f)
    cfgd.update(OVERRIDES)
    return cfgd


@pytest.fixture(scope="module")
def planner():
    cfgd = _trot_config()
    cfg = load_dataclass_from_dict(DialConfig, cfgd)
    env_cfg = load_dataclass_from_dict(
        torch_envs.get_config(cfg.env_name), cfgd, convert_list_to_array=True
    )
    env = torch_envs.get_environment(cfg.env_name, env_cfg, device="cpu", dtype=F64)
    return cfg, env, MBDPI(cfg, env, torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def jax_env():
    cfgd = _trot_config()
    cfg = load_dataclass_from_dict(JaxDialConfig, cfgd)
    env_cfg = load_dataclass_from_dict(jax_envs.get_config(cfg.env_name), cfgd, convert_list_to_array=True)
    return cfg, jax_envs.get_environment(cfg.env_name, env_cfg)


# ---------------------------------------------------------------------------
# splines
# ---------------------------------------------------------------------------

GRIDS = [(np.linspace(0, 0.32, 5), np.linspace(0, 0.32, 17)),
         (np.linspace(0, 0.32, 17), np.linspace(0, 0.32, 5)),
         (np.linspace(0, 1.0, 4), np.linspace(-0.1, 1.2, 9)),
         (np.array([0.0, 0.1, 0.25, 0.6, 0.7, 1.0]), np.linspace(0, 1, 11))]


@pytest.mark.parametrize("grid", range(len(GRIDS)))
def test_spline_apply_matches_scipy(grid):
    x, xq = GRIDS[grid]
    rng = np.random.default_rng(grid)
    Y = rng.normal(size=(3, x.shape[0], 2))
    out = FixedSpline(x, xq, dtype=F64).apply(torch.tensor(Y)).numpy()
    assert out.shape == (3, xq.shape[0], 2)
    for b in range(3):
        for u in range(2):
            ref = InterpolatedUnivariateSpline(x, Y[b, :, u], k=2)(xq)
            np.testing.assert_allclose(out[b, :, u], ref, atol=1e-10)


@pytest.mark.parametrize("dt", [0.0, 0.013, 0.02, 0.08, 0.31, 0.4, -0.05])
def test_spline_shift_matches_scipy_and_jax(dt):
    x = np.linspace(0, 0.32, 5)
    Y = np.random.default_rng(1).normal(size=(5, 3))
    out = FixedSpline(x, x, dtype=F64).shift(torch.tensor(Y), dt).numpy()
    for u in range(3):
        ref = InterpolatedUnivariateSpline(x, Y[:, u], k=2)(x + dt)
        np.testing.assert_allclose(out[:, u], ref, atol=1e-10)
    jref = JaxFixedSpline(x, x, dtype=jnp.float64).shift(jnp.asarray(Y), dt)
    np.testing.assert_allclose(out, np.asarray(jref), atol=1e-12)


def test_spline_matrices_match_jax():
    x, xq = GRIDS[0]
    t, j = FixedSpline(x, xq, dtype=F64), JaxFixedSpline(x, xq, dtype=jnp.float64)
    np.testing.assert_array_equal(t.matrix.numpy(), np.asarray(j.matrix))
    np.testing.assert_array_equal(t.K.numpy(), np.asarray(j.K))
    with pytest.raises(ValueError):
        FixedSpline(np.array([0.0, 1.0]), xq)


@pytest.mark.parametrize("gait", ["stand", "walk", "trot", "canter", "gallop"])
def test_foot_step_matches_jax(gait):
    from dial_mpc_tpu.envs.unitree_go2_env import GAIT_PARAMS as JP, GAIT_PHASES as JPH
    from dial_mpc_tpu_torch.envs.unitree_go2_env import GAIT_PARAMS, GAIT_PHASES

    times = np.linspace(0, 3, 41)
    duty, cadence, amp = GAIT_PARAMS[gait]
    out = get_foot_step(duty, cadence, amp, torch.tensor(GAIT_PHASES[gait], dtype=F64), torch.tensor(times))
    jd, jc, ja = (jnp.asarray(v, jnp.float64) for v in JP[gait])
    ref = jax.vmap(lambda t: jax_get_foot_step(jd, jc, ja, jnp.asarray(JPH[gait], jnp.float64), t))(jnp.asarray(times))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-12)


# ---------------------------------------------------------------------------
# Go2 task on a replayed Data
# ---------------------------------------------------------------------------

def _jax_data(jm, d, i):
    """Sample i of a lean torch Data as an unbatched JAX Data."""
    a = lambda t: jnp.asarray(t[i].numpy())
    contact = jmodel.Contact(
        dist=a(d.contact.dist), pos=a(d.contact.pos), frame=None, geom=jm.con_geom,
        includemargin=jm.con_includemargin, friction=jm.con_friction, solref=jm.con_solref,
        solimp=jm.con_solimp, dim=jm.con_dim,
    )
    return jmodel.Data(
        qpos=a(d.qpos), qvel=a(d.qvel), ctrl=a(d.ctrl), time=a(d.time), site_xpos=a(d.site_xpos),
        site_xmat=a(d.site_xmat), x_pos=a(d.x_pos), x_rot=a(d.x_rot), xd_vel=a(d.xd_vel),
        xd_ang=a(d.xd_ang), qacc=a(d.qacc), contact=contact,
    )


@pytest.fixture(scope="module")
def replayed(planner, jax_env):
    """Four samples stepped a few times by the port, then one more step on
    both sides with the port's next pipeline state replayed into the JAX env."""
    _, env, _ = planner
    _, jenv = jax_env
    rng = np.random.default_rng(7)
    n = 4
    st = expand_state(env.reset(), n)
    for _ in range(6):
        st = env.step(st, torch.tensor(rng.uniform(-1, 1, (n, 12))))
    action = torch.tensor(rng.uniform(-1, 1, (n, 12)))
    nxt = env.step(st, action)
    f32 = jnp.float32
    step_j = jax.jit(jenv.step)
    outs = []
    for i in range(n):
        info = {
            "rng": jax.random.PRNGKey(0),
            "pos_tar": jnp.asarray(st.info["pos_tar"][i].numpy(), f32),
            "vel_tar": jnp.asarray(st.info["vel_tar"][i].numpy(), f32),
            "ang_vel_tar": jnp.asarray(st.info["ang_vel_tar"][i].numpy(), f32),
            "yaw_tar": jnp.asarray(st.info["yaw_tar"][i].numpy(), f32),
            "step": jnp.asarray(int(st.info["step"][i]), jnp.int32),
            "z_feet": jnp.asarray(st.info["z_feet"][i].numpy(), f32),
            "z_feet_tar": jnp.asarray(st.info["z_feet_tar"][i].numpy(), f32),
            "randomize_target": False,
            "last_contact": jnp.asarray(st.info["last_contact"][i].numpy()),
            "feet_air_time": jnp.asarray(st.info["feet_air_time"][i].numpy(), f32),
        }
        js = JaxState(
            _jax_data(jenv.sys, st.pipeline_state, i), jnp.asarray(st.obs[i].numpy()),
            jnp.asarray(st.reward[i].numpy(), f32), jnp.asarray(st.done[i].numpy(), f32), {}, info,
        )
        outs.append(step_j(js, jnp.asarray(action[i].numpy()), _jax_data(jenv.sys, nxt.pipeline_state, i)))
    return nxt, outs


# The JAX env pins reward and its info leaves to float32, so agreement is
# held to float32 resolution: 1e-6 (rewards are O(1), heights O(0.1)).
@pytest.mark.parametrize("what", ["reward", "done", "obs", "ctrl"])
def test_go2_step_matches_jax_on_replayed_data(replayed, what):
    nxt, outs = replayed
    for i, js in enumerate(outs):
        got = {"reward": nxt.reward, "done": nxt.done, "obs": nxt.obs, "ctrl": nxt.pipeline_state.ctrl}[what][i]
        ref = {"reward": js.reward, "done": js.done, "obs": js.obs, "ctrl": js.pipeline_state.ctrl}[what]
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, err_msg=f"sample {i}")


@pytest.mark.parametrize("key", ["vel_tar", "ang_vel_tar", "z_feet", "z_feet_tar", "feet_air_time", "last_contact", "step"])
def test_go2_info_matches_jax_on_replayed_data(replayed, key):
    nxt, outs = replayed
    for i, js in enumerate(outs):
        np.testing.assert_allclose(
            nxt.info[key][i].numpy().astype(np.float64), np.asarray(js.info[key], np.float64), atol=1e-6
        )


def test_go2_reset_state(planner):
    _, env, _ = planner
    st = env.reset()
    assert st.pipeline_state.qpos.shape == (1, 19) and st.obs.shape == (1, 3 + 3 + 12 + 19 + 3 + 3 + 12)
    assert st.info["step"].dtype == torch.int32 and st.info["last_contact"].dtype == torch.bool
    assert st.reward.dtype == F64 and float(st.pipeline_state.x_pos[0, 0, 2]) == pytest.approx(0.27, abs=1e-6)
    big = expand_state(st, 5)
    assert big.pipeline_state.qpos.shape == (5, 19) and big.info["feet_air_time"].shape == (5, 4)
    assert big.pipeline_state.contact.geom.shape == (4, 2)  # static rows are not expanded


def test_act2joint_and_act2tau(planner, jax_env):
    _, env, _ = planner
    _, jenv = jax_env
    rng = np.random.default_rng(2)
    act = rng.uniform(-1.5, 1.5, (3, 12))
    np.testing.assert_allclose(
        env.act2joint(torch.tensor(act)).numpy(), np.asarray(jax.vmap(jenv.act2joint)(jnp.asarray(act))), atol=1e-12
    )
    st = expand_state(env.reset(), 3)
    tau = env.act2tau(torch.tensor(act), st.pipeline_state)
    q = st.pipeline_state.qpos[:, 7:].numpy()
    expect = 30.0 * (env.act2joint(torch.tensor(act)).numpy() - q)
    np.testing.assert_allclose(tau.numpy(), expect, atol=1e-12)


# ---------------------------------------------------------------------------
# planner maths
# ---------------------------------------------------------------------------

def test_schedule_and_spline_maps_match_jax(planner, jax_env):
    cfg, _, pl = planner
    jcfg, jenv = jax_env
    jpl = JaxMBDPI(jcfg, jenv)
    np.testing.assert_allclose(pl.sigma_control.numpy(), np.asarray(jpl.sigma_control), atol=1e-15)
    np.testing.assert_allclose(pl.diffuse_factors(3).numpy(), np.asarray(jpl.diffuse_factors(3)), atol=1e-15)
    Y = np.random.default_rng(3).uniform(-1, 1, (cfg.Hnode + 1, 12))
    # the JAX planner's spline matrices are float32
    np.testing.assert_allclose(pl.node2u(torch.tensor(Y)).numpy(), np.asarray(jpl.node2u(jnp.asarray(Y))), atol=1e-6)
    np.testing.assert_allclose(pl.shift(torch.tensor(Y)).numpy(), np.asarray(jpl.shift(jnp.asarray(Y))), atol=1e-6)
    u = pl.node2u(torch.tensor(Y))
    np.testing.assert_allclose(
        pl.shift_Y_from_u(u, 2).numpy(), np.asarray(jpl.shift_Y_from_u(jnp.asarray(u.numpy()), 2)), atol=1e-6
    )
    assert pl.ctrl_dt == 0.02 and jpl.ctrl_dt == 0.02


def test_sample_nodes_with_injected_draw_matches_jax(planner, jax_env):
    cfg, _, pl = planner
    jcfg, jenv = jax_env
    jpl = JaxMBDPI(jcfg, jenv)
    key = jax.random.PRNGKey(11)
    Ybar = np.random.default_rng(4).uniform(-1, 1, (cfg.Hnode + 1, 12))
    scale = np.asarray(jpl.diffuse_factors(1)[0])
    _, ref = jpl.sample_nodes(key, jnp.asarray(Ybar), jnp.asarray(scale))
    _, sub = jax.random.split(key)
    eps = np.asarray(jax.random.normal(sub, (cfg.Nsample, cfg.Hnode + 1, 12)))
    Ybar_t = torch.tensor(Ybar)
    out = pl.sample_nodes(Ybar_t, torch.tensor(scale), eps=torch.tensor(eps))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-12)
    assert torch.equal(Ybar_t, torch.tensor(Ybar)), "the warm start must not be written to"
    assert (out[:-1, 0] == torch.clamp(Ybar_t[0], -1, 1)).all() and torch.equal(out[-1], torch.clamp(Ybar_t, -1, 1))
    with pytest.raises(ValueError):
        pl.sample_nodes(Ybar_t, torch.tensor(scale), eps=torch.zeros(3, 3, 3, dtype=F64))
    drawn = pl.sample_nodes(Ybar_t, torch.tensor(scale))
    assert drawn.shape == out.shape and not torch.equal(drawn, out)


def _jax_draws(seed, shapes):
    """The draws the JAX runner's stream gives the planner, level by level."""
    rng = jax.random.PRNGKey(seed)
    rng, _ = jax.random.split(rng)  # env reset
    rng, _ = jax.random.split(rng)  # the runner's unused split
    out = []
    for n_levels, shape in shapes:
        levels = []
        for _ in range(n_levels):
            rng, sub = jax.random.split(rng)
            levels.append(np.asarray(jax.random.normal(sub, shape)))
        out.append(np.stack(levels))
    return out


@pytest.fixture(scope="module")
def golden_run(planner):
    cfg, env, pl = planner
    shape = (cfg.Nsample, cfg.Hnode + 1, pl.nu)
    draws = _jax_draws(cfg.seed, [(cfg.Ndiffuse_init, shape)] + [(cfg.Ndiffuse, shape)] * (cfg.n_steps - 1))
    st = env.reset()
    Y = torch.zeros(cfg.Hnode + 1, pl.nu, dtype=F64)
    Ys, rewards, qpos, infos = [], [], [], []
    for t in range(cfg.n_steps):
        st, Y, info = pl.control_step(st, Y, draws[t].shape[0], eps=torch.tensor(draws[t]))
        Ys.append(Y.numpy())
        rewards.append(float(st.reward))
        qpos.append(st.pipeline_state.qpos[0].numpy())
        infos.append(info)
    return np.stack(Ys), np.asarray(rewards), np.stack(qpos), infos


# The golden was made by the JAX planner with float32 physics under float64
# glue; the port runs float64 throughout. float32 rounding in the reference's
# rewards (1e-7) passes through the softmax (divided by their std and the
# 0.05 temperature), so the plans agree to a few 1e-6.
@pytest.mark.parametrize("what,tol", [("Y", 2e-5), ("reward", 5e-6), ("qpos", 2e-6)])
def test_control_step_reproduces_golden(golden_run, what, tol):
    ref = np.load(GOLDEN)
    got = dict(zip(("Y", "reward", "qpos"), golden_run[:3]))[what]
    assert got.shape == ref[what].shape
    np.testing.assert_allclose(got, ref[what], atol=tol)


def test_control_step_info_shapes(planner, golden_run):
    cfg, _, _ = planner
    infos = golden_run[3]
    assert infos[0]["rews"].shape == (cfg.Ndiffuse_init, cfg.Nsample + 1)
    assert infos[1]["xbar"].shape == (cfg.Ndiffuse, cfg.Hsample + 1, 13, 3)
    assert all(torch.isfinite(i["xbar"]).all() for i in infos)


def test_reverse_once_matches_control_step_level(planner):
    """reverse_once on its own equals the level control_step runs."""
    cfg, env, pl = planner
    shape = (cfg.Nsample, cfg.Hnode + 1, pl.nu)
    eps = torch.tensor(_jax_draws(5, [(1, shape)])[0])
    st = env.reset()
    Y0 = torch.zeros(cfg.Hnode + 1, pl.nu, dtype=F64)
    st1, Y1, info1 = pl.control_step(st, Y0, 1, eps=eps)
    Y2, info2 = pl.reverse_once(st1, pl.shift(Y0), pl.diffuse_factors(1)[0], eps=eps[0])
    assert torch.equal(Y1, Y2) and torch.equal(info1["rews"][0], info2["rews"])
    w = torch.softmax((info2["rews"] - info2["rews"][-1]) / info2["rews"].std(unbiased=False) / cfg.temp_sample, 0)
    Y0s = pl.sample_nodes(pl.shift(Y0), pl.diffuse_factors(1)[0], eps=eps[0])
    np.testing.assert_allclose(Y2.numpy(), torch.einsum("n,nij->ij", w, Y0s).numpy(), atol=1e-12)


# ---------------------------------------------------------------------------
# non-finite guards
# ---------------------------------------------------------------------------

class _PoisonedEnv:
    """The real env, with chosen rollout samples (or the advance) made NaN."""

    def __init__(self, env, bad_samples=(), bad_advance=False):
        self._env, self._bad, self._bad_advance = env, list(bad_samples), bad_advance

    def __getattr__(self, name):
        return getattr(self._env, name)

    def step(self, state, action):
        out = self._env.step(state, action)
        nan = float("nan")
        if action.shape[0] == 1:
            if self._bad_advance:
                ps = out.pipeline_state
                out = out.replace(pipeline_state=ps.replace(qpos=ps.qpos * nan), reward=out.reward * nan)
            return out
        if self._bad:
            reward = out.reward.clone()
            reward[self._bad] = nan
            ps = out.pipeline_state
            x_pos = ps.x_pos.clone()
            x_pos[self._bad] = nan
            out = out.replace(reward=reward, pipeline_state=ps.replace(x_pos=x_pos))
        return out


def _level(planner, env):
    cfg, _, _ = planner
    pl = MBDPI(cfg, env)
    eps = torch.tensor(_jax_draws(9, [(1, (cfg.Nsample, cfg.Hnode + 1, pl.nu))])[0][0])
    Ybar = torch.tensor(np.random.default_rng(6).uniform(-0.3, 0.3, (cfg.Hnode + 1, pl.nu)))
    return pl, Ybar, eps


def test_one_nan_rollout_gets_zero_weight(planner):
    cfg, env, _ = planner
    pl, Ybar, eps = _level(planner, _PoisonedEnv(env, bad_samples=[2]))
    st = env.reset()
    Y, info = pl.reverse_once(st, Ybar, pl.diffuse_factors(1)[0], eps=eps)
    assert torch.isfinite(Y).all() and torch.isfinite(info["xbar"]).all()
    assert torch.isnan(info["rews"][2]) and torch.isfinite(info["rews"][[0, 1, 3]]).all()
    # the same level without the poisoned sample's weight
    clean, _, _ = _level(planner, env)
    _, cinfo = clean.reverse_once(st, Ybar, clean.diffuse_factors(1)[0], eps=eps)
    keep = [i for i in range(cfg.Nsample + 1) if i != 2]
    r = cinfo["rews"][keep]
    w = torch.softmax((r - r[-1]) / r.std(unbiased=False) / cfg.temp_sample, 0)
    Y0s = clean.sample_nodes(Ybar, clean.diffuse_factors(1)[0], eps=eps)[keep]
    np.testing.assert_allclose(Y.numpy(), torch.einsum("n,nij->ij", w, Y0s).numpy(), atol=1e-12)


def test_all_nan_rollouts_keep_the_plan(planner):
    cfg, env, _ = planner
    pl, Ybar, eps = _level(planner, _PoisonedEnv(env, bad_samples=list(range(cfg.Nsample + 1))))
    Y, info = pl.reverse_once(env.reset(), Ybar, pl.diffuse_factors(1)[0], eps=eps)
    assert torch.equal(Y, torch.clamp(Ybar, -1, 1))
    assert (info["xbar"] == 0).all()


def test_diverged_advance_freezes_the_state(planner):
    cfg, env, _ = planner
    pl, Ybar, eps = _level(planner, _PoisonedEnv(env, bad_advance=True))
    st = env.reset()
    new, Y, _ = pl.control_step(st, Ybar, 1, eps=eps[None])
    assert torch.equal(new.pipeline_state.qpos, st.pipeline_state.qpos)
    assert torch.equal(new.pipeline_state.x_pos, st.pipeline_state.x_pos)
    assert torch.equal(new.reward, st.reward) and torch.isfinite(Y).all()


def test_unknown_update_method_raises(planner):
    cfg, env, _ = planner
    with pytest.raises(ValueError):
        MBDPI(dataclasses.replace(cfg, update_method="cma"), env)


def test_state_from_numpy(planner):
    _, env, _ = planner
    st = env.reset()
    ps = st.pipeline_state
    leaves = dict(
        pipeline_state=dict(
            qpos=ps.qpos[0].numpy(), qvel=ps.qvel[0].numpy(), ctrl=ps.ctrl[0].numpy(), time=ps.time[0].numpy(),
            x_pos=ps.x_pos[0].numpy(), x_rot=ps.x_rot[0].numpy(),
        ),
        obs=st.obs[0].numpy(), reward=np.float32(0.0), done=np.float32(0.0),
        info=dict(rng=np.zeros(2, np.uint32), step=np.int32(4), last_contact=np.zeros(4, bool),
                  vel_tar=np.zeros(3, np.float32), randomize_target=False),
    )
    back = convert.state_from_numpy(leaves, dtype=F64, batched=False)
    assert torch.equal(back.pipeline_state.qpos, ps.qpos) and back.pipeline_state.x_pos.shape == (1, 13, 3)
    assert "rng" not in back.info and back.info["step"].dtype == torch.int32 and int(back.info["step"][0]) == 4
    assert back.info["last_contact"].dtype == torch.bool and back.info["randomize_target"] is False
    assert back.reward.shape == (1,) and back.reward.dtype == F64


# ---------------------------------------------------------------------------
# Go2 seq-jump: course, step on a replayed Data, golden trajectory
# ---------------------------------------------------------------------------

JUMP_GOLDEN = os.path.join(os.path.dirname(GOLDEN), "unitree_go2_seq_jump.npz")


def _example_config(example):
    with open(get_example_path(example + ".yaml")) as f:
        cfgd = yaml.safe_load(f)
    cfgd.update(OVERRIDES)
    return cfgd


@pytest.fixture(scope="module")
def jump_planner():
    cfgd = _example_config("unitree_go2_seq_jump")
    cfg = load_dataclass_from_dict(DialConfig, cfgd)
    env_cfg = load_dataclass_from_dict(
        torch_envs.get_config(cfg.env_name), cfgd, convert_list_to_array=True, dtype=F64
    )
    env = torch_envs.get_environment(cfg.env_name, env_cfg, device="cpu", dtype=F64)
    return cfg, env, MBDPI(cfg, env, torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def jax_jump_env():
    cfgd = _example_config("unitree_go2_seq_jump")
    cfg = load_dataclass_from_dict(JaxDialConfig, cfgd)
    env_cfg = load_dataclass_from_dict(jax_envs.get_config(cfg.env_name), cfgd, convert_list_to_array=True)
    return cfg, jax_envs.get_environment(cfg.env_name, env_cfg)


def test_generate_jumping_sequence_matches_jax():
    from dial_mpc_tpu.envs.unitree_go2_env import generate_jumping_sequence as jax_generate
    from dial_mpc_tpu_torch.envs.unitree_go2_env import generate_jumping_sequence

    rng = np.random.default_rng(8)
    com_pos = np.concatenate([rng.uniform(-2, 2, (7, 2)), np.full((7, 1), 0.27)], axis=1)
    heading = rng.uniform(-3, 3, 7)
    got = generate_jumping_sequence(torch.tensor(com_pos), torch.tensor(heading), 0.1)
    ref = jax_generate(com_pos, heading, 0.1)  # float32 inside
    assert got[0].shape == (7, 4, 3) and got[1].shape == (7, 4)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-6)
    # a quarter turn to the left carries the front-right foot from (0.2, -0.135) to (0.135, 0.2)
    q = generate_jumping_sequence(torch.tensor([[0.0, 0.0, 0.27]], dtype=F64), torch.tensor([np.pi / 2], dtype=F64), 0.1)
    np.testing.assert_allclose(q[0][0, 0].numpy(), [0.135, 0.2, 0.27], atol=1e-12)


_JUMP_RESET_INFO = ("contact_targets", "contact_target_radius", "pose_target_sequence", "yaw_target_sequence", "pos_tar")


def jax_seq_jump_reset_reference():
    """The JAX seq-jump env's reset, PRNGKey(0) (tests/reference_data/
    planner_seq_jump_reset.npz): its observation and the info the port's
    reset must match."""
    cfgd = _example_config("unitree_go2_seq_jump")
    cfg = load_dataclass_from_dict(JaxDialConfig, cfgd)
    env_cfg = load_dataclass_from_dict(jax_envs.get_config(cfg.env_name), cfgd, convert_list_to_array=True)
    js = jax.jit(jax_envs.get_environment(cfg.env_name, env_cfg).reset)(jax.random.PRNGKey(0))
    return {"obs": np.asarray(js.obs), **{"info." + k: np.asarray(js.info[k]) for k in _JUMP_RESET_INFO}}


def test_seq_jump_reset_state(jump_planner):
    _, env, _ = jump_planner
    st = env.reset()
    js = reference_utils.load("planner_seq_jump_reset")
    assert st.obs.shape == (1, 3 + 3 + 12 + 3 + 2 + 1 + 12 + 3 + 3 + 12)
    np.testing.assert_allclose(st.obs[0].numpy(), js["obs"], atol=1e-6)
    for key in _JUMP_RESET_INFO:
        np.testing.assert_allclose(st.info[key][0].numpy(), js["info." + key], atol=1e-6, err_msg=key)
    assert st.info["contact_stage"].dtype == torch.int32 and st.info["contact_targets"].shape == (1, 5, 4, 3)
    big = expand_state(st, 3)
    assert big.info["contact_targets"].shape == (3, 5, 4, 3) and big.info["last_ctrl"].shape == (3, 12)


def test_seq_jump_random_course_draws_from_the_generator(jump_planner):
    cfg, env, _ = jump_planner
    rand_cfg = dataclasses.replace(env._config, randomize_tasks=True)
    renv = torch_envs.get_environment(cfg.env_name, rand_cfg, device="cpu", dtype=F64)
    a = renv.reset(torch.Generator().manual_seed(5))
    b = renv.reset(torch.Generator().manual_seed(5))
    c = renv.reset(torch.Generator().manual_seed(6))
    assert a.info["contact_targets"].shape == (1, 11, 4, 3) and a.info["yaw_target_sequence"].shape == (1, 11)
    assert torch.equal(a.info["pose_target_sequence"], b.info["pose_target_sequence"])
    assert not torch.equal(a.info["pose_target_sequence"], c.info["pose_target_sequence"])
    pose, yaw = a.info["pose_target_sequence"][0], a.info["yaw_target_sequence"][0]
    assert torch.equal(pose[0], torch.tensor([0.0, 0.0, 0.27], dtype=F64)) and float(yaw[0]) == 0.0
    assert (pose[1:, :2] - pose[:-1, :2]).abs().max() <= 0.65 and (yaw[1:] - yaw[:-1]).abs().max() <= 0.5
    assert (pose[:, 2] == 0.27).all()
    nxt = renv.step(a, torch.zeros(1, 12, dtype=F64))
    assert torch.isfinite(nxt.reward).all() and nxt.obs.shape == a.obs.shape


def _jax_info(info, i):
    """Sample i of the port's info as the JAX env's (float32-pinned) info."""
    out = {"rng": jax.random.PRNGKey(0)}
    for k, v in info.items():
        if not isinstance(v, torch.Tensor):
            out[k] = v
        elif v.dtype == torch.int32:
            out[k] = jnp.asarray(int(v[i]), jnp.int32)
        elif v.dtype == torch.bool:
            out[k] = jnp.asarray(v[i].numpy())
        else:
            out[k] = jnp.asarray(v[i].numpy(), jnp.float32)
    return out


@pytest.fixture(scope="module")
def replayed_jump(jump_planner, jax_jump_env):
    """Four samples stepped a few times by the port, set to steps on either
    side of a stage change, then one more step on both sides with the port's
    next pipeline state replayed into the JAX env."""
    _, env, _ = jump_planner
    _, jenv = jax_jump_env
    rng = np.random.default_rng(17)
    n = 4
    st = expand_state(env.reset(), n)
    for _ in range(6):
        st = env.step(st, torch.tensor(rng.uniform(-1, 1, (n, 12))))
    steps = torch.tensor([6, 49, 50, 120], dtype=torch.int32)
    st = st.replace(info={**st.info, "step": steps, "contact_stage": torch.tensor([0, 0, 1, 2], dtype=torch.int32)})
    action = torch.tensor(rng.uniform(-1, 1, (n, 12)))
    nxt = env.step(st, action)
    f32 = jnp.float32
    step_j = jax.jit(jenv.step)
    outs = []
    for i in range(n):
        js = JaxState(
            _jax_data(jenv.sys, st.pipeline_state, i), jnp.asarray(st.obs[i].numpy()),
            jnp.asarray(st.reward[i].numpy(), f32), jnp.asarray(st.done[i].numpy(), f32), {}, _jax_info(st.info, i),
        )
        outs.append(step_j(js, jnp.asarray(action[i].numpy()), _jax_data(jenv.sys, nxt.pipeline_state, i)))
    return nxt, outs


# float32 resolution, as for the trot step: the JAX env pins reward and info
# to float32 (rewards are O(10) here: 1e-5 relative to that is 1e-6 of O(1))
@pytest.mark.parametrize("what,tol", [("reward", 1e-5), ("done", 0.0), ("obs", 1e-6), ("ctrl", 1e-6)])
def test_seq_jump_step_matches_jax_on_replayed_data(replayed_jump, what, tol):
    nxt, outs = replayed_jump
    for i, js in enumerate(outs):
        got = {"reward": nxt.reward, "done": nxt.done, "obs": nxt.obs, "ctrl": nxt.pipeline_state.ctrl}[what][i]
        ref = {"reward": js.reward, "done": js.done, "obs": js.obs, "ctrl": js.pipeline_state.ctrl}[what]
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol, err_msg=f"sample {i}")


@pytest.mark.parametrize("key", ["step", "contact_stage", "last_ctrl", "z_feet", "z_feet_tar"])
def test_seq_jump_info_matches_jax_on_replayed_data(replayed_jump, key):
    nxt, outs = replayed_jump
    for i, js in enumerate(outs):
        np.testing.assert_allclose(
            nxt.info[key][i].numpy().astype(np.float64), np.asarray(js.info[key], np.float64), atol=1e-6
        )
    assert nxt.info["contact_stage"].tolist() == [0, 1, 1, 2] and nxt.info["contact_stage"].dtype == torch.int32


def test_seq_jump_contact_reward_matches_the_reference_loop(jump_planner):
    """The (B, stage, foot) pass against the feet x stages loop it replaces,
    on contact points placed inside, outside and between the circles."""
    _, env, _ = jump_planner
    rng = np.random.default_rng(21)
    n = 16
    st = expand_state(env.reset(), n)
    targets = st.info["contact_targets"]
    stage = torch.tensor(rng.integers(0, 5, n), dtype=torch.int32)
    near = targets[torch.arange(n), torch.tensor(rng.integers(0, 5, n))]  # (n, 4, 3): some stage's circles
    cpos = near + torch.tensor(rng.normal(0, 0.08, (n, 4, 3)))
    cdist = torch.tensor(rng.uniform(-0.02, 0.02, (n, 4)))
    ps = st.pipeline_state
    nxt_ps = ps.replace(contact=dataclasses.replace(ps.contact, dist=cdist, pos=cpos))
    st = st.replace(info={**st.info, "contact_stage": stage})
    base = env.step(st.replace(info={**st.info, "contact_targets": targets + 100.0}), torch.zeros(n, 12, dtype=F64), nxt_ps)
    got = env.step(st, torch.zeros(n, 12, dtype=F64), nxt_ps)
    radius = st.info["contact_target_radius"]
    expect = np.zeros(n)
    for b in range(n):
        reward, penalty = 0.0, 0
        for i in range(4):
            in_any = False
            for j in range(5):
                cond = float(((cpos[b, i, :2] - targets[b, j, i, :2]) ** 2).sum()) <= float(radius[b, j, i]) ** 2
                if cond and j == int(stage[b]):
                    reward += min(max(1.0 - float(cdist[b, i]), 0.0), 1.0)
                in_any |= cond
            penalty += int(float(cdist[b, i]) <= 0.001 and not in_any)
        # `base` has every circle far away: no reward, every touching foot penalised
        base_penalty = int((cdist[b] <= 0.001).sum())
        expect[b] = 0.1 * reward - 0.1 * penalty + 0.1 * base_penalty
    np.testing.assert_allclose((got.reward - base.reward).numpy(), expect, atol=1e-12)
    assert np.abs(expect).max() > 0.05


@pytest.fixture(scope="module")
def jump_golden_run(jump_planner):
    cfg, env, pl = jump_planner
    shape = (cfg.Nsample, cfg.Hnode + 1, pl.nu)
    draws = _jax_draws(cfg.seed, [(cfg.Ndiffuse_init, shape)] + [(cfg.Ndiffuse, shape)] * (cfg.n_steps - 1))
    st = env.reset()
    Y = torch.zeros(cfg.Hnode + 1, pl.nu, dtype=F64)
    Ys, rewards, qpos = [], [], []
    for t in range(cfg.n_steps):
        st, Y, _ = pl.control_step(st, Y, draws[t].shape[0], eps=torch.tensor(draws[t]))
        Ys.append(Y.numpy())
        rewards.append(float(st.reward))
        qpos.append(st.pipeline_state.qpos[0].numpy())
    return np.stack(Ys), np.asarray(rewards), np.stack(qpos)


# the tolerances of the trot golden, for the same reason; the reward is O(10)
# here, so its float32 rounding in the reference is ten times the trot's
@pytest.mark.parametrize("what,tol", [("Y", 2e-5), ("reward", 5e-6), ("qpos", 2e-6)])
def test_seq_jump_control_step_reproduces_golden(jump_golden_run, what, tol):
    ref = np.load(JUMP_GOLDEN)
    got = dict(zip(("Y", "reward", "qpos"), jump_golden_run))[what]
    assert got.shape == ref[what].shape
    np.testing.assert_allclose(got, ref[what], atol=tol)


# ---------------------------------------------------------------------------
# the two engine routes
# ---------------------------------------------------------------------------

def test_unfused_engine_equals_fused_over_control_steps(planner):
    """On the CPU both routes are the same plain physics, reached two ways
    (step_core's plain version + lean_data, forward.step + trim_data): a few
    control steps agree to 1e-9 (positions, plan) / 1e-7 (velocities)."""
    cfg, env, _ = planner
    unfused = torch_envs.get_environment(cfg.env_name, env._config, device="cpu", dtype=F64, engine="unfused")
    assert env.engine == "fused" and unfused.engine == "unfused"
    shape = (cfg.Nsample, cfg.Hnode + 1, 12)
    draws = _jax_draws(3, [(cfg.Ndiffuse_init, shape)] + [(cfg.Ndiffuse, shape)] * 2)
    traces = []
    for e in (env, unfused):
        pl = MBDPI(cfg, e)
        st, Y, trace = e.reset(), torch.zeros(cfg.Hnode + 1, 12, dtype=F64), []
        for eps in draws:
            st, Y, info = pl.control_step(st, Y, eps.shape[0], eps=torch.tensor(eps))
            ps = st.pipeline_state
            trace.append((Y, ps.qpos, ps.x_pos, ps.site_xpos, ps.contact.dist, ps.qvel, ps.xd_vel, ps.qacc, st.reward, info["rews"]))
        traces.append(trace)
        assert ps.xpos is None and ps.efc is None and ps.contact.frame is None, "both routes carry the lean Data"
    for a, b in zip(*traces):
        for k, (x, y) in enumerate(zip(a, b)):
            np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-9 if k < 5 else 1e-7, rtol=0)


def test_unfused_pipeline_step_substeps(planner):
    """n_frames = 4 substeps under one control: both routes, same lean Data."""
    cfg, env, _ = planner
    sub_cfg = dataclasses.replace(env._config, timestep=0.005)
    envs = [torch_envs.get_environment(cfg.env_name, sub_cfg, device="cpu", dtype=F64, engine=e) for e in ("fused", "unfused")]
    assert envs[0]._n_frames == 4
    ctrl = torch.tensor(np.random.default_rng(4).uniform(-5, 5, (3, 12)))
    outs = [e.pipeline_step(expand_state(e.reset(), 3).pipeline_state, ctrl) for e in envs]
    for name in ("qpos", "qvel", "ctrl", "time", "site_xpos", "x_pos", "x_rot", "xd_vel", "xd_ang", "qacc"):
        np.testing.assert_allclose(getattr(outs[0], name).numpy(), getattr(outs[1], name).numpy(), atol=1e-9, err_msg=name)
    np.testing.assert_allclose(outs[1].time.numpy(), 0.02, atol=1e-15)
    with pytest.raises(ValueError, match="engine"):
        torch_envs.get_environment(cfg.env_name, sub_cfg, device="cpu", engine="pallas")
