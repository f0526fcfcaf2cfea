"""The H1 tasks (jog, loco, push crate) and the Go2 crate climb against the
JAX package: a step on a replayed Data, the contact-slot lookups, the
per-joint PD gains, the state carried across from numpy, and the stored
golden trajectories.

CPU only (``device="cpu"``), float64. Noise is never drawn twice: the
golden runs take the JAX runner's draws and inject them into the port.

Run with:  python -m pytest tests/test_torch_envs.py -q
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import dial_mpc_tpu.envs as jax_envs
from dial_mpc_tpu.core.dial_config import DialConfig as JaxDialConfig
from dial_mpc_tpu.envs.base_env import State as JaxState

import dial_mpc_tpu_torch.envs as torch_envs
from dial_mpc_tpu_torch.core.dial_config import DialConfig
from dial_mpc_tpu_torch.core.dial_core import MBDPI
from dial_mpc_tpu_torch.envs.base_env import expand_state
from dial_mpc_tpu_torch.utils import convert
from dial_mpc_tpu_torch.utils.io_utils import get_example_path, load_dataclass_from_dict
from tests.test_torch_planner import OVERRIDES, _jax_data, _jax_draws, _jax_info

F64 = torch.float64
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
EXAMPLES = ["unitree_h1_jog", "unitree_h1_loco", "unitree_h1_push_crate", "unitree_go2_crate_climb"]
H1_INFO = ["vel_tar", "ang_vel_tar", "z_feet", "z_feet_tar", "feet_air_time", "last_contact", "step"]
INFO_KEYS = {
    "unitree_h1_jog": H1_INFO,
    "unitree_h1_loco": H1_INFO,
    "unitree_h1_push_crate": H1_INFO,
    "unitree_go2_crate_climb": ["step", "z_feet", "z_feet_tar", "pos_tar", "vel_tar", "yaw_tar"],
}


def _config(example):
    with open(get_example_path(example + ".yaml")) as f:
        cfgd = yaml.safe_load(f)
    cfgd.update(OVERRIDES)
    return cfgd


_TASKS = {}


def _task(example):
    """The port's env (CPU, float64) and the JAX env of one example."""
    if example not in _TASKS:
        cfgd = _config(example)
        cfg = load_dataclass_from_dict(DialConfig, cfgd)
        env_cfg = load_dataclass_from_dict(
            torch_envs.get_config(cfg.env_name), cfgd, convert_list_to_array=True, dtype=F64
        )
        env = torch_envs.get_environment(cfg.env_name, env_cfg, device="cpu", dtype=F64)
        jcfg = load_dataclass_from_dict(JaxDialConfig, cfgd)
        jenv_cfg = load_dataclass_from_dict(jax_envs.get_config(jcfg.env_name), cfgd, convert_list_to_array=True)
        _TASKS[example] = dict(cfg=cfg, env=env, jenv=jax_envs.get_environment(jcfg.env_name, jenv_cfg))
    return _TASKS[example]


@pytest.fixture(scope="module", params=EXAMPLES)
def task(request):
    return dict(example=request.param, **_task(request.param))


# ---------------------------------------------------------------------------
# what the envs look up at construction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("example", EXAMPLES)
def test_contact_slots_match_jax(example):
    """The slots each reward reads, from the port's pair table and the
    compiled scene's names, equal the JAX env's, looked up in MuJoCo."""
    t = _task(example)
    env, jenv = t["env"], t["jenv"]
    assert env.sys.pair_table == jenv.sys.pair_table
    if example == "unitree_go2_crate_climb":
        assert env._crate_contact_slots == list(jenv._crate_contact_slots)
        assert len(env._crate_contact_slots) == 4
        return
    assert env._left_foot_slots == np.asarray(jenv._left_foot_slots).tolist()
    assert env._right_foot_slots == np.asarray(jenv._right_foot_slots).tolist()
    assert len(env._left_foot_slots) == {"unitree_h1_loco": 4}.get(example, 2)
    if example == "unitree_h1_push_crate":
        assert env._wanted_contacts == np.asarray(jenv._wanted_contacts).tolist()
        assert env._unwanted_contacts == np.asarray(jenv._unwanted_contacts).tolist()
        assert env._wanted_contacts and env._unwanted_contacts
        assert env.physical_joint_range.shape == (19, 2)


@pytest.mark.parametrize("example", EXAMPLES)
def test_act2tau_with_per_joint_gains_matches_jax(example):
    t = _task(example)
    env, jenv = t["env"], t["jenv"]
    rng = np.random.default_rng(2)
    nu = env.action_size
    act = rng.uniform(-1.5, 1.5, (3, nu))
    st = expand_state(env.reset(), 3)
    ps = st.pipeline_state
    qpos = ps.qpos.numpy() + rng.normal(0, 0.05, ps.qpos.shape)
    qvel = rng.normal(0, 0.5, ps.qvel.shape)
    ps = ps.replace(qpos=torch.tensor(qpos), qvel=torch.tensor(qvel))
    got = env.act2tau(torch.tensor(act), ps)
    ref = [jenv.act2tau(jnp.asarray(act[i]), jax_data_of(jenv, qpos[i], qvel[i])) for i in range(3)]
    np.testing.assert_allclose(got.numpy(), np.stack([np.asarray(r) for r in ref]), atol=1e-9)
    if example.startswith("unitree_h1"):
        assert isinstance(env._kp, torch.Tensor) and env._kp.shape == (nu,) and env._kp.dtype == F64
    else:
        assert env._kp == 30.0 and env._kd == 0.0  # scalars stay scalars


def jax_data_of(jenv, qpos, qvel):
    from dial_mpc_tpu.physics import model as jmodel
    from dial_mpc_tpu.physics.kinematics import replace

    d = jmodel.make_data(jenv.sys, dtype=jnp.float64)
    return replace(d, qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel))


# ---------------------------------------------------------------------------
# one step on a replayed Data
# ---------------------------------------------------------------------------

def _perturb_contacts(env, ps, rng):
    """The replayed next Data with its contact table redrawn around the
    rewards' thresholds: distances within 2 cm of touching, and on the crate
    scenes contact points spread over the regions the contact rewards test
    (the crate's top face; the hands' 1.1 m)."""
    n, ncon = ps.contact.dist.shape
    dist = torch.tensor(rng.uniform(-0.02, 0.02, (n, ncon)))
    pos = ps.contact.pos.clone()
    if hasattr(env, "_crate_contact_slots"):
        s = env._crate_contact_slots
        pos[:, s] = torch.tensor(
            np.stack([rng.uniform(0.9, 1.7, (n, 4)), rng.uniform(-0.55, 0.55, (n, 4)),
                      rng.uniform(0.585, 0.615, (n, 4))], -1)
        )
    if hasattr(env, "_wanted_contacts"):
        w = env._wanted_contacts
        pos[:, w, 2] = torch.tensor(rng.uniform(1.0, 1.2, (n, len(w))))
    return ps.replace(contact=dataclasses.replace(ps.contact, dist=dist, pos=pos))


_REPLAYED = {}


def _replayed(example):
    """Four samples stepped a few times by the port, then one more step on
    both sides with the port's next pipeline state (its contact table
    redrawn) replayed into the JAX env."""
    if example in _REPLAYED:
        return _REPLAYED[example]
    t = _task(example)
    env, jenv = t["env"], t["jenv"]
    rng = np.random.default_rng(7)
    n, nu = 4, env.action_size
    st = expand_state(env.reset(), n)
    for _ in range(6):
        st = env.step(st, torch.tensor(rng.uniform(-1, 1, (n, nu))))
    # steps on either side of the command ramp and of the gait's phase
    st = st.replace(info={**st.info, "step": torch.tensor([6, 31, 77, 150], dtype=torch.int32)})
    action = torch.tensor(rng.uniform(-1, 1, (n, nu)))
    nxt_ps = _perturb_contacts(env, env.step(st, action).pipeline_state, rng)
    nxt = env.step(st, action, nxt_ps)
    step_j = jax.jit(jenv.step)
    outs = []
    f32 = jnp.float32
    for i in range(n):
        js = JaxState(
            _jax_data(jenv.sys, st.pipeline_state, i), jnp.asarray(st.obs[i].numpy()),
            jnp.asarray(st.reward[i].numpy(), f32), jnp.asarray(st.done[i].numpy(), f32), {},
            _jax_info(st.info, i),
        )
        outs.append(step_j(js, jnp.asarray(action[i].numpy()), _jax_data(jenv.sys, nxt_ps, i)))
    _REPLAYED[example] = (nxt, outs)
    return _REPLAYED[example]


# The JAX envs pin reward and their info leaves to float32: rewards are O(1)
# to O(10) here, so 1e-5 is float32 resolution of the largest.
@pytest.mark.parametrize("what,tol", [("reward", 1e-5), ("done", 0.0), ("obs", 1e-6), ("ctrl", 1e-9)])
def test_step_matches_jax_on_replayed_data(task, what, tol):
    nxt, outs = _replayed(task["example"])
    for i, js in enumerate(outs):
        got = {"reward": nxt.reward, "done": nxt.done, "obs": nxt.obs, "ctrl": nxt.pipeline_state.ctrl}[what][i]
        ref = {"reward": js.reward, "done": js.done, "obs": js.obs, "ctrl": js.pipeline_state.ctrl}[what]
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol, err_msg=f"sample {i}")


def test_contact_rewards_fire_on_replayed_data(task):
    """The redrawn contact table reaches the contact terms: the rewards move
    when the contacts are taken away (on the H1 walk and loco, whose rewards
    have no contact term, the gait term moves instead)."""
    example, env = task["example"], task["env"]
    nxt, _ = _replayed(example)
    ps = nxt.pipeline_state
    far = ps.replace(contact=dataclasses.replace(ps.contact, dist=ps.contact.dist + 1.0, pos=ps.contact.pos + 10.0))
    rng = np.random.default_rng(7)
    st = expand_state(env.reset(), 4)
    action = torch.tensor(rng.uniform(-1, 1, (4, env.action_size)))
    a = env.step(st, action, ps).reward
    b = env.step(st, action, far).reward
    assert (a - b).abs().max() > 1e-3


def test_info_matches_jax_on_replayed_data(task):
    nxt, outs = _replayed(task["example"])
    for key in INFO_KEYS[task["example"]]:
        for i, js in enumerate(outs):
            np.testing.assert_allclose(
                nxt.info[key][i].numpy().astype(np.float64), np.asarray(js.info[key], np.float64),
                atol=1e-6, err_msg=f"{key}, sample {i}",
            )


def test_state_from_numpy_takes_the_jax_state(task):
    """The JAX env's State after the replayed step, as numpy leaves, becomes
    the port's State: info kinds kept (int32 step, bool contacts), rng dropped."""
    nxt, outs = _replayed(task["example"])
    js = outs[1]
    leaves = dict(
        pipeline_state={k: np.asarray(getattr(js.pipeline_state, k)) for k in ("qpos", "qvel", "ctrl", "time", "x_pos", "x_rot")},
        obs=np.asarray(js.obs), reward=np.asarray(js.reward), done=np.asarray(js.done),
        info={k: (np.asarray(v) if isinstance(v, jax.Array) else v) for k, v in js.info.items()},
    )
    back = convert.state_from_numpy(leaves, dtype=F64, batched=False)
    assert "rng" not in back.info and back.info["step"].dtype == torch.int32
    np.testing.assert_allclose(back.pipeline_state.qpos.numpy(), nxt.pipeline_state.qpos[1:2].numpy(), atol=1e-12)
    for key in INFO_KEYS[task["example"]]:
        np.testing.assert_allclose(back.info[key].numpy().astype(np.float64), nxt.info[key][1:2].numpy().astype(np.float64), atol=1e-6)
    feet = 4 if task["example"] == "unitree_go2_crate_climb" else 2
    assert back.info["last_contact"].dtype == torch.bool and back.info["last_contact"].shape == (1, feet)


# ---------------------------------------------------------------------------
# golden trajectories
# ---------------------------------------------------------------------------

_GOLDEN_RUNS = {}


def _golden_run(example):
    if example not in _GOLDEN_RUNS:
        t = _task(example)
        cfg, env = t["cfg"], t["env"]
        pl = MBDPI(cfg, env)
        shape = (cfg.Nsample, cfg.Hnode + 1, pl.nu)
        draws = _jax_draws(cfg.seed, [(cfg.Ndiffuse_init, shape)] + [(cfg.Ndiffuse, shape)] * (cfg.n_steps - 1))
        st = env.reset()
        Y = torch.zeros(cfg.Hnode + 1, pl.nu, dtype=F64)
        Ys, rewards, qpos = [], [], []
        for k in range(cfg.n_steps):
            st, Y, _ = pl.control_step(st, Y, draws[k].shape[0], eps=torch.tensor(draws[k]))
            Ys.append(Y.numpy())
            rewards.append(float(st.reward))
            qpos.append(st.pipeline_state.qpos[0].numpy())
        _GOLDEN_RUNS[example] = dict(Y=np.stack(Ys), reward=np.asarray(rewards), qpos=np.stack(qpos))
    return _GOLDEN_RUNS[example]


# The goldens were made by the JAX planner with float32 physics under float64
# glue; the port runs float64 throughout. The float32 rounding of the
# reference's rollout rewards passes through the softmax divided by their
# spread and the 0.05 temperature, so the trot golden's tolerances hold (Y
# 2e-5, reward 5e-6, qpos 2e-6) except for Y on two tasks: the H1 loco's
# second annealing level has rewards spread by 0.043 (trot 0.133), and the
# crate climb's rewards are about 1.9 (trot 0.68) over a spread of 0.11-0.17,
# three times the trot's amplification of about three times the rounding:
# Y is held to 1e-4 there.
GOLDEN_Y_TOL = {"unitree_h1_loco": 1e-4, "unitree_go2_crate_climb": 1e-4}


@pytest.mark.parametrize("what", ["Y", "reward", "qpos"])
@pytest.mark.parametrize("example", EXAMPLES)
def test_control_step_reproduces_golden(example, what):
    ref = np.load(os.path.join(GOLDEN_DIR, example + ".npz"))
    got = _golden_run(example)[what]
    tol = {"Y": GOLDEN_Y_TOL.get(example, 2e-5), "reward": 5e-6, "qpos": 2e-6}[what]
    assert got.shape == ref[what].shape
    np.testing.assert_allclose(got, ref[what], atol=tol)
