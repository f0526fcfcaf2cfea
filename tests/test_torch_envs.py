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
from tests import reference_utils
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
    "allegro_reorient": ["ang_vel_tar", "pos_tar", "step"],
}
ALLEGRO = "allegro_reorient"


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
_REPLAY_INPUTS = {}


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
    _REPLAY_INPUTS[example] = (st, action, nxt_ps)
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


# Where the physics blows up, a reward term of weight 0 can overflow while the
# weighted ones stay finite: 0 x inf then makes the reference's reward NaN, and
# its planner drops the rollout. The port computes those terms too, so that its
# reward is NaN on the same states (before it was finite there, and the
# rollout kept a weight).
@pytest.mark.parametrize("field", ["x_pos", "xd_vel", "qvel", "site_xpos", "x_rot", "xd_ang"])
def test_reward_is_nan_where_the_references_is(task, field):
    """The replayed step's next Data with one value of ``field`` set to
    1e100, 1e155, 1e160, 1e200 (finite in float64) in samples 0-3: the port's
    reward is NaN exactly where the reference's is (the reference casts its
    reward to float32, so only NaN, not overflow, is compared)."""
    example, env, jenv = task["example"], task["env"], task["jenv"]
    _replayed(example)
    st, action, nxt_ps = _REPLAY_INPUTS[example]
    v = getattr(nxt_ps, field).clone()
    for i, big in enumerate((1e100, 1e155, 1e160, 1e200)):
        v[i].view(-1)[i % v[i].numel()] = big
    ps = nxt_ps.replace(**{field: v})
    got = env.step(st, action, ps).reward
    step_j = jax.jit(jenv.step)
    for i in range(4):
        js = JaxState(
            _jax_data(jenv.sys, st.pipeline_state, i), jnp.asarray(st.obs[i].numpy()),
            jnp.asarray(st.reward[i].numpy(), jnp.float32), jnp.asarray(st.done[i].numpy(), jnp.float32), {},
            _jax_info(st.info, i),
        )
        ref = float(step_j(js, jnp.asarray(action[i].numpy()), _jax_data(jenv.sys, ps, i)).reward)
        assert np.isnan(ref) == bool(torch.isnan(got[i])), (field, i, ref, float(got[i]))


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


def _jax_float64_run(example):
    """The goldens' run (tests/golden_utils.py, the same OVERRIDES and seed)
    of the JAX planner with float64 physics: the models and data put in
    float64, the spline maps in float64, and the envs' float32 pins (rewards,
    info) taken as float64, for this call only."""
    import functools

    from dial_mpc_tpu.core import dial_core as jax_dial_core
    from dial_mpc_tpu.physics import model as jax_model
    from dial_mpc_tpu.utils.spline import FixedSpline as JaxFixedSpline
    from tests.golden_utils import run_case

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_model, "put_model", functools.partial(jax_model.put_model, dtype=jnp.float64))
        mp.setattr(jax_model, "make_data", functools.partial(jax_model.make_data, dtype=jnp.float64))
        mp.setattr(jax_dial_core, "FixedSpline", functools.partial(JaxFixedSpline, dtype=jnp.float64))
        mp.setattr(jnp, "float32", jnp.float64)
        return run_case(example)


def jax_float64_reference(example):
    """_jax_float64_run in a process of its own, on the CPU in float64 as the
    goldens' run (tests/conftest.py) but without the persistent compilation
    cache: XLA:CPU (jax 0.9.0) aborted reading back the entries this run
    writes (tests/reference_data/planner_float64_<example>.npz)."""
    import subprocess
    import sys
    import tempfile

    with tempfile.TemporaryDirectory() as tmp_dir:
        out = os.path.join(tmp_dir, example + ".npz")
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        code = ("import sys, numpy as np, jax; sys.path.insert(0, %r); "
                "jax.config.update('jax_platforms', 'cpu'); jax.config.update('jax_enable_x64', True); "
                "from tests.test_torch_envs import _jax_float64_run; "
                "np.savez(%r, **_jax_float64_run(%r))" % (root, out, example))
        env = {**os.environ, "JAX_PLATFORMS": "cpu", "DIAL_MPC_PALLAS": "0", "DIAL_MPC_ENGINE": "xla"}
        r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=root, env=env)
        assert r.returncode == 0, r.stderr[-4000:]
        with np.load(out) as z:
            return {**{"in." + k: v for k, v in OVERRIDES.items()}, **{k: z[k] for k in z.files}}


@pytest.mark.parametrize("what,tol", [("Y", 2e-5), ("reward", 5e-6), ("qpos", 2e-6)])
@pytest.mark.parametrize("example", ["unitree_h1_loco", "unitree_go2_crate_climb"])
def test_control_step_matches_float64_reference(example, what, tol):
    """The golden Y tolerance of H1 loco and the crate climb (GOLDEN_Y_TOL)
    rests on an argument: the goldens' float32 rewards, amplified by the
    softmax. Measured here: the JAX planner run with float64 physics (stored
    data), and the port (float64) held to it at the trot golden's tolerances."""
    ref = reference_utils.load(f"planner_float64_{example}", **OVERRIDES)[what]
    got = _golden_run(example)[what]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=tol)


@pytest.mark.parametrize("what", ["Y", "reward", "qpos"])
@pytest.mark.parametrize("example", EXAMPLES)
def test_control_step_reproduces_golden(example, what):
    ref = np.load(os.path.join(GOLDEN_DIR, example + ".npz"))
    got = _golden_run(example)[what]
    tol = {"Y": GOLDEN_Y_TOL.get(example, 2e-5), "reward": 5e-6, "qpos": 2e-6}[what]
    assert got.shape == ref[what].shape
    np.testing.assert_allclose(got, ref[what], atol=tol)


# ---------------------------------------------------------------------------
# the Allegro in-hand reorientation task
# ---------------------------------------------------------------------------

def test_allegro_is_registered_position_only():
    t = _task(ALLEGRO)
    env, jenv = t["env"], t["jenv"]
    assert type(env).__name__ == "AllegroReorientEnv" and env.action_size == 16
    assert env._object_body_idx == 1 and env._n_frames == 4  # dt 0.02 over timestep 0.005
    assert float(env.sys.opt.timestep) == 0.005 and not env.sys.opt.disable_eulerdamp
    # targets are offsets from the keyframe pose, clipped to the joint range
    act = np.random.default_rng(3).uniform(-1.5, 1.5, (5, 16))
    np.testing.assert_allclose(
        env.act2joint(torch.tensor(act)).numpy(),
        np.stack([np.asarray(jenv.act2joint(jnp.asarray(a))) for a in act]), atol=1e-12,
    )
    cfg = dataclasses.replace(env._config, leg_control="torque")
    torque_env = torch_envs.get_environment(ALLEGRO, cfg, device="cpu", dtype=F64)
    st = torque_env.reset()
    with pytest.raises(NotImplementedError, match="position control only"):
        torque_env.step(st, torch.zeros(1, 16, dtype=F64))


def test_allegro_done_is_one_value_a_sample_on_reset_and_step():
    """The reference's note (manipulation.py): its upstream returned another
    shape of done from step than from reset; here both give one a sample,
    and it turns on after 100 steps."""
    env = _task(ALLEGRO)["env"]
    st = env.reset()
    assert st.done.shape == (1,) and st.reward.shape == (1,)
    st2 = expand_state(st, 2)
    st2 = st2.replace(info={**st2.info, "step": torch.tensor([99, 100], dtype=torch.int32)})
    nxt = env.step(st2, torch.zeros(2, 16, dtype=F64))
    assert nxt.done.shape == (2,) and nxt.done.tolist() == [0.0, 1.0]
    assert nxt.info["step"].tolist() == [100, 101]


@pytest.mark.parametrize("what,tol", [("reward", 1e-5), ("done", 0.0), ("ctrl", 1e-9)])
def test_allegro_step_matches_jax_on_replayed_data(what, tol):
    """The reward (the ball's angular velocity in the reference's units, its
    position, the fingers' pose) on the port's next Data replayed into the
    JAX env; float32 there, so 1e-5."""
    nxt, outs = _replayed(ALLEGRO)
    for i, js in enumerate(outs):
        got = {"reward": nxt.reward, "done": nxt.done, "ctrl": nxt.pipeline_state.ctrl}[what][i]
        ref = {"reward": js.reward, "done": js.done, "ctrl": js.pipeline_state.ctrl}[what]
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol, err_msg=f"sample {i}")
    for key in INFO_KEYS[ALLEGRO]:
        for i, js in enumerate(outs):
            np.testing.assert_allclose(nxt.info[key][i].numpy().astype(np.float64),
                                       np.asarray(js.info[key], np.float64), atol=1e-6)


def test_allegro_golden_physics_steps():
    """The Allegro golden (tests/golden/allegro_reorient.npz) over the control
    steps whose executed control is the plan's pinned first node (zero, from
    the zero start plan): the first two, whose reward and state follow from
    the physics and the reward stack alone (trot golden tolerances: reward
    5e-6, qpos 2e-6), and that node of the first plan. The rest of the plan Y
    is not reproduced: from the first step it parts from the golden by up to
    2 (actions saturate at +/-1), and so does the third step's state. The
    golden ran float32 physics, whose rollouts of this task part from float64
    ones by far more than the port's parts from the reference's float64
    (test_allegro_first_control_step_matches_float64_reference)."""
    t = _task(ALLEGRO)
    cfg, env = t["cfg"], t["env"]
    pl = MBDPI(cfg, env)
    shape = (cfg.Nsample, cfg.Hnode + 1, pl.nu)
    draws = _jax_draws(cfg.seed, [(cfg.Ndiffuse_init, shape), (cfg.Ndiffuse, shape)])
    ref = np.load(os.path.join(GOLDEN_DIR, ALLEGRO + ".npz"))
    st = env.reset()
    Y = torch.zeros(cfg.Hnode + 1, pl.nu, dtype=F64)
    for k in range(2):
        st, Y, _ = pl.control_step(st, Y, draws[k].shape[0], eps=torch.tensor(draws[k]))
        if k == 0:
            Y_first = Y
        np.testing.assert_allclose(float(st.reward), ref["reward"][k], atol=5e-6, err_msg=f"step {k}")
        np.testing.assert_allclose(st.pipeline_state.qpos[0].numpy(), ref["qpos"][k], atol=2e-6, err_msg=f"step {k}")
    np.testing.assert_allclose(Y_first[0].numpy(), ref["Y"][0][0], atol=2e-5)


def _allegro_reference_rollouts(us_path, out_path):
    """The reference's Allegro env, its step jitted for one sample: the
    golden's first executed step (the zero control) from the reset state,
    then each dense control sequence of ``us`` (levels, N, H, nu) rolled out
    from there. Twice: as the goldens ran it (float32 physics), and in
    float64 (the models, data and the env's float32 pins taken as float64,
    as in _jax_float64_run). Saves the rewards (2, levels, N, H), float32
    first."""
    import functools

    from dial_mpc_tpu.physics import model as jax_model

    def rollouts():
        cfgd = _config(ALLEGRO)
        jcfg = load_dataclass_from_dict(JaxDialConfig, cfgd)
        jenv = jax_envs.get_environment(
            jcfg.env_name, load_dataclass_from_dict(jax_envs.get_config(jcfg.env_name), cfgd, convert_list_to_array=True)
        )
        step = jax.jit(jenv.step)
        start = step(jax.jit(jenv.reset)(jax.random.PRNGKey(jcfg.seed)), jnp.zeros(jenv.action_size))
        us = np.load(us_path)
        rews = np.zeros(us.shape[:3])
        for level in range(us.shape[0]):
            for n in range(us.shape[1]):
                s = start
                for t in range(us.shape[2]):
                    s = step(s, jnp.asarray(us[level, n, t]))
                    rews[level, n, t] = float(s.reward)
        return rews

    rews32 = rollouts()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_model, "put_model", functools.partial(jax_model.put_model, dtype=jnp.float64))
        mp.setattr(jax_model, "make_data", functools.partial(jax_model.make_data, dtype=jnp.float64))
        mp.setattr(jnp, "float32", jnp.float64)
        rews64 = rollouts()
    np.save(out_path, np.stack([rews32, rews64]))


def _reference_weights(rews, temp):
    """The reference's MPPI weights of one level (dial_core.reverse_once),
    re-derived in numpy from per-step rewards (N, H): the mean rollout is the
    centre, the spread is the finite rewards' standard deviation, a
    non-finite reward gets no weight, and if none is finite the mean row
    takes it all."""
    r = rews.mean(-1)
    finite = np.isfinite(r)
    if not finite.any():
        return np.eye(len(r))[-1]
    center = r[-1] if finite[-1] else 0.0
    std = np.std(r[finite])
    std = std if np.isfinite(std) and std > 0 else 1.0
    logp = np.where(finite, (np.where(finite, r, 0.0) - center) / std / temp, -np.inf)
    w = np.exp(logp - logp[finite].max())
    return w / w.sum()


def test_allegro_first_control_step_matches_float64_reference(tmp_path):
    """The Allegro planner against the reference at the golden's OVERRIDES:
    the two annealing levels of the first control step, sample by sample.
    The port (float64) draws the JAX runner's noise, forms each level's node
    samples and dense controls, rolls them out and weights them; the
    reference's env in float64, its step jitted for one sample (a process of
    its own, without the persistent compilation cache), rolls out the same
    controls from the same state. Which rollouts explode must agree; each
    rollout's mean reward within 1e-4 of its size (an exploding rollout, mean
    reward -229, parts from the reference by 9e-6 of it through float64
    rounding), and each level's plan within the trot golden's 2e-5 of the
    reference's weights (re-derived from the reference's rewards) applied to
    the same samples."""
    import subprocess
    import sys

    from dial_mpc_tpu_torch.core.dial_core import rollout_us

    t = _task(ALLEGRO)
    cfg, env = t["cfg"], t["env"]
    pl = MBDPI(cfg, env)
    shape = (cfg.Nsample, cfg.Hnode + 1, pl.nu)
    draws = torch.tensor(_jax_draws(cfg.seed, [(cfg.Ndiffuse_init, shape)])[0])
    Y = torch.zeros(cfg.Hnode + 1, pl.nu, dtype=F64)
    start = env.step(env.reset(), Y[:1])
    Y = pl.shift(Y)
    factors = pl.diffuse_factors(cfg.Ndiffuse_init)
    us, rews, samples, plans = [], [], [], []
    for level in range(cfg.Ndiffuse_init):
        Y0s = pl.sample_nodes(Y, factors[level], draws[level])
        u = pl.node2u(Y0s)
        r, _ = rollout_us(env.step, expand_state(start, u.shape[0]), u)
        Y_next, info = pl.reverse_once(start, Y, factors[level], draws[level])
        torch.testing.assert_close(info["rews"], r.mean(-1), rtol=0, atol=0, equal_nan=True)
        us.append(u.numpy()), rews.append(r.numpy()), samples.append(Y0s.numpy()), plans.append(Y_next.numpy())
        Y = Y_next

    us_path, out_path = str(tmp_path / "us.npy"), str(tmp_path / "rews.npy")
    np.save(us_path, np.stack(us))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, jax; sys.path.insert(0, %r); "
            "jax.config.update('jax_platforms', 'cpu'); jax.config.update('jax_enable_x64', True); "
            "from tests.test_torch_envs import _allegro_reference_rollouts; "
            "_allegro_reference_rollouts(%r, %r)" % (root, us_path, out_path))
    env_vars = {**os.environ, "JAX_PLATFORMS": "cpu", "DIAL_MPC_PALLAS": "0", "DIAL_MPC_ENGINE": "xla"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=root, env=env_vars)
    assert r.returncode == 0, r.stderr[-4000:]
    ref32, ref = np.load(out_path)

    for level in range(cfg.Ndiffuse_init):
        got, want = rews[level].mean(-1), ref[level].mean(-1)
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want), err_msg=f"level {level}: exploded")
        ok = np.isfinite(want)
        assert ok.sum() >= 2, f"level {level}: {ok.sum()} finite rollouts"
        np.testing.assert_allclose(got[ok], want[ok], rtol=1e-4, atol=5e-6, err_msg=f"level {level}")
        plan = np.einsum("n,nij->ij", _reference_weights(ref[level], cfg.temp_sample), samples[level])
        np.testing.assert_allclose(plans[level], plan, atol=2e-5, err_msg=f"level {level}")
    # The golden ran these rollouts in float32: there the same controls part
    # from the float64 ones far beyond the port's parting (a rollout's mean
    # reward by a factor, where the port's stay within 1e-4 of it), which is
    # why the golden's plan is not reproduced at float64 (the golden test).
    both = np.isfinite(ref32[0].mean(-1)) & np.isfinite(ref[0].mean(-1))
    apart = np.abs(ref32[0].mean(-1) - ref[0].mean(-1))[both] / np.maximum(1.0, np.abs(ref[0].mean(-1))[both])
    assert apart.max() > 0.1, apart
