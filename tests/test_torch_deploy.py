"""The port's asynchronous deploy path against the JAX package's.

The shm bus (and the two packages' buses on one set of segments), the
publisher's tick (``MBDPublisher._plan`` and ``main_loop``) with the JAX
draws injected, the state injection, the checkpoint, a sync-mode sim2sim run
over the real bus, the launchers, the seq-jump viewer overlay, the
localization registry and the real-robot host's refusal without its SDK.

CPU only (``device="cpu"``), float64 unless said otherwise. The port's own
buses have segment names of this run (``shm.run_prefix``), created with
``reclaim=False``: no other run's bus is met or taken over. Where the JAX
package's bus takes part (the interop cases) the names are the fixed ones,
which the JAX bus alone knows; there a port creator refuses segments that
exist, so a run of tests/test_deploy.py beside this one makes those tests
fail, never cross. The JAX publisher's ticks are stored data
(tests/reference_utils.py), made on a bus of the fixed names.

Run with:  python -m pytest tests/test_torch_deploy.py -q
"""

import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch
import yaml

import dial_mpc_tpu.envs as jax_envs
from dial_mpc_tpu.core.dial_config import DialConfig as JaxDialConfig
from dial_mpc_tpu.deploy.planner_proc import MBDPublisher as JaxMBDPublisher
from dial_mpc_tpu.deploy.shm import ShmBus as JaxShmBus
from dial_mpc_tpu.utils.io_utils import load_dataclass_from_dict as jax_load_dataclass

from tests import reference_utils

import dial_mpc_tpu_torch.envs as torch_envs
from dial_mpc_tpu_torch.core.dial_config import DialConfig
from dial_mpc_tpu_torch.core.dial_core import MBDPI
from dial_mpc_tpu_torch.deploy import planner_proc
from dial_mpc_tpu_torch.deploy.planner_proc import MBDPublisher
from dial_mpc_tpu_torch.deploy.shm import ShmBus, run_prefix
from dial_mpc_tpu_torch.physics import engine_cuda, solver_cuda
from dial_mpc_tpu_torch.utils.io_utils import get_example_path, load_dataclass_from_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
SEGMENTS = ("time", "state", "acts", "tau", "refs", "plan_time")
# the small planner of tests/test_deploy.py on the trot deploy example
SMALL = dict(Nsample=8, Hsample=16, Hnode=4, Ndiffuse=1, Ndiffuse_init=2)
PREFIX = run_prefix()  # the segment names of this run's own buses


def _deploy_config(example="unitree_go2_trot_deploy", **overrides):
    with open(get_example_path(example + ".yaml")) as f:
        cfgd = yaml.safe_load(f)
    cfgd.update(overrides)
    return cfgd


def _port(cfgd, dtype=F64):
    cfg = load_dataclass_from_dict(DialConfig, cfgd)
    env_cfg = load_dataclass_from_dict(torch_envs.get_config(cfg.env_name), cfgd, convert_list_to_array=True,
                                       dtype=dtype)
    return cfg, env_cfg, torch_envs.get_environment(cfg.env_name, env_cfg, device="cpu", dtype=dtype)


def _bus_for(env, cfg, prefix=PREFIX):
    mj = env.mj_model
    return ShmBus(mj.nq + mj.nv, mj.nu, cfg.Hsample + 1, create=True, prefix=prefix, reclaim=False)


# ---------------------------------------------------------------------------
# the bus
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("maker,attacher", [("torch", "torch"), ("torch", "jax"), ("jax", "torch")])
def test_shm_bus_roundtrip_and_interop(maker, attacher):
    """Either package's bus attaches to the other's segments, and what one
    side writes the other reads, segment by segment, both ways."""
    cls = {"torch": ShmBus, "jax": JaxShmBus}
    refuse = {"reclaim": False} if maker == "torch" else {}
    bus = cls[maker](nx=37, nu=12, n_acts=17, create=True, **refuse)
    try:
        attached = cls[attacher](nx=37, nu=12, n_acts=17, create=False)
        try:
            rng = np.random.default_rng(0)
            for name in SEGMENTS:
                a, b = getattr(bus, name), getattr(attached, name)
                assert a.shape == b.shape and a.dtype == b.dtype == np.float32
                a[...] = rng.normal(size=a.shape)
                np.testing.assert_array_equal(b, a)
                b[...] = rng.normal(size=b.shape)
                np.testing.assert_array_equal(a, b)
            assert (bus.state.shape, bus.acts.shape, bus.refs.shape) == ((37,), (17, 12), (17, 12, 3))
        finally:
            attached.close()
    finally:
        bus.close()
    with pytest.raises(FileNotFoundError):  # the creator unlinked every segment
        ShmBus(nx=37, nu=12, n_acts=17, create=False, attach_timeout=0.0)


def test_shm_bus_reclaims_leaked_segments():
    """A creator finding segments a crashed producer left behind replaces them."""
    leaked = ShmBus(nx=5, nu=2, n_acts=3, create=True, prefix=PREFIX)
    leaked.acts[:] = 7.0
    for s in leaked._segs:  # the producer crashed: closed, never unlinked
        s.close()
    bus = ShmBus(nx=5, nu=2, n_acts=3, create=True, prefix=PREFIX)
    try:
        attached = ShmBus(nx=5, nu=2, n_acts=3, create=False, prefix=PREFIX)
        assert (attached.acts == 0.0).all()
        attached.close()
    finally:
        bus.close()


def test_shm_bus_refuses_live_segments_without_reclaim():
    """With reclaim=False a creator meeting another bus's segments raises and
    leaves that bus as it was; one meeting a single later segment unlinks the
    segments it had made before raising; a bus of another prefix is a bus of
    its own."""
    from multiprocessing import shared_memory

    live = ShmBus(nx=5, nu=2, n_acts=3, create=True, prefix=PREFIX)
    try:
        live.acts[:] = 7.0
        with pytest.raises(FileExistsError):
            ShmBus(nx=5, nu=2, n_acts=3, create=True, prefix=PREFIX, reclaim=False)
        assert (live.acts == 7.0).all()
        other = ShmBus(nx=5, nu=2, n_acts=3, create=True, prefix=run_prefix(), reclaim=False)
        try:
            assert (other.acts == 0.0).all() and (live.acts == 7.0).all()
        finally:
            other.close()
    finally:
        live.close()
    planted = shared_memory.SharedMemory(name=PREFIX + "acts_shm", create=True, size=24)
    try:
        with pytest.raises(FileExistsError):
            ShmBus(nx=5, nu=2, n_acts=3, create=True, prefix=PREFIX, reclaim=False)
        for name in ("time_shm", "state_shm"):  # made before acts_shm was met
            with pytest.raises(FileNotFoundError):
                shared_memory.SharedMemory(name=PREFIX + name)
    finally:
        planted.close()
        planted.unlink()


# ---------------------------------------------------------------------------
# the publisher against the JAX publisher
# ---------------------------------------------------------------------------

def _jax_side(cfgd):
    cfg = jax_load_dataclass(JaxDialConfig, cfgd)
    env_cfg = jax_load_dataclass(jax_envs.get_config(cfg.env_name), cfgd, convert_list_to_array=True)
    return cfg, env_cfg, jax_envs.get_environment(cfg.env_name, env_cfg)


def _measured_states(env, n, seed=3):
    """n float32 (q, qd) near the home keyframe, as a robot would publish."""
    rng = np.random.default_rng(seed)
    home = env.mj_model.keyframe_qpos("home")
    out = []
    for _ in range(n):
        q = home.copy()
        q[:3] += rng.normal(scale=[0.02, 0.02, 0.01])
        q[7:] += rng.normal(scale=0.1, size=q.shape[0] - 7)
        qd = rng.normal(scale=0.2, size=env.mj_model.nv)
        out.append((q.astype(np.float32), qd.astype(np.float32)))
    return out


# (time the tick starts, shift_time main_loop gives _plan); the third tick
# comes 0.5 s later, past the reset threshold ctrl_dt * n_acts = 0.34 s, so
# main_loop zeroes Y and plans with shift 0 there
SCHEDULE = (0.0, 0.013, 0.513)


def _levels(cfg, tick):
    return cfg.Ndiffuse_init if tick == 0 else cfg.Ndiffuse


def _jax_tick_draws(cfg, nu):
    """The draws the JAX publisher's key gives its levels, tick by tick."""
    rng = jax.random.PRNGKey(cfg.seed)
    out = []
    for tick in range(len(SCHEDULE)):
        levels = []
        for _ in range(_levels(cfg, tick)):
            rng, sub = jax.random.split(rng)
            levels.append(np.asarray(jax.random.normal(sub, (cfg.Nsample, cfg.Hnode + 1, nu))))
        out.append(np.stack(levels))
    return out


def _run_schedule(pub, bus, states, wrap):
    """pub.main_loop over SCHEDULE: the bus holds each tick's time and state
    when the tick starts (written when the previous tick's solve returns, as
    an actuation side would have); returns what each tick's solve gave."""
    nq = pub.nq
    bus.time[0] = SCHEDULE[0]
    bus.state[:nq], bus.state[nq:] = states[0]
    seen = []

    def after(out, tick):
        seen.append(out)
        if tick + 1 < len(SCHEDULE):
            bus.time[0] = SCHEDULE[tick + 1]
            bus.state[:nq], bus.state[nq:] = states[tick + 1]
        return out

    wrap(pub, lambda out: after(out, len(seen)))
    pub.main_loop(max_iters=len(SCHEDULE), verbose=False)
    return seen


def _measured_inputs(states):
    return {f"{k}{tick}": v for tick, (q, qd) in enumerate(states) for k, v in (("q", q), ("qd", qd))}


def jax_schedule_reference():
    """The JAX publisher through the three ticks of SCHEDULE on a bus of the
    fixed names, the only ones it knows (tests/reference_data/
    deploy_schedule.npz): what each tick's solve gave (Y, packed), what it
    left on the bus, and init_state then update_state at each tick's state."""
    cfgd = _deploy_config(**SMALL)
    _, _, env = _port(cfgd)
    jcfg, jenv_cfg, jenv = _jax_side(cfgd)
    states = _measured_states(env, len(SCHEDULE))
    bus = _bus_for(env, jcfg, prefix="")
    try:
        jpub = JaxMBDPublisher(jenv, jenv_cfg, jcfg)

        def wrap_jax(p, after):
            for name in ("_plan_init", "_plan_warm"):
                fn = getattr(p, name)
                setattr(p, name, lambda *a, fn=fn: after(tuple(np.asarray(x) for x in fn(*a))))

        seen = _run_schedule(jpub, bus, states, wrap_jax)
        out = {"in." + k: v for k, v in _measured_inputs(states).items()}
        out.update({f"bus.{name}": np.array(getattr(bus, name)) for name in SEGMENTS})
        for tick, ((Y, _, packed), s, t) in enumerate(zip(seen, states, SCHEDULE)):
            jst = jpub.update_state(jpub.init_state(*states[0]), *s, t)
            out.update({f"{tick}.Y": Y, f"{tick}.packed": packed, f"{tick}.qpos": jst.pipeline_state.qpos,
                        f"{tick}.qvel": jst.pipeline_state.qvel, f"{tick}.step": jst.info["step"],
                        f"{tick}.obs": jst.obs})
        jpub.close()
    finally:
        bus.close()
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def schedule_runs():
    """The JAX publisher (stored data) and the port's (float64, the JAX draws
    injected) through the same three ticks on a bus."""
    cfgd = _deploy_config(**SMALL)
    cfg, env_cfg, env = _port(cfgd)
    states = _measured_states(env, len(SCHEDULE))
    ref = reference_utils.load("deploy_schedule", **_measured_inputs(states))
    jax_seen = [(ref[f"{tick}.Y"], None, ref[f"{tick}.packed"]) for tick in range(len(SCHEDULE))]
    jax_bus = {name: ref[f"bus.{name}"] for name in SEGMENTS}
    jstates = [reference_utils.nested(ref, str(tick)) for tick in range(len(SCHEDULE))]
    draws = _jax_tick_draws(cfg, env.action_size)
    bus = _bus_for(env, cfg)
    try:
        pub = MBDPublisher(env, env_cfg, cfg, bus_prefix=PREFIX)
        shifts = []

        def wrap_port(p, after):
            plan = p._plan

            def injected(state, Y, shift_time, n_diffuse, eps=None):
                tick = len(shifts)
                shifts.append(shift_time)
                assert eps is None and n_diffuse == _levels(cfg, tick)
                Y, packed = plan(state, Y, shift_time, n_diffuse, eps=torch.tensor(draws[tick]))
                return after((Y, packed))

            p._plan = injected

        port_seen = _run_schedule(pub, bus, states, wrap_port)
        port_bus = {name: np.array(getattr(bus, name)) for name in SEGMENTS}
        ports = [pub.update_state(pub.init_state(*states[0]), *s, t) for s, t in zip(states, SCHEDULE)]
        pub.close()
    finally:
        bus.close()
    return dict(cfg=cfg, env=env, pub=pub, jax=jax_seen, port=port_seen, jax_bus=jax_bus, port_bus=port_bus,
                shifts=shifts, jstates=jstates, states=ports, measured=states)


def test_schedule_takes_each_branch(schedule_runs):
    """The first tick runs Ndiffuse_init levels, the second shifts by a
    fraction of a control step, the third comes past the reset threshold."""
    shifts = schedule_runs["shifts"]
    assert shifts[0] == 0.0 and shifts[1] == pytest.approx(0.013, abs=1e-7) and shifts[2] == 0.0
    assert len(schedule_runs["port"]) == len(schedule_runs["jax"]) == 3


def _unpack(cfg, env, packed):
    na, nu = cfg.Hsample + 1, env.action_size
    nb = min(nu, env.mj_model.nbody - 2)
    packed = np.asarray(packed, np.float64)
    return dict(acts=packed[: na * nu], tau=packed[na * nu : 2 * na * nu], refs=packed[2 * na * nu :].reshape(na, nb, 3))


# The JAX publisher runs float32 physics under float64 glue, the port float64
# throughout: the plans agree at the planner tests' golden tolerance (Y 2e-5,
# tests/test_torch_planner.py). Joint targets are act2joint of the plan
# (a slope of at most 0.725 rad), torques kp = 30 times the targets, and both
# are rounded to float32 on the bus (torques up to ~50 N m: 4e-6); the refs
# are body positions averaged over the rollouts under the softmax weights,
# held like the golden's qpos, times the ten-odd rollout steps they span.
PLAN_TOL = {"Y": 2e-5, "acts": 2e-5, "tau": 6e-4, "refs": 2e-5}


@pytest.mark.parametrize("tick", range(len(SCHEDULE)))
@pytest.mark.parametrize("what", ["Y", "acts", "tau", "refs"])
def test_plan_matches_jax_publisher(schedule_runs, tick, what):
    r = schedule_runs
    jY, _, jpacked = r["jax"][tick]
    Y, packed = r["port"][tick]
    if what == "Y":
        got, ref = Y.numpy(), jY
    else:
        got = _unpack(r["cfg"], r["env"], packed.numpy())[what]
        ref = _unpack(r["cfg"], r["env"], jpacked)[what]
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=PLAN_TOL[what])


@pytest.mark.parametrize("name", SEGMENTS)
def test_bus_after_the_ticks_matches_jax_publisher(schedule_runs, name):
    """What each publisher left on the bus: the last tick's plan, its time."""
    got, ref = schedule_runs["port_bus"][name], schedule_runs["jax_bus"][name]
    tol = {"acts": PLAN_TOL["acts"], "tau": PLAN_TOL["tau"], "refs": PLAN_TOL["refs"]}.get(name, 0.0)
    np.testing.assert_allclose(got, ref, atol=tol)
    if name == "plan_time":
        assert got[0] == np.float32(SCHEDULE[-1])


@pytest.mark.parametrize("tick", range(len(SCHEDULE)))
def test_init_and_update_state_match_jax(schedule_runs, tick):
    """init_state at the first measured state, then update_state to each
    tick's: qpos and qvel as measured (float32 values), the step count, and
    the reset's observation at the measured state."""
    st, jst = schedule_runs["states"][tick], schedule_runs["jstates"][tick]
    q, qd = schedule_runs["measured"][tick]
    assert st.pipeline_state.qpos.dtype == F64 and st.pipeline_state.qpos.shape == (1, q.shape[0])
    np.testing.assert_array_equal(st.pipeline_state.qpos[0].numpy(), q.astype(np.float64))
    np.testing.assert_array_equal(st.pipeline_state.qvel[0].numpy(), np.asarray(jst["qvel"], np.float64))
    np.testing.assert_array_equal(st.pipeline_state.qpos[0].numpy(), np.asarray(jst["qpos"], np.float64))
    assert st.info["step"].dtype == torch.int32 and st.info["step"].tolist() == [int(jst["step"])]
    assert int(st.info["step"][0]) == int(SCHEDULE[tick] / 0.02)
    # init_state's observation (update_state runs no forward pass, as the reference)
    np.testing.assert_allclose(st.obs[0].numpy(), np.asarray(jst["obs"]), atol=1e-5)


def test_update_state_runs_no_forward_pass(schedule_runs):
    """update_state writes qpos and qvel only: the kinematics stay those of
    init_state's state, as in the reference."""
    pub, st = schedule_runs["pub"], schedule_runs["states"][0]
    q, qd = schedule_runs["measured"][2]
    nxt = pub.update_state(st, q, qd, 0.1)
    assert torch.equal(nxt.pipeline_state.x_pos, st.pipeline_state.x_pos)
    assert not torch.equal(nxt.pipeline_state.qpos, st.pipeline_state.qpos)
    assert int(nxt.info["step"][0]) == 5 and int(st.info["step"][0]) == 0


# ---------------------------------------------------------------------------
# the host loop and the checkpoint
# ---------------------------------------------------------------------------

@pytest.fixture
def small_publisher():
    cfgd = _deploy_config(**{**SMALL, "Nsample": 4})
    cfg, env_cfg, env = _port(cfgd)
    bus = _bus_for(env, cfg)
    bus.state[: env.mj_model.nq] = env.mj_model.keyframe_qpos("home")
    made = []

    def make(**kw):
        made.append(MBDPublisher(env, env_cfg, cfg, bus_prefix=PREFIX, **kw))
        return made[-1]

    try:
        yield make, bus, env
    finally:
        for p in made:
            p.close()
        bus.close()


def test_main_loop_on_the_cpu(small_publisher, capsys):
    """Four ticks: the latency holds the three warm ones, nothing launched a
    kernel, and the plan is on the bus."""
    make, bus, env = small_publisher
    pub = make()
    assert bus.plan_time[0] == np.float32(-0.02) and (bus.refs == 1.0).all()
    before = (engine_cuda.step_core.launches, solver_cuda.solve_batched.launches)
    pub.main_loop(max_iters=4, verbose=True)
    assert pub.last_latency["n"] == 3
    assert (engine_cuda.step_core.launches, solver_cuda.solve_batched.launches) == before
    assert np.isfinite(bus.tau).all() and np.abs(bus.tau).max() > 0 and bus.plan_time[0] == 0.0
    assert not np.allclose(bus.refs[:, : pub._nb], 1.0)
    out = capsys.readouterr().out
    assert "plan latency: n=3" in out and "First DIAL-MPC solve" in out
    assert isinstance(pub.mbdpi, MBDPI) and pub.Y.dtype == F64 and pub.Y.shape == (5, 12)


def test_checkpoint_round_trip_is_bit_exact(small_publisher, tmp_path):
    """A publisher resumed from a checkpoint plans its next tick exactly as
    the uninterrupted one does: same plan, same generator state."""
    make, bus, env = small_publisher
    path = str(tmp_path / "planner.npz")
    a = make(checkpoint_path=path)
    a.main_loop(max_iters=2, verbose=False)
    a.save_checkpoint()
    q, qd = bus.state[: a.nq].copy(), bus.state[a.nq :].copy()
    state = a.update_state(a.init_state(q, qd), q, qd, 0.04)
    Y_a, packed_a = a._plan(state, a.Y, 0.013, 1)
    b = make(checkpoint_path=path)
    Y_b, packed_b = b._plan(state, b.Y, 0.013, 1)
    assert not torch.equal(Y_a, torch.zeros_like(Y_a))
    assert torch.equal(Y_a, Y_b) and torch.equal(packed_a, packed_b)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_checkpoint_of_the_jax_package_is_not_read(small_publisher, tmp_path, capsys):
    """The JAX package's checkpoint holds (Y, rng): the port warns and starts
    from a zero plan and its own seed."""
    make, bus, env = small_publisher
    path = str(tmp_path / "jax.npz")
    np.savez(path, Y=np.ones((5, 12)), rng=np.zeros(2, np.uint32))
    pub = make(checkpoint_path=path)
    assert "checkpoint restore failed" in capsys.readouterr().out
    assert torch.equal(pub.Y, torch.zeros(5, 12, dtype=F64))
    assert torch.equal(pub.generator.get_state(), torch.Generator().manual_seed(0).get_state())


def test_mesh_sharding_in_one_process_plans_alone(small_publisher):
    """Without a process group of more than one rank, "mesh" plans as "none"
    does (MBDPI, the bus attached), as the reference does on one device."""
    make, bus, env = small_publisher
    for sharding in ("mesh", "none"):
        pub = make(sharding=sharding)
        assert type(pub.mbdpi) is MBDPI and pub.mesh is None and pub.lead and pub.bus is not None


# the planner of tests/test_deploy.py::test_publisher_sharded_mesh
MESH = dict(Nsample=16, Hsample=16, Hnode=4, Ndiffuse=1, Ndiffuse_init=2, kd=0.0, sharding="mesh")


def test_publisher_sharded_mesh(tmp_path):
    """Counterpart of tests/test_deploy.py::test_publisher_sharded_mesh: the
    publisher with sharding "mesh" on two gloo ranks (processes; float64,
    three ticks) on a bus this test made. It builds ShardedMBDPI on both,
    rank 0 alone attaches the bus and publishes finite, non-zero torques and
    body positions, and the ranks end with the same plan, which is within
    1e-10 (float64 reduction order) of a one-rank ShardedMBDPI publisher's
    on the same bus."""
    from test_torch_parallel import spawn_ranks

    from dial_mpc_tpu_torch.parallel import ShardedMBDPI, global_sample_mesh, init_distributed

    cfgd = _deploy_config(**MESH)
    cfg, env_cfg, env = _port(cfgd)
    bus = _bus_for(env, cfg)
    try:
        bus.state[: env.mj_model.nq] = env.mj_model.keyframe_qpos("home")
        ranks = spawn_ranks(dict(kind="publisher", cfgd=cfgd, prefix=PREFIX, ticks=3), 2)
        assert [r["sharded"] for r in ranks] == [True, True]
        assert [r["attached"] for r in ranks] == [True, False]
        assert np.array_equal(ranks[0]["Y"], ranks[1]["Y"])
        assert np.array_equal(ranks[0]["generator"], ranks[1]["generator"])
        taus, acts, refs = np.array(bus.tau), np.array(bus.acts), np.array(bus.refs)
        assert np.isfinite(taus).all() and np.isfinite(acts).all() and np.isfinite(refs).all()
        assert np.abs(taus).max() > 0.0, "sharded planner published empty torques"
        nb = min(env.mj_model.nu, env.mj_model.nbody - 2)
        assert not np.allclose(refs[:, :nb], 1.0) and bus.plan_time[0] == 0.0

        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        init_distributed(f"file://{tmp_path / 'store'}", 1, 0, device="cpu")
        try:
            pub = MBDPublisher(env, env_cfg, cfg, sharding="mesh", bus_prefix=PREFIX)
            assert type(pub.mbdpi) is MBDPI  # a group of one plans alone
            pub.mbdpi = ShardedMBDPI(cfg, env, global_sample_mesh(), pub.generator)
            try:
                pub.main_loop(max_iters=3, verbose=False)
            finally:
                pub.close()
        finally:
            torch.distributed.destroy_process_group()
            torch.set_num_threads(threads)
        np.testing.assert_allclose(ranks[0]["Y"], pub.Y.numpy(), atol=1e-10, rtol=0)
        # the one-rank publisher wrote the same plan's controls over them (float32 bus)
        np.testing.assert_allclose(np.array(bus.tau), taus, atol=1e-4, rtol=0)
        np.testing.assert_allclose(np.array(bus.acts), acts, atol=1e-6, rtol=0)
    finally:
        bus.close()


def test_planner_cli_runs_its_ticks_on_a_prefixed_bus(tmp_path):
    """The planner's command line on the CPU: --bus-prefix names the bus it
    attaches, --ticks stops it, and it leaves its checkpoint."""
    cfgd = _deploy_config(**SMALL)
    cfg, env_cfg, env = _port(cfgd)
    bus = _bus_for(env, cfg)
    cfg_path, ckpt = tmp_path / "deploy.yaml", tmp_path / "planner.npz"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfgd, f)
    try:
        bus.state[: env.mj_model.nq] = env.mj_model.keyframe_qpos("home")
        planner_proc.main(["--config", str(cfg_path), "--device", "cpu", "--bus-prefix", PREFIX, "--ticks", "2",
                           "--checkpoint", str(ckpt)])
        assert np.isfinite(bus.tau).all() and np.abs(bus.tau).max() > 0 and bus.plan_time[0] == 0.0
        with np.load(ckpt) as z:
            assert z["Y"].shape == (cfg.Hnode + 1, env.action_size) and np.isfinite(z["Y"]).all()
    finally:
        bus.close()


def test_planner_cli_defaults_to_the_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    planner_proc.main(["--list-examples"])
    out = capsys.readouterr().out
    assert all(e in out for e in ("unitree_go2_trot_deploy", "unitree_go2_seq_jump_deploy", "unitree_h1_loco_deploy"))
    planner_proc.main(["--example", "unitree_go2_trot"])
    assert "not found" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="cuda"):
        planner_proc.main(["--example", "unitree_go2_trot_deploy"])


@pytest.mark.parametrize("example", ["unitree_go2_trot_deploy", "unitree_go2_seq_jump_deploy", "unitree_h1_loco_deploy"])
def test_deploy_examples_run_a_tick(example):
    """Each deploy example's env is registered and its publisher publishes
    (CPU, Nsample 4, one tick of Ndiffuse_init 1)."""
    cfg, env_cfg, env = _port(_deploy_config(example, Nsample=4, Ndiffuse_init=1))
    bus = _bus_for(env, cfg)
    try:
        bus.state[: env.mj_model.nq] = env.mj_model.keyframe_qpos("home")
        pub = MBDPublisher(env, env_cfg, cfg, bus_prefix=PREFIX)
        try:
            pub.main_loop(max_iters=1, verbose=False)
            assert np.isfinite(bus.tau).all() and np.abs(bus.tau).max() > 0 and bus.plan_time[0] == 0.0
            assert bus.acts.shape == (cfg.Hsample + 1, env.action_size)
        finally:
            pub.close()
    finally:
        bus.close()


# ---------------------------------------------------------------------------
# the sim server, the launchers, the real-robot host
# ---------------------------------------------------------------------------

SIM_SCRIPT = """
import sys; sys.path.insert(0, {repo!r})
from dial_mpc_tpu_torch.deploy.sim_server import DialSim, DialSimConfig
from dial_mpc_tpu_torch.config.base_env_config import BaseEnvConfig
from dial_mpc_tpu_torch.core.dial_config import DialConfig
sim = DialSim(
    DialSimConfig(robot_name="unitree_go2", scene_name="mjx_scene_force.xml",
                  sim_leg_control="torque", plot=False, record=False,
                  real_time_factor=1.0, sim_dt=0.005, sync_mode=True,
                  headless=True),
    BaseEnvConfig(dt=0.02, timestep=0.02),
    DialConfig(Hsample=16),
    max_steps=20,
    bus_prefix={prefix!r},
)
try:
    sim.main_loop()
finally:
    sim.close()
print("SIM_DONE", sim.t)
"""


@pytest.mark.timeout(300)  # its waits: 60 s for the server's bus, 120 s for its exit, the 60 ticks between
def test_sim2sim_sync_integration():
    """The port's sim server (MuJoCo, sync mode) in a subprocess and the
    port's publisher on the CPU over the real bus, held to what
    tests/test_deploy.py holds the JAX package to."""
    proc = subprocess.Popen(
        [sys.executable, "-u", "-c", SIM_SCRIPT.format(repo=ROOT, prefix=PREFIX)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        try:
            ShmBus(nx=37, nu=12, n_acts=17, create=False, attach_timeout=60.0, prefix=PREFIX).close()
        except FileNotFoundError:
            proc.kill()
            out, _ = proc.communicate(timeout=30)
            raise AssertionError(f"sim server never created the shm bus:\n{out[-3000:]}")
        cfg, env_cfg, env = _port(_deploy_config(**SMALL, kd=0.0))
        pub = MBDPublisher(env, env_cfg, cfg, bus_prefix=PREFIX)
        try:
            pub.main_loop(max_iters=60, verbose=False)
            t_sim = float(pub.bus.time[0])
            plan_t = float(pub.bus.plan_time[0])
            taus = np.array(pub.bus.tau)
        finally:
            pub.close()
        assert t_sim > 0.0, "sim clock never advanced"
        assert plan_t >= 0.0, "plan was never published"
        assert np.abs(taus).max() > 0.0, "planner published empty torques"
        out, _ = proc.communicate(timeout=120)
        assert "SIM_DONE" in out, out[-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.mark.parametrize("launcher,host", [("sim2sim", "sim_server"), ("sim2real", "real")])
def test_launchers_start_both_processes_and_wait(launcher, host, monkeypatch):
    """The launcher starts the host and the planner as modules of the port
    and tears both down once the planner exits."""
    import importlib

    mod = importlib.import_module(f"dial_mpc_tpu_torch.deploy.{launcher}")
    started = []
    real_popen = subprocess.Popen

    def popen(cmd, *a, **kw):
        started.append(cmd[1:3])
        return real_popen(cmd, *a, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, **kw)

    monkeypatch.setattr(mod.subprocess, "Popen", popen)
    monkeypatch.chdir(ROOT)
    mod.main(["--list-examples"])
    assert started == [["-m", f"dial_mpc_tpu_torch.deploy.{host}"], ["-m", "dial_mpc_tpu_torch.deploy.planner_proc"]]


def test_real_host_refuses_to_start_without_the_unitree_sdk():
    from dial_mpc_tpu_torch.deploy import real

    if real._HAVE_UNITREE:
        pytest.skip("this machine has the Unitree SDK")
    with pytest.raises(RuntimeError, match="unitree_sdk2py"):
        real.DialReal(real.DialRealConfig(initial_position_ctrl=[0.0] * 12), None, None, {})
    with pytest.raises(SystemExit, match="unitree_sdk2py"):
        real.main(["--example", "unitree_go2_trot_deploy"])


def test_seq_jump_viewer_overlay_draws_the_contact_targets():
    """The sim server calls the env's update_viewer once at viewer setup; the
    port's seq-jump env draws the same cylinders the JAX env draws."""
    import mujoco

    from dial_mpc_tpu_torch.deploy.sim_server import DialSim, DialSimConfig

    with open(get_example_path("unitree_go2_seq_jump_deploy.yaml")) as f:
        cfgd = yaml.safe_load(f)
    dial_cfg = load_dataclass_from_dict(DialConfig, cfgd)
    env_cfg = load_dataclass_from_dict(torch_envs.get_config(dial_cfg.env_name), cfgd, convert_list_to_array=True)
    sim_cfg = load_dataclass_from_dict(DialSimConfig, cfgd)
    sim_cfg.headless = True
    sim = DialSim(sim_cfg, env_cfg, dial_cfg, max_steps=1, bus_prefix=PREFIX)
    try:
        scene = mujoco.MjvScene(sim.mj_model, maxgeom=1000)
        sim.viewer = types.SimpleNamespace(user_scn=scene)
        sim._init_env_overlay(dial_cfg, env_cfg)
        jscene = mujoco.MjvScene(sim.mj_model, maxgeom=1000)
        jcfg, jenv_cfg, jenv = _jax_side(cfgd)
        jenv.update_viewer(types.SimpleNamespace(user_scn=jscene))
    finally:
        sim.viewer = None
        sim.close()
    assert scene.ngeom == jscene.ngeom > 0, "seq-jump contact targets were not drawn"
    for i in range(scene.ngeom):
        g, jg = scene.geoms[i], jscene.geoms[i]
        assert g.type == jg.type == mujoco.mjtGeom.mjGEOM_CYLINDER
        np.testing.assert_allclose(g.pos, jg.pos, atol=1e-6)
        np.testing.assert_allclose(g.size, jg.size, atol=1e-6)


# ---------------------------------------------------------------------------
# localization plugins
# ---------------------------------------------------------------------------

def test_plugin_discovery_imports_no_optional_dependency():
    code = (
        "import sys\n"
        "from dial_mpc_tpu_torch.deploy.localization import get_available_plugins\n"
        "names = get_available_plugins()\n"
        "assert sorted(names) == ['ros2_odometry_plugin', 'vicon_shm_plugin'], names\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('rclpy', 'pyvicon_datastream', 'nav_msgs', 'jax')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert r.returncode == 0 and "clean" in r.stdout, r.stderr[-2000:]


def test_plugin_registry(tmp_path, capsys):
    from dial_mpc_tpu_torch.deploy import localization
    from dial_mpc_tpu_torch.deploy.localization.base_plugin import BaseLocalizationPlugin

    class Fixed(BaseLocalizationPlugin):
        def get_state(self):
            return np.arange(13.0)

        def get_last_update_time(self):
            return 1.0

    plugin_file = tmp_path / "my_plugin.py"
    plugin_file.write_text(
        "import numpy as np\n"
        "from dial_mpc_tpu_torch.deploy.localization.base_plugin import BaseLocalizationPlugin\n"
        "class FromFile(BaseLocalizationPlugin):\n"
        "    def get_state(self):\n"
        "        return np.zeros(13)\n"
        "    def get_last_update_time(self):\n"
        "        return 2.0\n"
    )
    try:
        localization.register_plugin("test_fixed", plugin_cls=Fixed)
        localization.register_plugin("test_from_file", module_path=str(plugin_file))
        assert localization.load_plugin("test_fixed") is Fixed
        from_file = localization.load_plugin("test_from_file")
        assert from_file({"k": 1}).get_last_update_time() == 2.0 and from_file({}).config == {}
        assert {"test_fixed", "test_from_file"} <= set(localization.get_available_plugins())
        with pytest.raises(ValueError, match="already registered"):
            localization.register_plugin("test_fixed", plugin_cls=Fixed)
        with pytest.raises(TypeError):
            localization.register_plugin("test_not_a_plugin", plugin_cls=dict)
        with pytest.raises(ValueError):
            localization.register_plugin("test_nothing")
        assert localization.load_plugin("no_such_plugin") is None
        # a builtin whose optional dependency is missing loads as None, as in the reference
        assert localization.load_plugin("ros2_odometry_plugin") is None
        assert "Failed to import plugin" in capsys.readouterr().out
        with pytest.raises(NotImplementedError):
            BaseLocalizationPlugin({}).get_state()
    finally:
        for name in ("test_fixed", "test_from_file", "test_not_a_plugin", "test_nothing"):
            localization.plugin_registry.pop(name, None)
