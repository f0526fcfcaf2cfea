"""The port's sample-sharded planner (``dial_mpc_tpu_torch/parallel``) against
the JAX package's, over process groups of 1, 2 and 4 gloo ranks.

The port's ranks are processes: each case is pickled into a directory, this
file is run as a script once per rank (``_rank_main``), and the ranks write
what they planned there. The ranks of a run share one deadline, shorter
than the test's time limit (the root conftest.py), and are killed on the way
out, so no rank can hang the suite. The JAX side, on the conftest's 8-device
CPU mesh, is stored data (tests/reference_utils.py); its per-sample draws
(fold the level key by the global sample index) are rebuilt there and
injected into the port as ``eps``.

Config of tests/test_sharded.py: ``unitree_go2_walk`` with ``kd=0.0``,
Nsample 16, Hsample 16, Hnode 4, two annealing levels. The port runs in
float64; the JAX env steps in float32 (its physics is pinned to float32 under
x64), so the two agree to the golden's tolerances (tests/test_torch_planner.py).
Each rank runs torch on one thread: the CPU physics at these batches is
launch-bound, and eight threads a rank are five times slower.

Run with:  python -m pytest tests/test_torch_parallel.py -q
"""

import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

import dial_mpc_tpu_torch.envs as torch_envs
from dial_mpc_tpu_torch.core.dial_config import DialConfig
from dial_mpc_tpu_torch.core.dial_core import MBDPI
from dial_mpc_tpu_torch.parallel import SampleMesh, ShardedMBDPI, global_sample_mesh, init_distributed
from dial_mpc_tpu_torch.parallel import distributed
from tests import reference_utils

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
CFG = dict(env_name="unitree_go2_walk", Nsample=16, Hsample=16, Hnode=4, Ndiffuse=2)
LEVELS = 2
NU, NODES = 12, CFG["Hnode"] + 1
RANK_TIMEOUT = 120  # s, all ranks of a run together; a few seconds each here
POISON_STEP = 3  # the rollout step at which a case's marked rows turn NaN
NO_POISON = (1.0, 0.0, -1.0)  # (lo, hi, at): an empty range


# ---------------------------------------------------------------------------
# the port's side: ranks as processes
# ---------------------------------------------------------------------------

class _Marked:
    """The env, whose reward turns NaN in the rows where the action's first
    entry lies in [lo, hi] at the input step ``at`` (same rule as
    ``_JaxMarked``)."""

    def __init__(self, env, lo, hi, at):
        self._env, self._poison = env, (lo, hi, at)

    def __getattr__(self, name):
        return getattr(self._env, name)

    def step(self, state, action):
        out = self._env.step(state, action)
        lo, hi, at = self._poison
        bad = (state.info["step"] == at) & (action[:, 0] >= lo) & (action[:, 0] <= hi)
        return out.replace(reward=torch.where(bad, torch.full_like(out.reward, torch.nan), out.reward))


def _port_env():
    cfg = DialConfig(**CFG)
    env_cfg = torch_envs.get_config(cfg.env_name)(kd=0.0)
    return cfg, torch_envs.get_environment(cfg.env_name, env_cfg, device="cpu", dtype=F64)


def _control_step(planner, state, Y, eps=None):
    state, Y, info = planner.control_step(state, Y, LEVELS, eps=eps)
    return dict(Y=Y.numpy(), qpos=state.pipeline_state.qpos.numpy(), **{k: v.numpy() for k, v in info.items()})


def _planner_rank(case):
    """A planner case: the sharded control step from the case's state with
    its draws injected; with ``own_draws`` also one from the env's reset with
    the generator's draws, and with ``mbdpi`` the same through MBDPI (a group
    of one only)."""
    cfg, env = _port_env()
    marked = _Marked(env, *case["poison"])
    out = {}
    planner = ShardedMBDPI(cfg, marked, global_sample_mesh(), torch.Generator().manual_seed(0))
    out["jax_draws"] = _control_step(planner, case["state"], case["Y"], case["eps"])
    out["jax_draws"]["collectives"] = planner.collectives
    if case.get("own_draws"):
        planner = ShardedMBDPI(cfg, env, global_sample_mesh(), torch.Generator().manual_seed(0))
        out["own_draws"] = _control_step(planner, env.reset(), torch.zeros(NODES, NU, dtype=F64))
    if case.get("mbdpi"):
        planner = MBDPI(cfg, env, torch.Generator().manual_seed(0))
        out["mbdpi"] = _control_step(planner, env.reset(), torch.zeros(NODES, NU, dtype=F64))
    return out


def _publisher_rank(case):
    """A deploy case (tests/test_torch_deploy.py): ``MBDPublisher`` with
    ``sharding="mesh"`` in float64 for ``ticks`` ticks on the bus the test
    made under ``prefix``; the plan and generator state it ends with."""
    from dial_mpc_tpu_torch.deploy.planner_proc import MBDPublisher
    from dial_mpc_tpu_torch.utils.io_utils import load_dataclass_from_dict

    cfg = load_dataclass_from_dict(DialConfig, case["cfgd"])
    env_cfg = load_dataclass_from_dict(torch_envs.get_config(cfg.env_name), case["cfgd"],
                                       convert_list_to_array=True, dtype=F64)
    env = torch_envs.get_environment(cfg.env_name, env_cfg, device="cpu", dtype=F64)
    pub = MBDPublisher(env, env_cfg, cfg, sharding="mesh", bus_prefix=case["prefix"])
    try:
        pub.main_loop(max_iters=case["ticks"], verbose=False)
        return dict(Y=pub.Y.numpy(), generator=pub.generator.get_state().numpy(),
                    sharded=isinstance(pub.mbdpi, ShardedMBDPI), attached=pub.bus is not None)
    finally:
        pub.close()


def _rank_main(case_dir, rank, world):
    """One rank of a case (run as a script): join the group, run the case,
    write what it returns."""
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    with open(os.path.join(case_dir, "case.pkl"), "rb") as f:
        case = pickle.load(f)
    init_distributed(f"file://{os.path.join(case_dir, 'store')}", world, rank, device="cpu")
    try:
        out = {"planner": _planner_rank, "publisher": _publisher_rank}[case["kind"]](case)
    finally:
        torch.distributed.destroy_process_group()
    with open(os.path.join(case_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn_ranks(case, world):
    """Run a case on ``world`` gloo ranks, each a process of this file;
    returns each rank's results."""
    with tempfile.TemporaryDirectory() as case_dir:
        with open(os.path.join(case_dir, "case.pkl"), "wb") as f:
            pickle.dump(case, f)
        env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
        procs = [
            subprocess.Popen([sys.executable, os.path.abspath(__file__), case_dir, str(r), str(world)],
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)
        ]
        logs = []
        try:
            deadline = time.monotonic() + RANK_TIMEOUT
            for p in procs:
                logs.append(p.communicate(timeout=max(0.0, deadline - time.monotonic()))[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"rank {r} of {world} failed:\n{log[-3000:]}"
        out = []
        for r in range(world):
            with open(os.path.join(case_dir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

EDGE_Y0 = np.random.default_rng(5).uniform(-0.3, 0.3, (NODES, NU))


def _edge_marks(eps, step0):
    """Three marks on a random plan (EDGE_Y0): the sample with the largest
    first control at the marked step (one NaN rollout); every row (all
    rollouts NaN: the plan is kept); the mean row alone (its controls are
    the plan's, which no sample's equals). Also the marked sample."""
    cfg, env = _port_env()
    pl = MBDPI(cfg, env)
    factors = pl.diffuse_factors(LEVELS)
    us = pl.node2u(pl.sample_nodes(pl.shift(torch.tensor(EDGE_Y0, dtype=F64)), factors[0], eps[0]))
    a = us[:, POISON_STEP, 0].numpy()
    at = step0 + 1 + POISON_STEP  # the advance, then POISON_STEP rollout steps
    top = np.sort(a[:-1])
    assert top[-1] - top[-2] > 1e-3, "the largest sample control must stand clear"
    assert np.abs(a[:-1] - a[-1]).min() > 1e-3, "no sample's control may equal the mean row's"
    marks = {
        "one_nan": (0.5 * (top[-1] + top[-2]), np.inf, at),
        "all_nan": (-np.inf, np.inf, at),
        "nan_mean": (a[-1] - 1e-6, a[-1] + 1e-6, at),
    }
    return marks, int(np.argmax(a[:-1]))


def jax_sharded_reference():
    """The JAX ShardedMBDPI on the 8-device mesh with the marking env (one
    compile serves every case: the marks are state data)
    (tests/reference_data/parallel_sharded.npz): the reset state, the
    planner's draws, and one control step from the zero plan without marks
    and from EDGE_Y0 with each of _edge_marks."""
    import jax
    import jax.numpy as jnp

    import dial_mpc_tpu.envs as jax_envs
    from dial_mpc_tpu.core.dial_config import DialConfig as JaxDialConfig
    from dial_mpc_tpu.parallel import ShardedMBDPI as JaxSharded, make_sample_mesh as jax_mesh

    class _JaxMarked:
        """The JAX env with ``_Marked``'s rule; the marks ride in the state's
        info as [lo, hi, at]."""

        def __init__(self, env):
            self._env = env

        def __getattr__(self, name):
            return getattr(self._env, name)

        def step(self, state, action):
            out = self._env.step(state, action)
            lo, hi, at = state.info["poison"]
            bad = (state.info["step"] == at) & (action[0] >= lo) & (action[0] <= hi)
            info = {**out.info, "poison": state.info["poison"]}
            return out.replace(reward=jnp.where(bad, jnp.nan, out.reward), info=info)

    assert len(jax.devices()) >= 8, "conftest should provide 8 CPU devices"
    cfg = JaxDialConfig(**CFG)
    jenv = jax_envs.get_environment(cfg.env_name, jax_envs.get_config(cfg.env_name)(kd=0.0))
    planner = JaxSharded(cfg, _JaxMarked(jenv), jax_mesh(jax.devices()[:8]))
    state0 = jax.jit(jenv.reset)(jax.random.PRNGKey(1))
    rng0 = jax.random.PRNGKey(0)

    def leaves(obj):
        import dataclasses

        out = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            out[f.name] = leaves(v) if dataclasses.is_dataclass(v) else (np.asarray(v) if v is not None else None)
        return out

    state = dict(pipeline_state=leaves(state0.pipeline_state), obs=state0.obs, reward=state0.reward,
                 done=state0.done, info=dict(state0.info))
    out = reference_utils.flat("state", state)

    # the JAX planner's draws, level by level (parallel/sharded.py:80-88, :169)
    eps, rng = [], rng0
    for _ in range(LEVELS):
        level_key = jax.random.fold_in(rng, 0)
        keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(level_key, jnp.arange(cfg.Nsample))
        eps.append(np.asarray(jax.vmap(lambda k: jax.random.normal(k, (NODES, NU)))(keys)))
        rng = jax.random.fold_in(rng, 1)
    out["eps"] = np.stack(eps)
    out["step0"] = np.asarray(state0.info["step"])

    def run(prefix, Y0, poison):
        st = state0.replace(info={**state0.info, "poison": jnp.asarray(poison, jnp.float64)})
        st, Y, _, info = planner.control_step(st, jnp.asarray(Y0), rng0, LEVELS)
        reference_utils.flat(prefix, dict(Y=Y, qpos=st.pipeline_state.qpos, **info), out)

    run("base", np.zeros((NODES, NU)), NO_POISON)
    marks, _ = _edge_marks(torch.tensor(out["eps"], dtype=F64), int(out["step0"]))
    for name, mark in marks.items():
        out[f"in.mark_{name}"] = np.asarray(mark)
        run(name, EDGE_Y0, mark)
    return out


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX side (stored data): the reset state as the port's state, the
    planner's draws, and its control step of each case."""
    from dial_mpc_tpu_torch.utils import convert

    stored = reference_utils.load("parallel_sharded")
    state = reference_utils.nested(stored, "state")
    state["info"]["randomize_target"] = bool(state["info"]["randomize_target"])
    port_state = convert.state_from_numpy(state, dtype=F64, batched=False)
    return dict(stored=stored, state=port_state, eps=torch.tensor(stored["eps"], dtype=F64),
                step0=int(stored["step0"]))


def _case(jax_ref, Y0, poison=NO_POISON, **more):
    return dict(kind="planner", state=jax_ref["state"], Y=torch.tensor(Y0, dtype=F64), eps=jax_ref["eps"],
                poison=poison, **more)


@pytest.fixture(scope="module")
def base_runs(jax_ref):
    """The zero plan, no marks: the JAX result, and the port's on 1, 2, 4 ranks
    (also from the generator's draws; at one rank also through MBDPI)."""
    Y0 = np.zeros((NODES, NU))
    ref = reference_utils.nested(jax_ref["stored"], "base")
    runs = {w: spawn_ranks(_case(jax_ref, Y0, own_draws=True, mbdpi=w == 1), w) for w in (1, 2, 4)}
    return ref, runs


# The JAX env steps in float32 (its rews, states and body positions come out
# float32 under x64), which the softmax amplifies by 1 / (std x 0.05): the
# golden's Y tolerance, 2e-5 (tests/test_torch_planner.py). A rollout's reward
# (up to 2.7 here) is the mean of 17 float32 steps, each step's rounding
# carried into the next: 2e-5 too (1.6e-5 seen). Body positions and the
# advanced qpos are one to 17 float32 steps: 1e-5.
TOL = {"Y": 2e-5, "xbar": 1e-5, "rews": 2e-5, "qpos": 1e-5}


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("what", ["Y", "xbar", "rews", "qpos"])
def test_sharded_matches_jax(base_runs, world, what):
    ref, runs = base_runs
    want = ref[what]
    got = runs[world][0]["jax_draws"][what].reshape(want.shape)  # the port's state is a batch of one
    np.testing.assert_allclose(got, want, atol=TOL[what], rtol=0)


def test_info_shapes_and_counts(base_runs):
    _, runs = base_runs
    info = runs[2][0]["jax_draws"]
    assert info["rews"].shape == (LEVELS, CFG["Nsample"]), "the mean row's reward is not in info['rews']"
    assert info["xbar"].shape == (LEVELS, CFG["Hsample"] + 1, 13, 3)
    assert (info["n_dropped"] == 0).all() and np.isfinite(info["Y"]).all()
    # one SUM of the moments and rewards, one MAX, one SUM of the softmax's
    # denominator, one SUM of the plan and xbar: four a level
    assert info["collectives"] == 4 * LEVELS


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("draws", ["jax_draws", "own_draws"])
def test_mesh_invariance(base_runs, world, draws):
    """The same draws give the same plan on 1, 2 and 4 ranks, to float64
    reduction-order noise (the sums run in other orders)."""
    _, runs = base_runs
    one, many = runs[1][0][draws], runs[world][0][draws]
    for key in ("Y", "xbar", "rews", "qpos"):
        np.testing.assert_allclose(many[key], one[key], atol=1e-10, rtol=0, err_msg=key)
    assert (many["n_dropped"] == one["n_dropped"]).all()


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_are_bitwise_equal(base_runs, world):
    _, runs = base_runs
    for draws in ("jax_draws", "own_draws"):
        for r in range(1, world):
            for key, v in runs[world][0][draws].items():
                assert np.array_equal(runs[world][r][draws][key], v), f"rank {r}, {draws}, {key}"


@pytest.mark.parametrize("what", ["Y", "xbar", "rews", "qpos"])
def test_one_rank_matches_mbdpi(base_runs, what):
    """At one rank, with the same generator: the same draws, so the plans
    differ by the two reductions' arithmetic only (MBDPI's two-pass std and
    torch.softmax against the one-pass moments and the split mean row)."""
    _, runs = base_runs
    sharded, plain = runs[1][0]["own_draws"], runs[1][0]["mbdpi"]
    want = plain[what][:, :-1] if what == "rews" else plain[what]  # MBDPI's has the mean row last
    np.testing.assert_allclose(sharded[what], want, atol=1e-12, rtol=0)


# ---------------------------------------------------------------------------
# edge cases, each against the JAX planner with the same marks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def edge_runs(jax_ref):
    """_edge_marks on EDGE_Y0 (2 ranks), each against the JAX planner with
    the same marks."""
    marks, worst = _edge_marks(jax_ref["eps"], jax_ref["step0"])
    stored = reference_utils.load("parallel_sharded", **{f"mark_{name}": np.asarray(m) for name, m in marks.items()})
    runs = {}
    for name, mark in marks.items():
        runs[name] = (reference_utils.nested(stored, name), spawn_ranks(_case(jax_ref, EDGE_Y0, poison=mark), 2), worst)
    return EDGE_Y0, runs


@pytest.mark.parametrize("case", ["one_nan", "all_nan", "nan_mean"])
def test_edge_case_matches_jax(edge_runs, case):
    _, runs = edge_runs
    ref, ranks, _ = runs[case]
    got = ranks[0]["jax_draws"]
    for key in ("Y", "xbar", "rews", "qpos"):
        # NaN where the reference has NaN (equal_nan), the tolerances elsewhere
        np.testing.assert_allclose(got[key].reshape(ref[key].shape), ref[key], atol=TOL[key], rtol=0, err_msg=key)
    assert all(np.array_equal(r["jax_draws"]["Y"], got["Y"]) for r in ranks)


def test_one_nan_rollout_gets_zero_weight(edge_runs):
    _, runs = edge_runs
    _, ranks, worst = runs["one_nan"]
    got = ranks[0]["jax_draws"]
    assert np.isnan(got["rews"][0, worst]) and np.isfinite(np.delete(got["rews"][0], worst)).all()
    assert got["n_dropped"][0] == 1 and np.isfinite(got["Y"]).all() and np.isfinite(got["xbar"]).all()


def test_all_nan_rollouts_keep_the_plan(edge_runs):
    Y0, runs = edge_runs
    got = runs["all_nan"][1][0]["jax_draws"]
    cfg, env = _port_env()
    # every level keeps the (clipped) plan it starts from: the shifted one
    kept = torch.clamp(MBDPI(cfg, env).shift(torch.tensor(Y0, dtype=F64)), -1, 1)
    assert np.isnan(got["rews"]).all() and (got["n_dropped"] == CFG["Nsample"] + 1).all()
    np.testing.assert_array_equal(got["Y"], kept.numpy())


def test_nonfinite_mean_row(edge_runs):
    _, runs = edge_runs
    got = runs["nan_mean"][1][0]["jax_draws"]
    assert np.isfinite(got["rews"][0]).all() and got["n_dropped"][0] == 1
    assert np.isfinite(got["Y"]).all()


def test_indivisible_sample_count_raises():
    """Nsample % world != 0: the port and the JAX package both refuse."""
    import jax

    import dial_mpc_tpu.envs as jax_envs
    from dial_mpc_tpu.core.dial_config import DialConfig as JaxDialConfig
    from dial_mpc_tpu.parallel import ShardedMBDPI as JaxSharded, make_sample_mesh as jax_mesh

    cfg, env = _port_env()
    with pytest.raises(ValueError, match="divide"):
        ShardedMBDPI(cfg, env, SampleMesh(None, 0, 3))
    jcfg = JaxDialConfig(**CFG)
    jenv = jax_envs.get_environment(jcfg.env_name, jax_envs.get_config(jcfg.env_name)(kd=0.0))
    with pytest.raises(ValueError, match="divide"):
        JaxSharded(jcfg, jenv, jax_mesh(jax.devices()[:3]))


# ---------------------------------------------------------------------------
# process-group set-up
# ---------------------------------------------------------------------------

@pytest.fixture
def no_group_vars(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)


def test_init_distributed_is_a_noop_for_one_process(no_group_vars):
    assert init_distributed(device="cpu") is False
    assert init_distributed(num_processes=1, device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert distributed.world_size() == 1 and distributed.rank() == 0
    with pytest.raises(RuntimeError, match="init_distributed"):
        global_sample_mesh()


def test_init_distributed_takes_the_backend_of_the_device(no_group_vars, monkeypatch):
    """NCCL for the card, gloo for the CPU, and no switch: a card asked for
    where there is none raises before a group starts, and a device type
    without a backend raises."""
    assert distributed.BACKENDS == {"cuda": "nccl", "cpu": "gloo"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        init_distributed("tcp://127.0.0.1:1", 2, 0, device="cuda")
    with pytest.raises(ValueError, match="backend"):
        init_distributed("tcp://127.0.0.1:1", 2, 0, device="meta")
    assert not torch.distributed.is_initialized()


def test_init_distributed_reads_the_torchrun_variables(no_group_vars, monkeypatch, tmp_path):
    """WORLD_SIZE and RANK with MASTER_ADDR/PORT start a group (env://); a
    group of one, then the mesh spans it."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for var, value in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(port)), ("WORLD_SIZE", "1"),
                       ("RANK", "0")):
        monkeypatch.setenv(var, value)
    assert init_distributed(device="cpu") is True
    try:
        assert torch.distributed.get_backend() == "gloo"
        mesh = global_sample_mesh()
        assert (mesh.rank, mesh.size) == (0, 1) and mesh.group is torch.distributed.group.WORLD
    finally:
        torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# the runner's mesh branch, through its command line under torchrun's variables
# ---------------------------------------------------------------------------

def test_runner_mesh_branch_writes_artifacts_on_rank_zero(tmp_path):
    import socket

    import yaml

    from dial_mpc_tpu_torch.utils.io_utils import get_example_path

    with open(get_example_path("unitree_go2_trot.yaml")) as f:
        cfgd = yaml.safe_load(f)
    cfgd.update(Nsample=4, n_steps=2, Ndiffuse=1, Ndiffuse_init=1, sharding="mesh")
    outs = [str(tmp_path / f"out{r}") for r in range(2)]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(2):
        cfg_path = tmp_path / f"rank{r}.yaml"
        with open(cfg_path, "w") as f:
            yaml.safe_dump({**cfgd, "output_dir": outs[r]}, f)
        env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1", "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port), "WORLD_SIZE": "2", "RANK": str(r), "LOCAL_RANK": str(r)}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "dial_mpc_tpu_torch.core.runner", "--config", str(cfg_path), "--device", "cpu"],
            cwd=str(tmp_path), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        deadline = time.monotonic() + RANK_TIMEOUT
        for p in procs:
            logs.append(p.communicate(timeout=max(0.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(log[-3000:] for log in logs)
    written = sorted(os.listdir(outs[0]))
    assert len(written) == 3 and sum(n.endswith(".npy") for n in written) == 2
    assert any(n.endswith("_visualization.html") for n in written)
    assert not os.path.exists(outs[1]), "rank 1 wrote artifacts"
    assert "mean reward" in logs[0] and "mean reward" not in logs[1]
    states = np.load(os.path.join(outs[0], [n for n in written if n.endswith("_states.npy")][0]))
    assert states.shape == (2, 1 + 19 + 18 + 12) and np.isfinite(states).all()


if __name__ == "__main__":
    _rank_main(*sys.argv[1:])
