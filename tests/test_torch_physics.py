"""PyTorch physics port against the JAX package, CPU MuJoCo and itself.

Everything runs on the CPU at float64 (``device="cpu"``). Inputs are made
from a seed with numpy and handed to both sides. The JAX side's outputs on
these fixed inputs are stored data (tests/reference_utils.py), made as the
repo's own tests run it (tests/conftest.py: CPU, x64, XLA engine) with one
jitted batched ``forward.step`` a scene; where the JAX side is fed the
port's own outputs it runs here.

Run with:  python -m pytest tests/test_torch_*.py -q
"""

import ctypes
import dataclasses
import os
import subprocess

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from tests import reference_utils
from tests.conftest import load_mj
from dial_mpc_tpu.physics import engine_pallas
from dial_mpc_tpu.physics import maths as jmaths
from dial_mpc_tpu.physics import model as jmodel
from dial_mpc_tpu.physics.forward import step as jax_step
from dial_mpc_tpu.physics.kinematics import replace as jreplace

from dial_mpc_tpu_torch.physics import compiled_model, engine_cuda, linalg, maths
from dial_mpc_tpu_torch.physics.forward import forward as tforward, step as tstep
from dial_mpc_tpu_torch.physics.model import BOX, CAPSULE, SPHERE, Data, make_data, put_model
from dial_mpc_tpu_torch.tools import float_checks, host_build, scene_cases
from dial_mpc_tpu_torch.utils import convert
from dial_mpc_tpu_torch.utils.io_utils import get_model_path

# the scenes of the tasks, keyed by the names the test ids carry
SCENES = {key: f"{robot}/{xml}" for key, (robot, xml) in scene_cases.SCENES.items()}
GO2 = SCENES["go2"]
# constraint rows: friction-loss dofs, limited joints, four facets a contact
# slot (the Allegro's elliptic cones: 3 rows a condim-3 slot, 6 a condim-6 one)
NEFC = {"go2": 28, "h1_walk": 35, "h1_loco": 43, "go2_crate": 236, "h1_push_crate": 148, "allegro": 88}
CRATES = ("go2_crate", "h1_push_crate")
B = 8
SETTLE = 5
F64 = torch.float64


def _random_ctrl(rng, shape, nu):
    return rng.uniform(-8.0, 8.0, shape + (nu,))


def _leaves(obj):
    """A dataclass of jax arrays -> dict of numpy arrays / static values."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = _leaves(v)
        elif isinstance(v, jax.Array):
            out[f.name] = np.asarray(v)
        else:
            out[f.name] = v
    return out


_SCENE_CACHE = {}


def _timestep(key):
    """The legged scenes run at 0.02 s here, the Allegro at its task's 0.005 s."""
    return scene_cases.TIMESTEP.get(key, 0.02)


def _models(key):
    """(MjModel, JAX Model, port Model) of a scene, float64, at _timestep(key)."""
    if key not in _SCENE_CACHE:
        mj = load_mj(SCENES[key])
        mj.opt.timestep = _timestep(key)
        _SCENE_CACHE[key] = (mj, jmodel.put_model(mj, dtype=jnp.float64), put_model(mj, device="cpu", dtype=F64))
    return _SCENE_CACHE[key]


def sample_by_sample(jm):
    """The JAX step of a batch, one jitted single-sample call a sample. XLA:CPU
    compiles the Allegro step (8 Newton iterations of 8 line-search updates)
    in about two minutes alone but runs out of memory on its vmap, so that
    scene's batch goes through it a sample at a time."""
    one = jax.jit(lambda d, c: jax_step(jm, jreplace(d, ctrl=c)))

    def step_b(dB, ctrl):
        outs = [one(jax.tree.map(lambda x: x[i], dB), ctrl[i]) for i in range(ctrl.shape[0])]
        return jax.tree.map(lambda *xs: jnp.stack(xs), *outs)

    return step_b


def _ctrls(key, mj, rng, start, n=None):
    """Random ctrl of the batch that starts at qpos ``start``: the legged
    scenes' torques uniform in +/- 8; the Allegro's servo targets around the
    pose each sample starts in (tools/float_checks.random_ctrl)."""
    if key != "allegro":
        return _random_ctrl(rng, (B,) if n is None else (n, B), mj.nu)
    if n is None:
        return float_checks.random_ctrl(key, mj, rng, start)
    return np.stack([float_checks.random_ctrl(key, mj, rng, start) for _ in range(n)])


def _scene_inputs(key):
    """The batch of a scene: start states and the ctrls of the settling steps
    and of the tests, drawn from one seed."""
    mj = _models(key)[0]
    rng = np.random.default_rng(0)
    cm = compiled_model.snapshot(mj)
    qpos = scene_cases.start_qpos(key, cm, B, rng)
    qvel = scene_cases.start_qvel(key, cm, B, rng)
    settle = np.stack([_ctrls(key, mj, rng, qpos) for _ in range(SETTLE)])
    return dict(start_qpos=qpos, start_qvel=qvel, settle_ctrls=settle, ctrls=_ctrls(key, mj, rng, qpos, 20))


# the outputs of the lean data the JAX kernel returns (engine_pallas.trim_data)
_LEAN = ("qpos", "qvel", "site_xpos", "site_xmat", "x_pos", "x_rot", "xd_vel", "xd_ang", "contact.dist",
         "contact.pos", "qacc")


def jax_scene_reference(key):
    """The JAX side of a scene (tests/reference_data/physics_<key>.npz): a
    contact-rich batch settled by the JAX step, one jitted batched step a
    scene (the Allegro's a sample at a time); the forward products of the
    next step (ctrls[0]), 20 free-running steps from the settled batch, and
    on the Go2 flat scene the lean outputs of one and two steps (ctrls[2])
    and the lean data of the next step."""
    inputs = _scene_inputs(key)
    _, jm, _ = _models(key)
    d0 = jmodel.make_data(jm, dtype=jnp.float64)
    dB = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), d0)
    dB = dataclasses.replace(dB, qpos=jnp.asarray(inputs["start_qpos"]), qvel=jnp.asarray(inputs["start_qvel"]))
    if key == "allegro":
        step_b = sample_by_sample(jm)
    else:
        step_b = jax.jit(jax.vmap(lambda d, c: jax_step(jm, jreplace(d, ctrl=c))))
    for ctrl in inputs["settle_ctrls"]:
        dB = step_b(dB, jnp.asarray(ctrl))
    assert bool(jnp.isfinite(dB.qpos).all())
    ctrls = inputs["ctrls"]
    out = {"in." + k: v for k, v in inputs.items()}
    out.update(qpos=dB.qpos, qvel=dB.qvel)
    jd = step_b(dB, jnp.asarray(ctrls[0]))  # derived fields are pre-integration
    for name, _ in _FORWARD_FIELDS:
        out["fwd." + name] = getattr(jd, name)
    for name in ("dist", "pos", "frame"):
        out["contact." + name] = getattr(jd.contact, name)
    for name in ("J", "D", "aref", "pos", "frictionloss"):
        out["efc." + name] = getattr(jd.efc, name)
    traj, jt = [], dB
    for k in range(20):
        jt = step_b(jt, jnp.asarray(ctrls[k]))
        traj.append((jt.qpos, jt.qvel))
    out["traj.qpos"], out["traj.qvel"] = (np.stack([np.asarray(t[i]) for t in traj]) for i in (0, 1))
    out["traj.time"] = jt.time
    if key == "go2":
        trim = jax.vmap(lambda d: engine_pallas.trim_data(jm, d))
        for n_steps in (1, 2):
            jl = dB
            for _ in range(n_steps):
                jl = step_b(jl, jnp.asarray(ctrls[2]))
            lean = trim(jl)
            for name in _LEAN:
                out[f"lean{n_steps}.{name}"] = np.asarray(_attr(lean, name)).reshape(B, -1)
        reference_utils.flat("trim", _leaves(trim(jd)), out)
    return {k: np.asarray(v) for k, v in out.items()}


def _attr(obj, dotted):
    for name in dotted.split("."):
        obj = getattr(obj, name)
    return obj


_BATCH_CACHE = {}


def _scene(key):
    """A scene's models, its batch settled by the JAX step, the ctrls of the
    tests, and the JAX step's outputs from there (stored data)."""
    if key not in _BATCH_CACHE:
        inputs = _scene_inputs(key)
        mj, _, tm = _models(key)
        ref = reference_utils.load(f"physics_{key}", **inputs)
        _BATCH_CACHE[key] = dict(key=key, mj=mj, tm=tm, ref=ref, ctrls=inputs["ctrls"], qpos=ref["qpos"],
                                 qvel=ref["qvel"])
    return _BATCH_CACHE[key]


@pytest.fixture(scope="module")
def go2():
    return _scene("go2")


@pytest.fixture(scope="module", params=list(SCENES))
def scene(request):
    return _scene(request.param)


def _tdata(tm, qpos, qvel, ctrl):
    t = lambda a: torch.tensor(np.asarray(a), dtype=F64)
    return make_data(tm, qpos.shape[0]).replace(qpos=t(qpos), qvel=t(qvel), ctrl=t(ctrl))


# ---------------------------------------------------------------------------
# put_model, field by field
# ---------------------------------------------------------------------------

_MODEL_FIELDS = [f.name for f in dataclasses.fields(jmodel.Model) if f.name != "opt"]
_OPT_FIELDS = [f.name for f in dataclasses.fields(jmodel.Option)]


def _same(a, b):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("name", _MODEL_FIELDS)
@pytest.mark.parametrize("key", list(SCENES))
def test_put_model_field(key, name):
    _, jm, tm = _models(key)
    ref = convert.model_from_numpy(_leaves(jm), dtype=F64)
    _same(getattr(tm, name), getattr(ref, name))


@pytest.mark.parametrize("name", _OPT_FIELDS)
@pytest.mark.parametrize("key", list(SCENES))
def test_put_model_option(key, name):
    _, jm, tm = _models(key)
    ref = convert.model_from_numpy(_leaves(jm), dtype=F64)
    _same(getattr(tm.opt, name), getattr(ref.opt, name))


def test_put_model_go2_facts(go2):
    tm = go2["tm"]
    assert (tm.nq, tm.nv, tm.nu, tm.nbody, tm.nsite, tm.ngeom) == (19, 18, 12, 14, 5, 38)
    assert [p[2:] for p in tm.pair_table] == [(0, 2, 3, c, 1) for c in range(4)]
    assert tm.opt.cone == 0 and tm.opt.disable_eulerdamp and not tm.opt.disable_contact
    assert (tm.opt.iterations, tm.opt.ls_iterations) == (2, 5)


@pytest.mark.parametrize("key", list(SCENES))
def test_compiled_scene_is_current(key):
    """The shipped .npz equals a fresh MuJoCo compile of the MJCF."""
    robot, xml = SCENES[key].split("/")
    shipped = compiled_model.load_scene(robot, xml)
    fresh = compiled_model.compile_mjcf(get_model_path(robot, xml))
    for k in compiled_model._SIZES + compiled_model._ARRAYS:
        np.testing.assert_array_equal(np.asarray(getattr(shipped, k)), np.asarray(getattr(fresh, k)), err_msg=k)
    for k in compiled_model._OPT:
        np.testing.assert_array_equal(np.asarray(getattr(shipped.opt, k)), np.asarray(getattr(fresh.opt, k)), err_msg=k)
    assert shipped.names == fresh.names and shipped.disable_bits == fresh.disable_bits
    assert shipped.geom_id("floor") == 0 and len(shipped.names["geom"]) == shipped.ngeom
    if key.startswith("go2"):
        assert shipped.body_id("base") == 1 and shipped.site_id("FL_foot") >= 0
    elif key == "allegro":  # what the task env looks up
        assert shipped.body_id("object") == 1 and shipped.nsite == 0
    else:
        assert shipped.body_id("pelvis") == 1 and shipped.site_id("left_foot") >= 0
    if key in CRATES:
        assert shipped.geom_type[shipped.geom_id("static_box")] == BOX
    keyframe = "in_hand_reorient" if key == "allegro" else "home"
    np.testing.assert_array_equal(shipped.keyframe_qpos(keyframe), fresh.key_qpos[0])


def test_compiled_scene_roundtrip(tmp_path):
    cm = compiled_model.load_scene("unitree_go2", "mjx_scene_force.xml")
    path = str(tmp_path / "scene.npz")
    compiled_model.save(cm, path)
    back = compiled_model.load(path)
    for k in compiled_model._ARRAYS:
        np.testing.assert_array_equal(getattr(cm, k), getattr(back, k))
    assert back.opt.timestep == cm.opt.timestep and back.names == cm.names
    with pytest.raises(KeyError):
        back.body_id("no_such_body")


# ---------------------------------------------------------------------------
# forward / step against the JAX package and CPU MuJoCo
# ---------------------------------------------------------------------------

# (field, tolerance): positions 1e-9, velocities and dynamics 1e-7
_FORWARD_FIELDS = [
    ("xpos", 1e-9), ("xquat", 1e-9), ("xipos", 1e-9), ("geom_xpos", 1e-9), ("site_xpos", 1e-9),
    ("site_xmat", 1e-9), ("subtree_com", 1e-9), ("cinert", 1e-9), ("cdof", 1e-9),
    ("cvel", 1e-7), ("cdof_dot", 1e-7), ("qM", 1e-9), ("qfrc_bias", 1e-7),
    ("qfrc_passive", 1e-9), ("qfrc_actuator", 1e-9), ("qacc_smooth", 1e-7),
    ("qfrc_constraint", 1e-7), ("qacc", 1e-7), ("x_pos", 1e-9), ("x_rot", 1e-9),
    ("xd_vel", 1e-7), ("xd_ang", 1e-7),
]


@pytest.fixture(scope="module")
def forward_pair(scene):
    ctrl = scene["ctrls"][0]
    td = tforward(scene["tm"], _tdata(scene["tm"], scene["qpos"], scene["qvel"], ctrl))
    return scene["key"], scene["ref"], td


@pytest.mark.parametrize("name,tol", _FORWARD_FIELDS)
def test_forward_matches_jax(forward_pair, name, tol):
    _, jd, td = forward_pair
    np.testing.assert_allclose(getattr(td, name).numpy(), jd["fwd." + name], atol=tol, rtol=tol)


@pytest.mark.parametrize("name,tol", [("dist", 1e-9), ("pos", 1e-9), ("frame", 1e-9)])
def test_contact_matches_jax(forward_pair, name, tol):
    """Slot by slot: the tie order of the box pairs is the reference's."""
    key, jd, td = forward_pair
    np.testing.assert_allclose(getattr(td.contact, name).numpy(), jd["contact." + name], atol=tol)
    assert (td.contact.dist < 0).any(), "the batch must be in contact"
    if key in CRATES:
        tm = _models(key)[2]
        assert tm.ncon == {"go2_crate": 56, "h1_push_crate": 32}[key]
        box = td.contact.dist[:, scene_cases.box_slots(tm.pair_table)]
        assert (box < 0).any(-1).sum() >= B // 2, "most samples must touch a box"


@pytest.mark.parametrize("name,tol", [("J", 1e-9), ("D", 1e-7), ("aref", 1e-7), ("pos", 1e-9), ("frictionloss", 0.0)])
def test_constraint_rows_match_jax(forward_pair, name, tol):
    key, jd, td = forward_pair
    tm = _models(key)[2]
    assert td.efc.J.shape == (B, NEFC[key], tm.nv)
    got, ref = getattr(td.efc, name).numpy(), jd["efc." + name]
    np.testing.assert_allclose(got, ref, atol=tol, rtol=1e-9)


def test_step_trajectory_matches_jax(scene):
    """20 free-running steps from the contact-rich batch: 1e-9 qpos, 1e-7 qvel."""
    ref = scene["ref"]
    td = _tdata(scene["tm"], scene["qpos"], scene["qvel"], scene["ctrls"][0])
    for k in range(20):
        ctrl = scene["ctrls"][k]
        td = tstep(scene["tm"], td.replace(ctrl=torch.tensor(ctrl)))
        np.testing.assert_allclose(td.qpos.numpy(), ref["traj.qpos"][k], atol=1e-9, rtol=1e-9, err_msg=f"step {k}")
        np.testing.assert_allclose(td.qvel.numpy(), ref["traj.qvel"][k], atol=1e-7, rtol=1e-7, err_msg=f"step {k}")
    np.testing.assert_allclose(td.time.numpy(), ref["traj.time"] - SETTLE * _timestep(scene["key"]), atol=1e-12)


# the scenes whose contact manifolds are MuJoCo's own (the reference's
# EXACT_SCENES, tests/test_physics_contact.py)
@pytest.mark.parametrize("sample", range(4))
@pytest.mark.parametrize("key", ["go2", "h1_walk", "h1_loco"])
def test_forward_matches_mujoco(key, sample):
    """Single-state forward against CPU mj_forward (warmstart off): 1e-7."""
    sc = _scene(key)
    mj = load_mj(SCENES[key])
    mj.opt.timestep = 0.02
    mj.opt.disableflags |= mujoco.mjtDisableBit.mjDSBL_WARMSTART
    md = mujoco.MjData(mj)
    md.qpos[:], md.qvel[:] = sc["qpos"][sample], sc["qvel"][sample]
    md.ctrl[:] = sc["ctrls"][1][sample]
    mujoco.mj_forward(mj, md)
    tm = put_model(mj, dtype=F64)
    td = tforward(tm, _tdata(tm, sc["qpos"][sample : sample + 1], sc["qvel"][sample : sample + 1], sc["ctrls"][1][sample : sample + 1]))
    np.testing.assert_allclose(td.xpos[0].numpy(), md.xpos, atol=1e-9)
    np.testing.assert_allclose(td.qfrc_bias[0].numpy(), md.qfrc_bias, atol=1e-7)
    np.testing.assert_allclose(td.qacc_smooth[0].numpy(), md.qacc_smooth, atol=1e-7)
    np.testing.assert_allclose(td.qacc[0].numpy(), md.qacc, atol=1e-7, rtol=1e-7)
    M = np.zeros((mj.nv, mj.nv))
    mujoco.mj_fullM(mj, md, M)
    np.testing.assert_allclose(td.qM[0].numpy(), M, atol=1e-9)


@pytest.mark.parametrize("key", CRATES)
def test_crate_scene_rests_on_floor(key):
    """The box manifolds are approximate, so MuJoCo is no oracle here: from
    the keyframe under zero ctrl, 100 plain steps stay finite, nothing launches
    upward or sinks through the floor, and velocities stay bounded (the
    reference's own check, tests/test_physics_contact.py, at the scene's own
    timestep)."""
    mj = load_mj(SCENES[key])
    tm = put_model(mj, dtype=F64)
    d = make_data(tm, 1).replace(qpos=torch.tensor(mj.key_qpos[:1], dtype=F64))
    free_qadr = [mj.jnt_qposadr[j] for j in range(mj.njnt) if mj.jnt_type[j] == 0]
    z0 = [float(d.qpos[0, a + 2]) for a in free_qadr]
    for _ in range(100):
        d = tstep(tm, d)
    assert torch.isfinite(d.qpos).all()
    for a, z_init in zip(free_qadr, z0):
        assert -0.2 < float(d.qpos[0, a + 2]) - z_init < 0.05, (a, z_init)
    assert float(d.qvel.abs().max()) < 10.0


# ---------------------------------------------------------------------------
# the kernel's plain version against the JAX kernel's own references
# ---------------------------------------------------------------------------

_OUT_TOL = {"qpos": 1e-9, "site_xpos": 1e-9, "site_xmat": 1e-9, "x_pos": 1e-9, "x_rot": 1e-9,
            "cdist": 1e-9, "cpos": 1e-9}


@pytest.mark.parametrize("n_steps", [1, 2])
def test_step_core_reference_matches_jax(go2, n_steps):
    ctrl = go2["ctrls"][2]
    t = lambda a: torch.tensor(a, dtype=F64)
    outs = engine_cuda.step_core_reference(go2["tm"], t(go2["qpos"]), t(go2["qvel"]), t(ctrl), n_steps)
    # forward.step n_steps times + engine_pallas.trim_data, as 11 arrays
    refs = [go2["ref"][f"lean{n_steps}.{name}"] for name in _LEAN]
    assert [tuple(o.shape) for o in outs] == [(B, n) for _, n in engine_cuda.out_specs(go2["tm"])]
    for (name, _), got, ref in zip(engine_cuda.out_specs(go2["tm"]), outs, refs):
        tol = _OUT_TOL.get(name, 1e-7)
        np.testing.assert_allclose(got.numpy(), ref, atol=tol, rtol=tol, err_msg=name)


def test_step_core_cpu_uses_plain_version_and_lean_data(go2):
    """On CPU tensors the wrapper is the plain version and counts no launch."""
    ctrl = go2["ctrls"][3]
    t = lambda a: torch.tensor(a, dtype=F64)
    before = engine_cuda.step_core.launches
    outs = engine_cuda.step_core(go2["tm"], t(go2["qpos"]), t(go2["qvel"]), t(ctrl), 1)
    refs = engine_cuda.step_core_reference(go2["tm"], t(go2["qpos"]), t(go2["qvel"]), t(ctrl), 1)
    assert engine_cuda.step_core.launches == before
    for a, b in zip(outs, refs):
        assert torch.equal(a, b)
    d_prev = _tdata(go2["tm"], go2["qpos"], go2["qvel"], ctrl)
    lean = engine_cuda.lean_data(go2["tm"], d_prev, outs, t(ctrl), go2["tm"].opt.timestep)
    full = tstep(go2["tm"], d_prev)
    trim = engine_cuda.trim_data(go2["tm"], full)
    for name in ("qpos", "qvel", "ctrl", "time", "site_xpos", "site_xmat", "x_pos", "x_rot", "xd_vel", "xd_ang", "qacc"):
        assert torch.equal(getattr(lean, name), getattr(trim, name)), name
    assert torch.equal(lean.contact.dist, trim.contact.dist) and lean.contact.frame is None


def test_step_core_rejects_bad_inputs(go2):
    t = lambda a: torch.tensor(a, dtype=F64)
    q, v, c = t(go2["qpos"]), t(go2["qvel"]), t(go2["ctrls"][0])
    with pytest.raises(ValueError):
        engine_cuda.step_core(go2["tm"], q[:, :5], v, c)
    with pytest.raises(ValueError):
        engine_cuda.step_core(go2["tm"], q, v.float(), c)
    with pytest.raises(ValueError):
        engine_cuda.step_core(go2["tm"], q, v, c, n_steps=0)
    with pytest.raises(ValueError):
        engine_cuda.step_core(go2["tm"], q, v[:3], c)


def test_step_core_reference_matches_pallas_interpret():
    """Against the Pallas step kernel itself, in interpret mode at float64,
    with the reduced solver schedule the JAX package's kernel tests use."""
    mj = load_mj(GO2)
    mj.opt.iterations = min(mj.opt.iterations, 2)
    mj.opt.ls_iterations = min(mj.opt.ls_iterations, 4)
    jm = jmodel.put_model(mj, dtype=jnp.float64)
    tm = put_model(mj, dtype=F64)
    rng = np.random.default_rng(3)
    qpos = np.tile(np.asarray(mj.key_qpos[0], np.float64), (B, 1)) + rng.normal(0, 0.01, (B, mj.nq))
    qpos[:, 3:7] /= np.linalg.norm(qpos[:, 3:7], axis=1, keepdims=True)
    t = lambda a: torch.tensor(a, dtype=F64)
    d = make_data(tm, B).replace(qpos=t(qpos), qvel=t(rng.normal(0, 0.2, (B, mj.nv))))
    for _ in range(SETTLE):
        d = tstep(tm, d.replace(ctrl=t(_random_ctrl(rng, (B,), mj.nu))))
    ctrl = _random_ctrl(rng, (B,), mj.nu)
    core = engine_pallas.step_core_for(jm, block=8)
    outs_k = jax.jit(jax.vmap(core))(jnp.asarray(d.qpos.numpy()), jnp.asarray(d.qvel.numpy()), jnp.asarray(ctrl))
    outs_t = engine_cuda.step_core_reference(tm, d.qpos, d.qvel, t(ctrl), 1)
    for (name, _), got, ref in zip(engine_cuda.out_specs(tm), outs_t, outs_k):
        tol = _OUT_TOL.get(name, 1e-7)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol, rtol=tol, err_msg=name)
    jax.clear_caches()
    engine_pallas._CORE_CACHE.clear()


# ---------------------------------------------------------------------------
# the kernel's scope guard, generated header and host-compiled source
# ---------------------------------------------------------------------------

def _allegro_pyramidal(mj):
    """Allegro with pyramidal cones and eulerdamp off: condim-6 pyramids (ten
    facets a slot, the rotational ones weighted by invweight_r)."""
    mj.opt.cone = mujoco.mjtCone.mjCONE_PYRAMIDAL
    mj.opt.disableflags |= mujoco.mjtDisableBit.mjDSBL_EULERDAMP.value
    return mj


def _go2_eulerdamp(mj):
    """The Go2 flat scene with implicit joint damping switched on."""
    mj.opt.disableflags &= ~int(mujoco.mjtDisableBit.mjDSBL_EULERDAMP.value)
    return mj


def _go2_rk4(mj):
    mj.opt.integrator = mujoco.mjtIntegrator.mjINT_RK4
    return mj


def _go2_no_contact(mj):
    mj.opt.disableflags |= mujoco.mjtDisableBit.mjDSBL_CONTACT.value
    return mj


_BALL_JOINT_XML = """<mujoco><worldbody><geom type="plane" size="1 1 .1"/>
<body pos="0 0 .5"><joint type="ball"/><geom type="sphere" size=".1" pos="0 0 -.3"/></body>
</worldbody></mujoco>"""


# what kernel E does not cover, as the reference does not either: ball joints,
# integrators other than Euler, the contact-disable flag (every scene of the
# task suite is covered)
@pytest.mark.parametrize(
    "scene,edit,match",
    [
        (None, None, "ball joints"),
        (GO2, _go2_rk4, "Euler integrator"),
        (GO2, _go2_no_contact, "contact-disable"),
    ],
    ids=["ball_joint", "rk4", "contact_disabled"],
)
def test_kernel_scope_guard_raises(scene, edit, match):
    mj = mujoco.MjModel.from_xml_string(_BALL_JOINT_XML) if scene is None else load_mj(scene)
    tm = put_model(edit(mj) if edit else mj, dtype=F64)
    with pytest.raises(NotImplementedError, match=match):
        engine_cuda.check_supported(tm)
    with pytest.raises(NotImplementedError):
        engine_cuda.render_constants_header(tm)


@pytest.mark.parametrize("key", list(SCENES))
def test_kernel_scope_guard_admits_the_legged_scenes(key):
    """Every scene of the task suite, the Allegro hand's included."""
    tm = _models(key)[2]
    engine_cuda.check_supported(tm)
    header = engine_cuda.render_constants_header(tm)
    assert f"#define MC_NEFC {NEFC[key]}" in header
    kinds = {engine_cuda.PAIR_KINDS[p[2:4]] for p in tm.pair_table}
    assert f"#define MC_PAIR_KINDS {sum(1 << k for k in kinds)}" in header
    assert f"#define MC_HAS_SLIDE {int(key == 'h1_push_crate')}" in header
    assert f"#define MC_NFRIC {int(key == 'h1_push_crate')}" in header
    allegro = int(key == "allegro")
    for name, value in (("ELLIPTIC", allegro), ("CON_TABLE", allegro), ("NCON6", 5 * allegro),
                        ("NGROUPS", 19 * allegro), ("EULERDAMP", allegro)):
        assert f"#define MC_{name} {value}\n" in header


@pytest.mark.parametrize("edit", [_allegro_pyramidal, _go2_eulerdamp], ids=["allegro_pyramidal", "go2_eulerdamp"])
def test_kernel_scope_guard_admits_pyramidal_condim6_and_eulerdamp(edit):
    """Condim-6 pyramids (10 facets a slot) and eulerdamp on any scene."""
    mj = edit(load_mj("wonik_allegro/scene_left.xml" if edit is _allegro_pyramidal else GO2))
    tm = put_model(mj, dtype=F64)
    engine_cuda.check_supported(tm)
    header = engine_cuda.render_constants_header(tm)
    if edit is _allegro_pyramidal:
        assert "#define MC_NEFC 122\n" in header  # 16 limits, 14 x 4 + 5 x 10 facets
        assert "#define MC_CON_TABLE 1\n" in header and "#define MC_ELLIPTIC 0\n" in header
    else:
        assert "#define MC_EULERDAMP 1\n" in header and "#define MC_CON_TABLE 0\n" in header


@pytest.mark.parametrize("key", list(SCENES))
def test_hessian_schedule_starts_from_m(key):
    """The Newton Hessian's factor entries start from M inside M's mask and
    from zero outside it; contacts between two moving bodies (the H1's hands,
    knees and torso on the sliding crate) reach entries between their chains
    that M never holds, and the kernel must not read M there."""
    tm = _models(key)[2]
    lay = engine_cuda.static_layout(tm)
    tables, _ = engine_cuda.team_tables(tm)
    nv, mm = tm.nv, lay["m_mask"]
    outside = 0
    entries = set()
    for e, (rc, inm) in enumerate(zip(tables["hf_ent"], tables["hf_ent_inm"])):
        i, j = nv - 1 - (rc & 255), nv - 1 - (rc >> 8)
        assert bool(inm) == bool(mm[i, j])
        outside += not mm[i, j]
        entries.add((i, j))
        # the elliptic groups whose rank-1 term reaches this entry: those whose
        # support holds both dofs
        reach = set(tables["hgrp"][tables["hgrp_adr"][e] : tables["hgrp_adr"][e + 1]].tolist())
        want = {g for g, (row0, _) in enumerate(lay["groups"]) if lay["j_sup"][row0, i] and lay["j_sup"][row0, j]}
        assert reach == want
    # every entry a group's rank-1 term reaches is in the schedule (a group's
    # rows share one support)
    for row0, dim in lay["groups"]:
        assert all((lay["j_sup"][row0 + k] == lay["j_sup"][row0]).all() for k in range(dim))
        sup = np.flatnonzero(lay["j_sup"][row0])
        assert all((max(a, b), min(a, b)) in entries for a in sup for b in sup)
    assert len(lay["groups"]) == (19 if key == "allegro" else 0)
    # contacts between two moving bodies: the H1's hands, knees and torso on
    # the sliding crate; the Allegro's ball on its fingers, fingers on fingers
    assert (outside > 0) == (key in ("h1_push_crate", "allegro"))


def test_unported_physics_branches_raise():
    """Every pair kind of the model suite has its plain collider (the
    Allegro's sphere-capsule pairs were the last); a pair of other types
    raises naming it, and so do ball joints, as in the reference."""
    allegro = put_model(load_mj("wonik_allegro/scene_left.xml"), dtype=F64)
    assert {p[2:4] for p in allegro.pair_table} >= {(SPHERE, CAPSULE), (CAPSULE, CAPSULE)}
    assert torch.isfinite(tstep(allegro, make_data(allegro, 2)).qpos).all()
    reversed_pair = dataclasses.replace(
        allegro, pair_table=tuple((g2, g1, t2, t1, *rest) for (g1, g2, t1, t2, *rest) in allegro.pair_table[:1])
    )
    with pytest.raises(NotImplementedError, match="sphere-plane is not ported"):
        tforward(reversed_pair, make_data(reversed_pair, 2))
    ball = put_model(mujoco.MjModel.from_xml_string(_BALL_JOINT_XML), dtype=F64)
    with pytest.raises(NotImplementedError, match="ball joints"):
        tforward(ball, make_data(ball, 2))


def test_constants_header_and_layout(go2):
    tm = go2["tm"]
    lay = engine_cuda.static_layout(tm)
    assert lay["j_sup"].shape == (28, 18) and len(lay["limit_jnt"]) == 12
    # children-first elimination of the tree pattern has no fill-in
    assert (lay["m_pat"] == lay["m_mask"][::-1, ::-1]).all()
    assert (lay["h_pat"] >= lay["h_mask"][::-1, ::-1]).all()
    assert (lay["h_mask"] >= lay["m_mask"]).all() and (lay["h_mask"] == lay["h_mask"].T).all()
    header = engine_cuda.render_constants_header(tm)
    for line in ("#define MC_NQ 19", "#define MC_NV 18", "#define MC_NEFC 28", "#define MC_ITERATIONS 2", "#define MC_LS_ITERATIONS 5"):
        assert line in header
    m32 = put_model(go2["mj"], dtype=torch.float32)
    assert header == engine_cuda.render_constants_header(engine_cuda.exact_model(m32)), \
        "the header holds float64 literals whatever dtype the model was put in"
    assert engine_cuda.model_key(engine_cuda.exact_model(m32)) == engine_cuda.model_key(tm)
    assert 1e4 < engine_cuda.step_flops(tm) < 1e6
    assert engine_cuda.model_key(tm) == engine_cuda.model_key(put_model(go2["mj"], dtype=F64))


# The kernel source compiled as host C++ (tools/host_build.py): a team's lanes
# become LANES std::threads, the dynamic shared memory a buffer of the team
# pre-filled with a given byte.
_HARNESS = """
#include "engine_step_nolaunch.cu"
#include "run_team.h"
#include <cstring>
template <typename T> static void run(const T* in, T* out, int B, int n_steps, int fill) {
  for (int s = 0; s < B; ++s) {
    std::vector<unsigned char> shared(sizeof(StepShared<T>));
    std::memset(shared.data(), fill, shared.size());
    run_team([&](int l) {
      engine_step_team<T>(Team{l, 0xffffffffu}, *reinterpret_cast<StepShared<T>*>(shared.data()),
                          in + (size_t)s * N_IN_ROWS, out + (size_t)s * N_OUT_ROWS, n_steps);
    });
  }
}
extern "C" void run_f64(const double* in, double* out, int B, int n, int fill) { run<double>(in, out, B, n, fill); }
extern "C" void run_f32(const float* in, float* out, int B, int n, int fill) { run<float>(in, out, B, n, fill); }
extern "C" int out_rows() { return N_OUT_ROWS; }
extern "C" int lanes() { return LANES; }
"""
# a program around the harness, for builds that cannot be loaded into Python
# (ThreadSanitizer): float64 and float32 launches of n_steps on the inputs of
# a file, both outputs into another
_MAIN = """
#include "harness.cpp"
#include <cstdio>
#include <cstdlib>
int main(int argc, char** argv) {
  const int B = std::atoi(argv[2]), n = std::atoi(argv[3]);
  std::vector<double> in((size_t)B * N_IN_ROWS), out((size_t)B * N_OUT_ROWS);
  FILE* f = std::fopen(argv[1], "rb");
  if (!f || std::fread(in.data(), sizeof(double), in.size(), f) != in.size()) return 2;
  std::fclose(f);
  run<double>(in.data(), out.data(), B, n, 0);
  std::vector<float> in32(in.begin(), in.end()), out32(out.size());
  run<float>(in32.data(), out32.data(), B, n, 0);
  f = std::fopen(argv[4], "wb");
  std::fwrite(out.data(), sizeof(double), out.size(), f);
  std::fwrite(out32.data(), sizeof(float), out32.size(), f);
  std::fclose(f);
  return 0;
}
"""
SHARED_FILLS = (0x00, 0xFF)  # zeros, and NaN in either type
# the host builds run a team's lanes as threads that meet at a barrier every
# phase: on a loaded CPU a run takes many times its usual seconds (10 s to
# 360 s seen), so these tests get more than the default limit
HOST_RUN_LIMIT = pytest.mark.timeout(600)


def _write_host_sources(tm, d):
    host_build.write_shim(d)
    (d / "model_constants.h").write_text(engine_cuda.render_constants_header(tm))
    (d / "engine_step_nolaunch.cu").write_text(
        host_build.source_without_launch("engine_step.cu", "constexpr int MAX_SAMPLES_PER_BLOCK"))
    (d / "harness.cpp").write_text(_HARNESS)
    (d / "main.cpp").write_text(_MAIN)


def _gxx_cmd(d, *flags, lanes=engine_cuda.LANES):
    try:
        return host_build.gxx_command(d, *flags, lanes=lanes)
    except FileNotFoundError:
        pytest.skip("no host C++ compiler")


def _build_host_kernel(tm, d, *flags, lanes=engine_cuda.LANES):
    """csrc/engine_step.cu compiled as host C++ (a thread a lane) into d."""
    cmd = _gxx_cmd(d, *flags, lanes=lanes)
    _write_host_sources(tm, d)
    r = subprocess.run([*cmd, "-shared", "-fPIC", "-o", str(d / "libh.so"), str(d / "harness.cpp")],
                       capture_output=True, text=True)
    if flags and "unrecognized command-line option" in r.stderr:
        pytest.skip(f"this g++ does not know {flags}")
    assert r.returncode == 0, r.stderr[-4000:]
    lib = ctypes.CDLL(str(d / "libh.so"))
    assert lib.lanes() == lanes
    return lib


def _host_input(sc, ctrl, dtype):
    return np.ascontiguousarray(np.concatenate([sc["qpos"], sc["qvel"], ctrl], 1).astype(np.dtype(dtype)))


def _run_host_kernel(lib, sc, ctrl, dtype, n_steps, fill=0):
    """(B, out_rows) outputs of the host build, sample-major like the kernel's."""
    inp = _host_input(sc, ctrl, dtype)
    out = np.zeros((B, lib.out_rows()), np.dtype(dtype))
    fn = lib.run_f64 if dtype == "float64" else lib.run_f32
    fn(inp.ctypes.data_as(ctypes.c_void_p), out.ctypes.data_as(ctypes.c_void_p), B, n_steps, fill)
    return out


_HOST_TOL_F32 = {"qacc": 5e-2, "qvel": 1e-3, "xd_vel": 1e-3, "xd_ang": 1e-3}


def _assert_host_matches_plain(sc, out, ctrl, dtype, n_steps):
    tm = sc["tm"]
    t = lambda a: torch.tensor(a, dtype=F64)
    refs = engine_cuda.step_core_reference(tm, t(sc["qpos"]), t(sc["qvel"]), t(ctrl), n_steps)
    assert out.shape[1] == sum(n for _, n in engine_cuda.out_specs(tm))
    o = 0
    for (name, n), ref in zip(engine_cuda.out_specs(tm), refs):
        got = out[:, o : o + n]
        o += n
        if dtype == "float64":
            tol = _OUT_TOL.get(name, 1e-7)
        else:  # float32 arithmetic against the float64 plain version
            tol = _HOST_TOL_F32.get(name, 1e-4)
        np.testing.assert_allclose(got, ref.numpy(), atol=tol, rtol=tol, err_msg=f"{name} {dtype}")


# the kernel's host build at the Go2 flat key and at one key of each new kind:
# plane-capsule (H1 walk), the box pairs (Go2 crate), and the box pairs with a
# slide joint, a friction-loss row and contacts between two moving bodies (H1
# push crate); elliptic groups, condim-6 rows, eulerdamp, position servos and
# the sphere and capsule pairs (Allegro)
HOST_SCENES = ["go2", "h1_walk", "go2_crate", "h1_push_crate", "allegro"]


@pytest.fixture(scope="module", params=HOST_SCENES)
def host_scene(request):
    return _scene(request.param)


@pytest.fixture(scope="module")
def host_kernel(host_scene, tmp_path_factory):
    """The kernel's arithmetic, checked here where there is no nvcc and no card."""
    return _build_host_kernel(host_scene["tm"], tmp_path_factory.mktemp("host_kernel"))


@HOST_RUN_LIMIT
@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_kernel_source_on_host_matches_plain_version(host_scene, host_kernel, dtype, n_steps):
    ctrl = host_scene["ctrls"][4]
    _assert_host_matches_plain(
        host_scene, _run_host_kernel(host_kernel, host_scene, ctrl, dtype, n_steps), ctrl, dtype, n_steps
    )


@HOST_RUN_LIMIT
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_kernel_source_with_16_lanes_matches_plain_version(go2, tmp_path_factory, dtype):
    """The team size is a compile-time constant; half a warp a sample (each
    lane then owns two rows and up to two dofs) computes the same function."""
    lib = _build_host_kernel(go2["tm"], tmp_path_factory.mktemp("host16"), lanes=16)
    ctrl = go2["ctrls"][4]
    _assert_host_matches_plain(go2, _run_host_kernel(lib, go2, ctrl, dtype, 3), ctrl, dtype, 3)


@pytest.fixture(scope="module")
def host_kernel_prefilled(host_scene, tmp_path_factory):
    """Host builds with every local variable pre-filled: zeros, a bit pattern."""
    return [
        _build_host_kernel(host_scene["tm"], tmp_path_factory.mktemp(fill), f"-ftrivial-auto-var-init={fill}")
        for fill in ("zero", "pattern")
    ]


@HOST_RUN_LIMIT
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_kernel_source_reads_no_uninitialised_value(host_scene, host_kernel, host_kernel_prefilled, dtype):
    """The kernel never writes the entries of M, H, L and J that lie outside
    the static patterns, so it must never read them either: whatever the
    local variables and the team's shared memory held before (zeros, NaN),
    the outputs are the same bit for bit."""
    plain = _run_host_kernel(host_kernel, host_scene, host_scene["ctrls"][5], dtype, 3)
    for lib in (host_kernel, *host_kernel_prefilled):
        for fill in SHARED_FILLS:
            np.testing.assert_array_equal(_run_host_kernel(lib, host_scene, host_scene["ctrls"][5], dtype, 3, fill), plain)


@HOST_RUN_LIMIT
@pytest.mark.parametrize("lanes", [32, 16])
def test_kernel_source_has_no_data_race(host_scene, host_kernel, tmp_path, lanes):
    """ThreadSanitizer over the lane-emulating host build, two samples and two
    steps in both types: no lane reads or writes a value another lane writes
    in the same phase (between two team syncs). Shuffles are barriers on the
    host, so this cannot see a missing sync that a shuffle stands in for; the
    kernel never relies on one. The outputs equal the plain host build's."""
    cmd = _gxx_cmd(tmp_path, "-fsanitize=thread", "-g", lanes=lanes)
    _write_host_sources(host_scene["tm"], tmp_path)
    r = subprocess.run([*cmd, "-o", str(tmp_path / "tsan"), str(tmp_path / "main.cpp")],
                       capture_output=True, text=True)
    if r.returncode != 0 and ("tsan" in r.stderr or "sanitize" in r.stderr):
        pytest.skip(f"this toolchain has no ThreadSanitizer: {r.stderr[-300:]}")
    assert r.returncode == 0, r.stderr[-4000:]
    nb, n_steps, ctrl = 2, 2, host_scene["ctrls"][6]
    _host_input(host_scene, ctrl, "float64")[:nb].tofile(tmp_path / "in.bin")
    run = subprocess.run(
        [str(tmp_path / "tsan"), str(tmp_path / "in.bin"), str(nb), str(n_steps), str(tmp_path / "out.bin")],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "TSAN_OPTIONS": "halt_on_error=1 exitcode=66"},
    )
    if "unexpected memory mapping" in run.stderr:
        pytest.skip("ThreadSanitizer cannot run under this kernel's memory layout")
    assert "ThreadSanitizer" not in run.stderr and run.returncode == 0, run.stderr[-6000:]
    raw = (tmp_path / "out.bin").read_bytes()
    rows = host_kernel.out_rows()
    out64 = np.frombuffer(raw[: nb * rows * 8], np.float64).reshape(nb, rows)
    out32 = np.frombuffer(raw[nb * rows * 8 :], np.float32).reshape(nb, rows)
    if lanes == engine_cuda.LANES:
        for dtype, got in (("float64", out64), ("float32", out32)):
            np.testing.assert_array_equal(got, _run_host_kernel(host_kernel, host_scene, ctrl, dtype, n_steps)[:nb])
    else:
        assert np.isfinite(out64).all() and np.isfinite(out32).all()


# ---------------------------------------------------------------------------
# small pieces
# ---------------------------------------------------------------------------

# (function, kinds of its arguments): q unit quaternion, v 3-vector, s 6-vector,
# d Euler angles in degrees, m mass, I symmetric 3x3
_MATHS = [
    ("quat_mul", "qq"), ("quat_inv", "q"), ("normalize", "v"), ("rotate", "vq"),
    ("inv_rotate", "vq"), ("quat_to_mat", "q"), ("quat_to_euler", "q"), ("euler_to_quat", "d"),
    ("motion_cross", "ss"), ("force_cross", "ss"), ("skew", "v"), ("spatial_inertia", "mIv"),
]


@pytest.mark.parametrize("name,kinds", _MATHS)
def test_maths_matches_jax(name, kinds):
    """Each batched helper against its single-sample JAX counterpart: 1e-12."""
    rng = np.random.default_rng(11)
    make = {
        "q": lambda: (lambda q: q / np.linalg.norm(q, axis=1, keepdims=True))(rng.normal(size=(B, 4))),
        "v": lambda: rng.normal(size=(B, 3)), "s": lambda: rng.normal(size=(B, 6)),
        "d": lambda: rng.uniform(-170, 170, (B, 3)), "m": lambda: rng.uniform(0.1, 5, B),
        "I": lambda: (lambda a: a + a.transpose(0, 2, 1))(rng.normal(size=(B, 3, 3))),
    }
    args = [make[k]() for k in kinds]
    got = getattr(maths, name)(*[torch.tensor(a) for a in args])
    ref = jax.vmap(getattr(jmaths, name))(*[jnp.asarray(a) for a in args])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-12, rtol=1e-12)


def test_quat_integrate_matches_jax_and_takes_zero_velocity():
    rng = np.random.default_rng(12)
    q = rng.normal(size=(B, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w = rng.normal(size=(B, 3))
    w[0] = 0.0  # the axis is undefined at zero angular velocity; the result must be q
    got = maths.quat_integrate(torch.tensor(q), torch.tensor(w), 0.02)
    ref = jax.vmap(lambda a, b: jmaths.quat_integrate(a, b, 0.02))(jnp.asarray(q), jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-12)
    np.testing.assert_allclose(got[0].numpy(), q[0], atol=1e-15)


def test_cholesky_matches_lapack_and_clamps():
    rng = np.random.default_rng(5)
    A = rng.normal(size=(6, 9, 9))
    A = torch.tensor(A @ A.transpose(0, 2, 1) + 9 * np.eye(9))
    b = torch.tensor(rng.normal(size=(6, 9)))
    np.testing.assert_allclose(linalg.cholesky(A).numpy(), torch.linalg.cholesky(A).numpy(), atol=1e-12)
    np.testing.assert_allclose(linalg.solve_pd(A, b).numpy(), torch.linalg.solve(A, b).numpy(), atol=1e-12)
    singular = torch.zeros(1, 3, 3, dtype=F64)
    assert torch.isfinite(linalg.cholesky(singular)).all()


def test_data_from_numpy_roundtrip(go2):
    leaves = reference_utils.nested(go2["ref"], "trim")  # the JAX step's lean data, ctrls[0]
    for k in ("geom", "includemargin", "friction", "solref", "solimp", "dim"):
        leaves["contact"][k] = leaves["contact"][k][0]  # static rows carry no batch axis here
    td = convert.data_from_numpy(leaves, dtype=F64)
    assert isinstance(td, Data) and td.qpos.shape == (B, 19) and td.contact.pos.shape == (B, 4, 3)
    np.testing.assert_array_equal(td.x_pos.numpy(), leaves["x_pos"])
    assert td.contact.geom.dtype == torch.int32 and td.xpos is None


@HOST_RUN_LIMIT
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_kernel_source_pyramidal_condim6_matches_plain_version(tmp_path, dtype):
    """Condim-6 pyramids, which no shipped scene has: the Allegro scene with
    pyramidal cones (ten facets a condim-6 slot, the rotational ones weighted
    by invweight_r; eulerdamp kept on, without it the servos throw the
    fingers about within three steps), on the Allegro batch."""
    sc = dict(_scene("allegro"))
    mj = load_mj(SCENES["allegro"])
    mj.opt.cone = mujoco.mjtCone.mjCONE_PYRAMIDAL
    mj.opt.timestep = _timestep("allegro")
    sc["mj"], sc["tm"] = mj, put_model(mj, dtype=F64)
    lib = _build_host_kernel(sc["tm"], tmp_path)
    ctrl = sc["ctrls"][4]
    _assert_host_matches_plain(sc, _run_host_kernel(lib, sc, ctrl, dtype, 3), ctrl, dtype, 3)


def test_euler_damp_qacc_matches_jax():
    """Implicit joint damping at the Allegro key: (M + h diag(damping)) qacc
    = qfrc_smooth + qfrc_constraint, on the plain forward products of the
    Allegro's start poses (tools/scene_cases.py), against the JAX function on
    the same inputs: 1e-9 of qacc's scale."""
    import importlib

    # the packages export a function named forward: take the modules
    jforward = importlib.import_module("dial_mpc_tpu.physics.forward")
    torch_forward = importlib.import_module("dial_mpc_tpu_torch.physics.forward")

    mj, jm, tm = _models("allegro")
    assert not tm.opt.disable_eulerdamp and float(tm.dof_damping.max()) == 0.1
    rng = np.random.default_rng(3)
    cm = compiled_model.snapshot(mj)
    qpos = scene_cases.start_qpos("allegro", cm, B, rng)
    qvel = scene_cases.start_qvel("allegro", cm, B, rng)
    td = tforward(tm, _tdata(tm, qpos, qvel, float_checks.random_ctrl("allegro", mj, rng, qpos)))
    got = torch_forward._euler_damp_qacc(tm, td).numpy()
    d0 = jmodel.make_data(jm, dtype=jnp.float64)
    ref = jax.jit(jax.vmap(lambda qM, fs, fc: jforward._euler_damp_qacc(
        jm, jreplace(d0, qM=qM, qfrc_smooth=fs, qfrc_constraint=fc))))(
        *[jnp.asarray(getattr(td, k).numpy()) for k in ("qM", "qfrc_smooth", "qfrc_constraint")])
    scale = max(1.0, float(np.abs(np.asarray(ref)).max()))
    np.testing.assert_allclose(got / scale, np.asarray(ref) / scale, atol=1e-9)
    # the damped acceleration is not the constrained one
    assert not np.allclose(got, td.qacc.numpy())


# ---------------------------------------------------------------------------
# float32 branch flips: the port's against the reference's own
# ---------------------------------------------------------------------------

# samples the card's float32 plain version or kernel moved away from float64
# beyond tools/float_checks.py's limits in chip_smoke.py's runs (PERF.md
# section 6), in the batches made below (the kernel and the float32 plain
# version alike). The Allegro's are float_checks.REFERENCE_DEPARTS.
CARD_FLIPS = {("h1_walk", "settled"): [1012], ("go2_crate", "settled"): [811, 1899],
              ("h1_push_crate", "settled"): [391, 1072]}
B_CARD = 2049  # chip_smoke.py's batch: Nsample + 1 rollouts


def _card_batch(key):
    """chip_smoke.py's phase-3 batches of a scene (tools/float_checks.py,
    seed 0), made here by the plain float64 step: the settled states and the
    states three steps on (at the joint limits), with their ctrl, rounded to
    float32; the models in both types."""
    robot, xml = scene_cases.SCENES[key]
    cm = compiled_model.load_scene(robot, xml)
    cm.opt.timestep = _timestep(key)
    m64, m32 = put_model(cm, device="cpu", dtype=F64), put_model(cm, device="cpu", dtype=torch.float32)
    qpos, qvel, ctrl = float_checks.contact_rich_batch(key, cm, m64, B_CARD)
    at_limits = engine_cuda.step_core_reference(m64, qpos, qvel, ctrl, 3)
    batches = {"settled": (qpos, qvel), "at_limits": (at_limits[0], at_limits[1])}
    return m64, m32, {k: (q.float(), v.float(), ctrl.float()) for k, (q, v) in batches.items()}


_REF_STEPS = {}


def _reference_outputs(key, dtype, qpos, qvel, ctrl):
    """The reference's forward.step on a few samples, one jitted call a
    sample, in dtype; its 11 products in the order of engine_cuda.out_specs
    (an empty product as zero columns), then qfrc_constraint."""
    mj = load_mj(SCENES[key])
    mj.opt.timestep = _timestep(key)
    if (key, dtype) not in _REF_STEPS:
        jm = jmodel.put_model(mj, dtype=dtype)
        def step_and_qfrc(d):
            full = jax_step(jm, d)
            return engine_pallas.trim_data(jm, full), full.qfrc_constraint

        _REF_STEPS[key, dtype] = (jm, jax.jit(step_and_qfrc))
    jm, step1 = _REF_STEPS[key, dtype]
    d0 = jmodel.make_data(jm, dtype=dtype)
    rows = []
    # compiled without writing the persistent cache: XLA:CPU (jax 0.9.0)
    # aborted serializing one of these steps
    least = jax.config.jax_persistent_cache_min_compile_time_secs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1e9)
    try:
        step1(jreplace(d0, qpos=jnp.asarray(qpos[0], dtype), qvel=jnp.asarray(qvel[0], dtype),
                       ctrl=jnp.asarray(ctrl[0], dtype)))
    finally:
        jax.config.update("jax_persistent_cache_min_compile_time_secs", least)
    for q, v, c in zip(qpos, qvel, ctrl):
        lean, qfrc = step1(jreplace(d0, qpos=jnp.asarray(q, dtype), qvel=jnp.asarray(v, dtype),
                                    ctrl=jnp.asarray(c, dtype)))
        rows.append([np.asarray(a, np.float64).reshape(-1) for a in (
            lean.qpos, lean.qvel, lean.site_xpos, lean.site_xmat, lean.x_pos, lean.x_rot, lean.xd_vel,
            lean.xd_ang, lean.contact.dist, lean.contact.pos, lean.qacc, qfrc)])
    return [torch.tensor(np.stack(col)) for col in zip(*rows)]


def _contacts_on_reference_kinematics(key, q, v):
    """One sample's float32 kinematics in the reference and in the port, and
    the contacts of the reference's collider and of the port's, both on the
    reference's float32 kinematics: numpy arrays by name."""
    from dial_mpc_tpu.physics import collision as jcollision, kinematics as jkinematics
    from dial_mpc_tpu_torch.physics import collision as tcollision, kinematics as tkinematics

    mj = load_mj(SCENES[key])
    mj.opt.timestep = _timestep(key)
    jm = jmodel.put_model(mj, dtype=jnp.float32)
    d = jreplace(jmodel.make_data(jm, dtype=jnp.float32), qpos=jnp.asarray(q, jnp.float32),
                 qvel=jnp.asarray(v, jnp.float32))
    jk = jax.jit(lambda d: jkinematics.kinematics(jm, d))(d)
    jc = jax.jit(lambda d: jcollision.collide(jm, d))(jk).contact
    robot, xml = scene_cases.SCENES[key]
    cm = compiled_model.load_scene(robot, xml)
    tm = put_model(cm, device="cpu", dtype=torch.float32)
    td = make_data(tm, 1).replace(qpos=torch.tensor(np.asarray(q, np.float32))[None],
                                  qvel=torch.tensor(np.asarray(v, np.float32))[None])
    tk = tkinematics.kinematics(tm, td)
    on_ref = tk.replace(geom_xpos=torch.tensor(np.asarray(jk.geom_xpos))[None],
                        geom_xmat=torch.tensor(np.asarray(jk.geom_xmat))[None])
    tc = tcollision.collide(tm, on_ref).contact
    return dict(
        ref_geom_xpos=np.asarray(jk.geom_xpos), port_geom_xpos=tk.geom_xpos[0].numpy(),
        ref_geom_xmat=np.asarray(jk.geom_xmat), port_geom_xmat=tk.geom_xmat[0].numpy(),
        ref_pos=np.asarray(jc.pos), port_pos=tc.pos[0].numpy(), ref_dist=np.asarray(jc.dist),
        port_dist=tc.dist[0].numpy(),
    )


@pytest.mark.parametrize("key", list(SCENES))
def test_float32_flips_are_the_references_own(key):
    """chip_smoke.py holds a sample whose float32 plain version departs from
    float64 (beyond tools/float_checks.py's limits) to that float32 plain
    version instead, and a sample of float_checks.REFERENCE_DEPARTS to float64
    within twice the reference's own float32 departure. That is sound only
    where float32 rounding alone moves the sample, in the reference as in the
    port. On both batches chip_smoke.py makes (settled, at the joint limits):
    every sample the port's float32 step moves away, and those the card
    listed, must move away in the reference's float32 step from its float64
    step as well (or, where it does not, be a contact point that float32
    rounding of the kinematics sets, as said below); and at each listed
    sample the reference's departure must reach the listed one. The reference
    runs only on those samples."""
    m64, m32, batches = _card_batch(key)
    names = engine_cuda.OUTPUT_NAMES
    for batch, (q32, v32, c32) in batches.items():
        plain32 = engine_cuda.step_core_reference(m32, q32, v32, c32, 1)
        plain64 = engine_cuda.step_core_reference(m64, q32.double(), v32.double(), c32.double(), 1)
        tol, tol_default = float_checks.step_limits(torch.float32, plain64[names.index("qacc")], _timestep(key))
        listed = float_checks.REFERENCE_DEPARTS.get((key, batch), {})
        flipped = float_checks.departing(names, plain32, plain64, tol, tol_default).nonzero().flatten().tolist()
        assert len(set(flipped) | set(listed)) <= float_checks.MAX_FLIPPED, f"{key} {batch}: float32 moves {flipped}"
        for s in sorted(set(flipped) | set(CARD_FLIPS.get((key, batch), [])) | set(listed)):
            args = [a[[s]].double().numpy() for a in (q32, v32, c32)]
            ref32 = _reference_outputs(key, jnp.float32, *args)
            ref64 = _reference_outputs(key, jnp.float64, *args)
            err = {n: float((a - b).abs().max()) for n, a, b in zip([*names, "qfrc"], ref32, ref64) if b.shape[1]}
            for out, least in listed.get(s, {}).items():
                assert err[out] >= least, f"{key} {batch} sample {s}: the reference's float32 {out} departs by {err}"
            if any(not (e <= tol.get(n, tol_default)) for n, e in err.items() if n != "qfrc"):
                continue
            # The reference's float32 step stays there. Sound only where the
            # port's departure is a contact at a point that rounding sets (a
            # sphere centre a hair inside a box face, whose normal is the
            # direction of a vector of a few ulps of its ends): the port's
            # float32 kinematics within eight ulps of the reference's (a chain
            # of up to seven bodies, an ulp or so each), and the port's
            # collider on the reference's float32 kinematics giving the
            # reference's float32 contacts within two.
            mine = {n: float((a[s].double() - b[s]).abs().max()) for n, a, b in zip(names, plain32, plain64)}
            over = [n for n, e in mine.items() if not (e <= tol.get(n, tol_default))]
            assert set(over) <= {"cpos", "cdist"}, f"{key} {batch} sample {s}: the reference stays, the port's {over} depart"
            c = _contacts_on_reference_kinematics(key, args[0][0], args[1][0])
            ulp = float(np.finfo(np.float32).eps)
            for what, ulps in (("geom_xpos", 8), ("geom_xmat", 8), ("pos", 2), ("dist", 2)):
                ref, port = c["ref_" + what], c["port_" + what]
                np.testing.assert_allclose(port.reshape(ref.shape), ref, rtol=0,
                                           atol=ulps * ulp * max(1.0, float(np.abs(ref).max())),
                                           err_msg=f"{key} {batch} sample {s}: {what}")
