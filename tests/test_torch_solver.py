"""The Newton-solve kernel's plain version, wrapper and source against the JAX
package's solver (XLA route and Pallas kernel in interpret mode), CPU MuJoCo,
and itself.

Everything runs on the CPU (``device="cpu"``). Inputs are made from a seed
with numpy and handed to both sides as arrays; the JAX side's outputs on them
are stored data (tests/reference_utils.py).

Run with:  python -m pytest tests/test_torch_*.py -q
"""

import ctypes
import dataclasses
import functools
import os
import subprocess
import types

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from tests import reference_utils
from tests.conftest import load_mj
from dial_mpc_tpu.physics import model as jmodel
from dial_mpc_tpu.physics import solver as jsolver
from dial_mpc_tpu.physics import solver_pallas
from dial_mpc_tpu.physics.forward import forward as jax_forward
from dial_mpc_tpu.physics.forward import step as jax_step
from dial_mpc_tpu.physics.kinematics import replace as jreplace

from dial_mpc_tpu_torch.physics import constraint, cuda_build, engine_cuda, solver, solver_cuda
from dial_mpc_tpu_torch.physics.forward import forward as tforward, step as tstep
from dial_mpc_tpu_torch.physics.model import make_data, put_model
from dial_mpc_tpu_torch.tools import host_build, solver_cases
from dial_mpc_tpu_torch.utils import convert

GO2 = "unitree_go2/mjx_scene_force.xml"
F64 = torch.float64
ARGS = ("J", "D", "aref", "fl", "eta", "M", "qs")


@pytest.fixture(autouse=True)
def _free_compiled_programs():
    """Interpret-mode kernels accumulate in the XLA:CPU runner; release them."""
    yield
    jax.clear_caches()
    jsolver._CORE_CACHE.clear()


def _go2_states(mj, B=4):
    """The batch of tests/test_pallas.py: the home pose pressed into the floor."""
    rng = np.random.default_rng(0)
    qpos = np.tile(mj.key_qpos[0], (B, 1))
    qpos[:, 2] -= 0.01
    qpos += rng.normal(0, 0.02, qpos.shape)
    qpos[:, 3:7] /= np.linalg.norm(qpos[:, 3:7], axis=1, keepdims=True)
    return qpos, rng.normal(0, 0.3, (B, mj.nv)), rng.normal(0, 5, (B, mj.nu))


def _jax_batch(jm, qpos, qvel, ctrl, dtype):
    d0 = jmodel.make_data(jm, dtype=dtype)
    dB = jax.tree.map(lambda x: jnp.broadcast_to(x, (qpos.shape[0],) + x.shape), d0)
    return dataclasses.replace(
        dB, qpos=jnp.asarray(qpos, dtype), qvel=jnp.asarray(qvel, dtype), ctrl=jnp.asarray(ctrl, dtype)
    )


def jax_go2_rows_reference():
    """The JAX side of the Go2 rows (tests/reference_data/solver_go2_rows.npz):
    the JAX forward's constraint rows, Efc, qacc and qfrc_constraint at B = 4,
    float64, and the Pallas solver kernel's solve of those rows."""
    mj = load_mj(GO2)
    jm = jmodel.put_model(mj, dtype=jnp.float64)
    qpos, qvel, ctrl = _go2_states(mj)
    jd = jax.jit(jax.vmap(functools.partial(jax_forward, jm)))(_jax_batch(jm, qpos, qvel, ctrl, jnp.float64))
    rows = dict(J=jd.efc.J, D=jd.efc.D, aref=jd.efc.aref, fl=jd.efc.frictionloss, eta=jd.efc.eta,
                M=jd.qM, qs=jd.qacc_smooth)
    rows = {k: np.asarray(v) for k, v in rows.items()}
    key = solver_cuda.solver_key(put_model(mj, device="cpu", dtype=F64), rows["J"].shape[1])
    xk, fk = _pallas(key, rows)
    return {"in.qpos": qpos, "in.qvel": qvel, "in.ctrl": ctrl, **{"rows." + k: v for k, v in rows.items()},
            **{"efc." + f.name: getattr(jd.efc, f.name) for f in dataclasses.fields(jd.efc)},
            "qacc": jd.qacc, "qfrc": jd.qfrc_constraint, "pallas.x": xk, "pallas.f": fk}


@pytest.fixture(scope="module")
def go2_rows():
    """Go2 flat-scene constraint rows at B = 4, float64, from the JAX forward
    (stored data)."""
    mj = load_mj(GO2)
    tm = put_model(mj, device="cpu", dtype=F64)
    qpos, qvel, ctrl = _go2_states(mj)
    ref = reference_utils.load("solver_go2_rows", qpos=qpos, qvel=qvel, ctrl=ctrl)
    rows = reference_utils.nested(ref, "rows")
    assert rows["J"].shape == (4, 28, 18) and (rows["D"] > 0).any(), "the batch must be in contact"
    return dict(mj=mj, tm=tm, rows=rows, efc=reference_utils.nested(ref, "efc"), qacc=ref["qacc"],
                qfrc=ref["qfrc"], pallas=(ref["pallas.x"], ref["pallas.f"]))


def _torch_args(rows, dtype=F64):
    return [torch.tensor(rows[k], dtype=dtype) for k in ARGS]


def _jax_namespace():
    """What the JAX solver reads of a Model, for the synthetic problem."""
    s = solver_cases.SPEC
    opt = types.SimpleNamespace(cone=1, disableflags=0, impratio=s["impratio"], iterations=s["iterations"],
                                ls_iterations=s["ls_iterations"], tolerance=s["tolerance"])
    return types.SimpleNamespace(nv=s["nv"], njnt=s["njnt"], jnt_type=s["jnt_type"], jnt_limited=s["jnt_limited"],
                                 dof_frictionloss_static=s["dof_frictionloss_static"],
                                 pair_table=s["pair_table"], opt=opt)


def _pallas(key, rows):
    """The JAX package's Pallas solver kernel, called directly (interpret mode)."""
    fn = solver_pallas._build(*key)
    return [np.asarray(a) for a in fn(*[jnp.asarray(rows[k]) for k in ARGS])]


# ---------------------------------------------------------------------------
# (a) Go2 rows: plain version against both JAX routes
# ---------------------------------------------------------------------------

def test_plain_solve_matches_jax_xla_on_go2_rows(go2_rows):
    """Against vmap(_solve_arrays), i.e. the JAX forward's own qacc: 1e-9."""
    x, f = solver_cuda.solve_batched_reference(go2_rows["tm"], *_torch_args(go2_rows["rows"]))
    np.testing.assert_allclose(x.numpy(), go2_rows["qacc"], atol=1e-9, rtol=1e-9)
    np.testing.assert_allclose(f.numpy(), go2_rows["qfrc"], atol=1e-9, rtol=1e-9)


def test_solve_stage_on_converted_rows_matches_jax(go2_rows):
    """The JAX package's constraint rows, brought across as an Efc, through
    the solve stage itself."""
    rows = go2_rows["rows"]
    efc = convert.efc_from_numpy(go2_rows["efc"], dtype=F64)
    assert efc.J.shape == (4, 28, 18) and efc.eta.shape == (4, 28) and efc.pos.dtype == F64
    one = convert.efc_from_numpy({k: v[0] for k, v in go2_rows["efc"].items()}, dtype=F64, batched=False)
    assert torch.equal(one.J, efc.J[:1])
    d = convert.data_from_numpy(
        dict(qpos=np.zeros((4, 19)), qvel=np.zeros((4, 18)), ctrl=np.zeros((4, 12)), time=np.zeros(4),
             qM=rows["M"], qacc_smooth=rows["qs"], efc=go2_rows["efc"]), dtype=F64)
    out = solver.solve(go2_rows["tm"], d)
    np.testing.assert_allclose(out.qacc.numpy(), go2_rows["qacc"], atol=1e-9, rtol=1e-9)
    np.testing.assert_allclose(out.qfrc_constraint.numpy(), go2_rows["qfrc"], atol=1e-9, rtol=1e-9)
    no_rows = d.replace(efc=dataclasses.replace(efc, J=efc.J[:, :0], D=efc.D[:, :0]))
    assert torch.equal(solver.solve(go2_rows["tm"], no_rows).qacc, d.qacc_smooth)


def test_plain_solve_matches_pallas_kernel_on_go2_rows(go2_rows):
    """Against the Pallas kernel itself on the same rows. It walks the same
    schedule in another order of operations (incremental jar and M dx): 1e-9
    relative to the accelerations' size."""
    tm = go2_rows["tm"]
    key = solver_cuda.solver_key(tm, 28)
    assert key == (18, 28, tm.opt.iterations, tm.opt.ls_iterations, float(tm.opt.tolerance), (), 1.0)
    xk, fk = go2_rows["pallas"]
    x, f = solver_cuda.solve_batched_reference(tm, *_torch_args(go2_rows["rows"]))
    scale = max(1.0, float(np.abs(xk).max()))
    np.testing.assert_allclose(x.numpy() / scale, xk / scale, atol=1e-9)
    np.testing.assert_allclose(f.numpy() / scale, fk / scale, atol=1e-9)


def test_plain_step_matches_jax_step_on_pallas_solver(monkeypatch):
    """One whole step at float32, the JAX side through vmap(forward.step) with
    the Pallas solver switched on, as tests/test_pallas.py runs it; that
    test's tolerances (qpos 1e-6, qvel 1e-4)."""
    mj = load_mj(GO2)
    jm = jmodel.put_model(mj)
    tm = put_model(mj, device="cpu", dtype=torch.float32)
    qpos, qvel, ctrl = _go2_states(mj)
    jsolver._CORE_CACHE.clear()
    monkeypatch.setenv("DIAL_MPC_PALLAS", "1")
    out_p = jax.jit(jax.vmap(functools.partial(jax_step, jm)))(_jax_batch(jm, qpos, qvel, ctrl, jnp.float32))
    t = lambda a: torch.tensor(np.asarray(a, np.float32))
    td = tstep(tm, make_data(tm, 4).replace(qpos=t(qpos), qvel=t(qvel), ctrl=t(ctrl)))
    np.testing.assert_allclose(td.qpos.numpy(), np.asarray(out_p.qpos), atol=1e-6)
    np.testing.assert_allclose(td.qvel.numpy(), np.asarray(out_p.qvel), atol=1e-4)


# ---------------------------------------------------------------------------
# (b) the synthetic problem: every row kind, every zone
# ---------------------------------------------------------------------------

B_SYN = 32


def jax_synthetic_reference():
    """The JAX side of the synthetic problem
    (tests/reference_data/solver_synthetic.npz): vmap(_solve_arrays), the XLA
    route, and the Pallas solver kernel on the same rows."""
    rows = solver_cases.synthetic_problem(seed=3, batch=B_SYN)
    jm = _jax_namespace()
    fn = jax.jit(jax.vmap(lambda *a: jsolver._solve_arrays(jm, *a)))
    xj, fj = fn(*[jnp.asarray(rows[k]) for k in ARGS])
    xk, fk = _pallas(solver_cuda.solver_key(solver_cases.synthetic_model(), 12), rows)
    return {**{"in." + k: rows[k] for k in ARGS}, "xla.x": xj, "xla.f": fj, "pallas.x": xk, "pallas.f": fk}


@pytest.fixture(scope="module")
def synthetic():
    rows = solver_cases.synthetic_problem(seed=3, batch=B_SYN)
    tm = solver_cases.synthetic_model()
    x, f = solver_cuda.solve_batched_reference(tm, *_torch_args(rows))
    ref = reference_utils.load("solver_synthetic", **{k: rows[k] for k in ARGS})
    return dict(rows=rows, tm=tm, x=x.numpy(), f=f.numpy(), ref=ref)


def test_synthetic_problem_reaches_every_branch(synthetic):
    rows = synthetic["rows"]
    for gi in range(2):
        counts = [int((rows["zone0"][:, gi] == z).sum()) for z in (-1, 0, 1, 2)]
        assert min(counts) > 0, f"group {gi}: inactive/top/middle/bottom counts {counts}"
    assert rows["clamped0"].any() and not rows["clamped0"].all()
    beyond = np.abs(rows["D"][:, 0] * (np.einsum("bi,bi->b", rows["J"][:, 0], rows["qs"]) - rows["aref"][:, 0])) > rows["fl"][:, 0]
    np.testing.assert_array_equal(beyond, rows["clamped0"])
    assert constraint.elliptic_groups(synthetic["tm"]) == solver_cases.SPEC["groups"]
    assert np.isfinite(synthetic["x"]).all() and np.abs(synthetic["f"]).max() > 1.0
    # the solve moves samples between zones: all three are still there at the end
    jar = np.einsum("bri,bi->br", rows["J"], synthetic["x"]) - rows["aref"]
    end = solver_cases.elliptic_zones(rows["D"], rows["eta"], jar)
    assert {0, 1, 2} <= set(end[rows["zone0"] >= 0].tolist())


def test_synthetic_plain_solve_matches_jax_xla(synthetic):
    xj, fj = synthetic["ref"]["xla.x"], synthetic["ref"]["xla.f"]
    np.testing.assert_allclose(synthetic["x"], np.asarray(xj), atol=1e-9, rtol=1e-9)
    np.testing.assert_allclose(synthetic["f"], np.asarray(fj), atol=1e-9, rtol=1e-9)


def test_synthetic_plain_solve_matches_pallas_kernel(synthetic):
    key = solver_cuda.solver_key(synthetic["tm"], 12)
    assert key[5] == ((2, 3), (5, 6)) and key[6] == 2.0
    xk, fk = synthetic["ref"]["pallas.x"], synthetic["ref"]["pallas.f"]
    np.testing.assert_allclose(synthetic["x"], xk, atol=1e-9, rtol=1e-9)
    np.testing.assert_allclose(synthetic["f"], fk, atol=1e-9, rtol=1e-9)


def test_synthetic_float32_stays_finite(synthetic):
    """1e-30 and 1e30 go through the same operations in float32: an inactive
    contact gives k ~ 0, not NaN."""
    tm32 = solver_cases.synthetic_model(dtype=torch.float32)
    x, f = solver_cuda.solve_batched(tm32, *_torch_args(synthetic["rows"], torch.float32))
    assert x.dtype == torch.float32 and torch.isfinite(x).all() and torch.isfinite(f).all()
    np.testing.assert_allclose(x.numpy(), synthetic["x"], atol=2e-3, rtol=2e-3)


# ---------------------------------------------------------------------------
# (c) elliptic cones in the plain physics: the sphere-on-plane calibration scene
# ---------------------------------------------------------------------------

def _sphere_scene(condim, impratio):
    xml = f"""<mujoco>
    <option cone="elliptic" impratio="{impratio}"/>
    <worldbody>
    <geom type='plane' size='5 5 .1' friction='0.8 0.02 0.003'/>
    <body pos='0 0 0.095'><freejoint/>
      <geom type='sphere' size='0.1' condim='{condim}' friction='0.8 0.02 0.003'/>
    </body>
    </worldbody></mujoco>"""
    mj = mujoco.MjModel.from_xml_string(xml)
    mj.opt.disableflags |= mujoco.mjtDisableBit.mjDSBL_WARMSTART.value
    mj.opt.iterations = 8
    mj.opt.ls_iterations = 8
    return mj


# (seed, qvel scale, spin): sliding and spinning, sticking, sliding, rolling
_SPHERE_CASES = [(0, 0.5, 3.0), (1, 0.001, 0.0), (3, 0.5, 0.0), (4, 1.0, -2.0)]


def _sphere_states(mj):
    """The _SPHERE_CASES states and CPU mj_forward's qacc, qfrc_constraint."""
    qpos, qvel, qacc, qfrc = [], [], [], []
    for seed, scale, spin in _SPHERE_CASES:
        md = mujoco.MjData(mj)
        md.qvel[:] = np.random.default_rng(seed).normal(0, scale, 6)
        md.qvel[3:] += spin
        mujoco.mj_forward(mj, md)
        qpos.append(md.qpos.copy()); qvel.append(md.qvel.copy())
        qacc.append(md.qacc.copy()); qfrc.append(md.qfrc_constraint.copy())
    return [np.stack(a) for a in (qpos, qvel, qacc, qfrc)]


_EFC_TOL = (("J", 1e-9), ("D", 1e-7), ("aref", 1e-7), ("eta", 0.0), ("frictionloss", 0.0))


def jax_elliptic_reference():
    """The JAX forward at float64 on the sphere-on-plane states of each
    (condim, impratio) (tests/reference_data/solver_elliptic.npz): rows,
    qacc and qfrc_constraint, a jitted single-state call a state."""
    out = {}
    for condim, impratio in [(c, i) for c in (3, 6) for i in (1.0, 10.0)]:
        mj = _sphere_scene(condim, impratio)
        jm = jmodel.put_model(mj, dtype=jnp.float64)
        jfwd = jax.jit(lambda dd: jax_forward(jm, dd))
        qpos, qvel, _, _ = _sphere_states(mj)
        case = f"{condim}_{impratio:g}"
        out[f"in.qpos_{case}"], out[f"in.qvel_{case}"] = qpos, qvel
        jds = [jfwd(jreplace(jmodel.make_data(jm, dtype=jnp.float64), qpos=jnp.asarray(q), qvel=jnp.asarray(v)))
               for q, v in zip(qpos, qvel)]
        for name, _ in _EFC_TOL:
            out[f"{case}.efc.{name}"] = np.stack([np.asarray(getattr(jd.efc, name)) for jd in jds])
        out[f"{case}.qacc"] = np.stack([np.asarray(jd.qacc) for jd in jds])
        out[f"{case}.qfrc"] = np.stack([np.asarray(jd.qfrc_constraint) for jd in jds])
    return out


@pytest.mark.parametrize("condim", [3, 6])
@pytest.mark.parametrize("impratio", [1.0, 10.0])
def test_elliptic_forward_matches_jax_and_mujoco(condim, impratio):
    """Against the JAX forward at float64 (1e-7, rows 1e-9 / 1e-7; stored
    data) and against CPU mj_forward with the tolerances of
    tests/test_physics_elliptic.py."""
    mj = _sphere_scene(condim, impratio)
    tm = put_model(mj, device="cpu", dtype=F64)
    assert constraint.elliptic_groups(tm) == ((0, condim),) and float(tm.opt.impratio) == impratio
    qpos, qvel, qacc, qfrc = _sphere_states(mj)
    case = f"{condim}_{impratio:g}"
    ref = reference_utils.load("solver_elliptic", **{f"qpos_{case}": qpos, f"qvel_{case}": qvel})
    t = lambda a: torch.tensor(a)
    td = tforward(tm, make_data(tm, len(qpos)).replace(qpos=t(qpos), qvel=t(qvel)))
    np.testing.assert_allclose(td.qacc.numpy(), qacc, atol=5e-3)
    np.testing.assert_allclose(td.qfrc_constraint.numpy(), qfrc, atol=2e-3)
    assert (td.efc.eta[:, 1:] > 0).all() and (td.efc.eta[:, 0] == 0).all()
    for i in range(len(qpos)):
        for name, tol in _EFC_TOL:
            np.testing.assert_allclose(getattr(td.efc, name)[i].numpy(), ref[f"{case}.efc.{name}"][i], atol=tol, rtol=1e-9, err_msg=name)
        np.testing.assert_allclose(td.qacc[i].numpy(), ref[f"{case}.qacc"][i], atol=1e-7, rtol=1e-7)
        np.testing.assert_allclose(td.qfrc_constraint[i].numpy(), ref[f"{case}.qfrc"][i], atol=1e-7, rtol=1e-7)


# ---------------------------------------------------------------------------
# the wrapper, the dispatch and the generated header
# ---------------------------------------------------------------------------

def test_solve_batched_cpu_uses_plain_version_and_counts_no_launch(go2_rows):
    args = _torch_args(go2_rows["rows"])
    before = solver_cuda.solve_batched.launches
    x, f = solver_cuda.solve_batched(go2_rows["tm"], *args)
    xr, fr = solver_cuda.solve_batched_reference(go2_rows["tm"], *args)
    assert solver_cuda.solve_batched.launches == before
    assert torch.equal(x, xr) and torch.equal(f, fr)


def test_solve_stage_dispatches_to_the_wrapper_and_the_plain_chain_does_not(go2_rows, monkeypatch):
    """solver.solve goes through solver_cuda.solve_batched; solve_reference and
    the step kernel's plain version never do, on any device."""
    tm, mj = go2_rows["tm"], go2_rows["mj"]
    qpos, qvel, ctrl = (torch.tensor(a) for a in _go2_states(mj))
    d = make_data(tm, 4).replace(qpos=qpos, qvel=qvel, ctrl=ctrl)
    full = tforward(tm, d)
    plain = tforward(tm, d, solver.solve_reference)
    assert torch.equal(full.qacc, plain.qacc) and torch.equal(full.qfrc_constraint, plain.qfrc_constraint)
    np.testing.assert_allclose(full.qacc.numpy(), go2_rows["qacc"], atol=1e-7, rtol=1e-7)

    calls = []
    real = solver_cuda.solve_batched
    monkeypatch.setattr(solver_cuda, "solve_batched", lambda *a: calls.append(1) or real(*a))
    tforward(tm, d)
    assert len(calls) == 1
    tforward(tm, d, solver.solve_reference)
    engine_cuda.step_core_reference(tm, qpos, qvel, ctrl, 2)
    assert len(calls) == 1


def test_solve_batched_rejects_bad_inputs(go2_rows):
    J, D, aref, fl, eta, M, qs = _torch_args(go2_rows["rows"])
    tm = go2_rows["tm"]
    with pytest.raises(ValueError):
        solver_cuda.solve_batched(tm, J[:, :, :5], D, aref, fl, eta, M, qs)
    with pytest.raises(ValueError):
        solver_cuda.solve_batched(tm, J, D[:, :3], aref, fl, eta, M, qs)
    with pytest.raises(ValueError):
        solver_cuda.solve_batched(tm, J, D, aref, fl, eta, M.float(), qs)
    with pytest.raises(ValueError):
        solver_cuda.solve_batched(tm, J[:, :0], D[:, :0], aref[:, :0], fl[:, :0], eta[:, :0], M, qs)
    with pytest.raises(ValueError):  # an elliptic group beyond the rows given
        a = _torch_args(solver_cases.synthetic_problem(0, 2))
        solver_cuda.solve_batched(solver_cases.synthetic_model(), a[0][:, :8], *[v[:, :8] for v in a[1:5]], a[5], a[6])


def test_solve_stage_hands_the_kernel_contiguous_inputs(go2_rows, monkeypatch):
    """The kernel reads its seven inputs in place and its wrapper refuses
    non-contiguous ones on the card: the solve stage of the plain forward
    (the unfused route and every reset) hands it contiguous tensors."""
    tm, mj = go2_rows["tm"], go2_rows["mj"]
    qpos, qvel, ctrl = (torch.tensor(a) for a in _go2_states(mj))
    seen = []
    real = solver_cuda.solve_batched
    monkeypatch.setattr(solver_cuda, "solve_batched", lambda m, *a: seen.append(a) or real(m, *a))
    tforward(tm, make_data(tm, 4).replace(qpos=qpos, qvel=qvel, ctrl=ctrl))
    assert len(seen) == 1 and all(t.is_contiguous() for t in seen[0])


def test_solver_constants_header_and_key(go2_rows):
    tm = go2_rows["tm"]
    key = solver_cuda.solver_key(tm, 28)
    header = solver_cuda.render_constants_header(key)
    for line in ("#define SC_NV 18", "#define SC_NEFC 28", "#define SC_NGROUPS 0", "#define SCI_group_row0 {0}",
                 f"#define SC_ITERATIONS {tm.opt.iterations}", "#define SC_IMPRATIO 1.0"):
        assert line in header
    assert key == solver_cuda.solver_key(put_model(go2_rows["mj"], dtype=torch.float32), 28), \
        "one library serves both types"
    assert solver_cuda.io_values(key) == (958, 36)  # 994 values a sample
    syn = solver_cuda.render_constants_header(solver_cuda.solver_key(solver_cases.synthetic_model(), 12))
    assert "#define SCI_group_row0 {2, 5}" in syn and "#define SCI_group_dim {3, 6}" in syn
    assert "#define SC_NGROUPS 2" in syn and "#define SC_IMPRATIO 2.0" in syn
    assert 1e4 < solver_cuda.solve_flops(key) < 1e6
    with pytest.raises(ValueError):
        solver_cuda.render_constants_header((6, 12, 2, 4, 1e-8, ((10, 3),), 1.0))


def test_build_helper_is_shared_and_needs_nvcc(monkeypatch, tmp_path):
    """Both kernels build through cuda_build; without nvcc the build raises
    (there is no other way to a library)."""
    assert engine_cuda._CSRC == cuda_build.CSRC and "newton_solve_team.cuh" in engine_cuda._INCLUDES
    assert "newton_solve_team.cuh" in solver_cuda._INCLUDES
    assert not os.path.exists(os.path.join(cuda_build.CSRC, "newton_solve.cuh"))
    for name in ("engine_step.cu", "solver_newton.cu", "newton_solve_team.cuh"):
        assert "ROW_LOOP" not in open(os.path.join(cuda_build.CSRC, name)).read()
    monkeypatch.setenv("DIAL_MPC_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: (_ for _ in ()).throw(RuntimeError("nvcc not found")))
    with pytest.raises(RuntimeError, match="nvcc"):
        solver_cuda.load_library((6, 12, 2, 4, 1e-8, (), 1.0))
    log = ("ptxas info    : Compiling entry function '_Z1kIfEvv' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z1kIfEvv\n"
           "    12032 bytes stack frame, 92 bytes spill stores, 92 bytes spill loads\n"
           "ptxas info    : Used 255 registers, used 0 barriers, 16 bytes smem, 12032 bytes cumulative stack size\nother")
    assert cuda_build.ptxas_entries(log) == {"_Z1kIfEvv": dict(
        stack=12032, spill_stores=92, spill_loads=92, registers=255, static_smem=16)}


# ---------------------------------------------------------------------------
# (d) csrc/solver_newton.cu compiled for the host, a thread a lane
# ---------------------------------------------------------------------------

_HARNESS = """
#include "solver_newton_nolaunch.cu"
#include "run_team.h"
#include <cstring>
// a: J, M, D, aref, fl, eta, qs, each sample-major; one team a sample, its
// shared memory pre-filled with the byte fill
template <typename T> static void run(const T* const* a, T* x, T* qfrc, int B, int fill) {
  using namespace sc;
  for (int s = 0; s < B; ++s) {
    std::vector<unsigned char> shared(sizeof(SolverShared<T>));
    std::memset(shared.data(), fill, shared.size());
    run_team([&](int l) {
      solve_sample<T>(Team{l, 0xffffffffu}, *reinterpret_cast<SolverShared<T>*>(shared.data()),
                      a[0] + (size_t)s * NEFC * NV, a[1] + (size_t)s * NV * NV, a[2] + (size_t)s * NEFC,
                      a[3] + (size_t)s * NEFC, a[4] + (size_t)s * NEFC, a[5] + (size_t)s * NEFC,
                      a[6] + (size_t)s * NV, x + (size_t)s * NV, qfrc + (size_t)s * NV);
    });
  }
}
#define RUN(name, T) \\
  extern "C" void name(const T* J, const T* M, const T* D, const T* aref, const T* fl, const T* eta, \\
                       const T* qs, T* x, T* qfrc, int B, int fill) { \\
    const T* a[7] = {J, M, D, aref, fl, eta, qs}; \\
    run<T>(a, x, qfrc, B, fill); \\
  }
RUN(run_f64, double)
RUN(run_f32, float)
extern "C" int lanes() { return LANES; }
extern "C" int nv() { return sc::NV; }
"""
# a program around the harness, for builds that cannot be loaded into Python
# (ThreadSanitizer): the seven float64 inputs of B samples from a file, solved
# in float64 and in float32, both results (x, qfrc) into another
_MAIN = """
#include "harness.cpp"
#include <cstdio>
#include <cstdlib>
int main(int argc, char** argv) {
  using namespace sc;
  const int B = std::atoi(argv[2]);
  const size_t n[7] = {(size_t)NEFC * NV, (size_t)NV * NV, NEFC, NEFC, NEFC, NEFC, NV};
  std::vector<double> in[7];
  FILE* f = std::fopen(argv[1], "rb");
  for (int k = 0; k < 7; ++k) {
    in[k].resize(n[k] * B);
    if (!f || std::fread(in[k].data(), sizeof(double), in[k].size(), f) != in[k].size()) return 2;
  }
  std::fclose(f);
  std::vector<double> x((size_t)B * NV), q((size_t)B * NV);
  const double* a[7];
  for (int k = 0; k < 7; ++k) a[k] = in[k].data();
  run<double>(a, x.data(), q.data(), B, 0);
  std::vector<float> in32[7], x32(x.size()), q32(q.size());
  const float* a32[7];
  for (int k = 0; k < 7; ++k) {
    in32[k].assign(in[k].begin(), in[k].end());
    a32[k] = in32[k].data();
  }
  run<float>(a32, x32.data(), q32.data(), B, 0);
  f = std::fopen(argv[3], "wb");
  std::fwrite(x.data(), sizeof(double), x.size(), f);
  std::fwrite(q.data(), sizeof(double), q.size(), f);
  std::fwrite(x32.data(), sizeof(float), x32.size(), f);
  std::fwrite(q32.data(), sizeof(float), q32.size(), f);
  std::fclose(f);
  return 0;
}
"""
KERNEL_ARGS = ("J", "M", "D", "aref", "fl", "eta", "qs")  # the kernel's order
SHARED_FILLS = (0x00, 0xFF)  # zeros, and NaN in either type
# the host builds run a team's lanes as threads that meet at a barrier every
# phase: on a loaded CPU a run takes many times its usual seconds (10 s to
# 360 s seen), so these tests get more than the default limit
HOST_RUN_LIMIT = pytest.mark.timeout(600)


def _write_host_sources(key, d):
    host_build.write_shim(d)
    (d / "solver_constants.h").write_text(solver_cuda.render_constants_header(key))
    (d / "solver_newton_nolaunch.cu").write_text(
        host_build.source_without_launch("solver_newton.cu", "constexpr int MAX_SAMPLES_PER_BLOCK"))
    (d / "harness.cpp").write_text(_HARNESS)
    (d / "main.cpp").write_text(_MAIN)


def _gxx_cmd(d, *flags, lanes=engine_cuda.LANES):
    try:
        return host_build.gxx_command(d, *flags, lanes=lanes)
    except FileNotFoundError:
        pytest.skip("no host C++ compiler")


def _build_host_solver(key, d, *flags, lanes=engine_cuda.LANES):
    """csrc/solver_newton.cu compiled as host C++ (a thread a lane) into d."""
    cmd = _gxx_cmd(d, *flags, lanes=lanes)
    _write_host_sources(key, d)
    r = subprocess.run([*cmd, "-shared", "-fPIC", "-o", str(d / "libh.so"), str(d / "harness.cpp")],
                       capture_output=True, text=True)
    if flags and "unrecognized command-line option" in r.stderr:
        pytest.skip(f"this g++ does not know {flags}")
    assert r.returncode == 0, r.stderr[-4000:]
    lib = ctypes.CDLL(str(d / "libh.so"))
    for fn in (lib.run_f64, lib.run_f32):
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_int]
    assert lib.lanes() == lanes and lib.nv() == key[0]
    return lib


def _run_host_solver(lib, rows, dtype, fill=0):
    """x and qfrc (B, nv) of the host build, from the rows' float64 arrays
    rounded to dtype."""
    npdt = np.dtype(dtype)
    args = [np.ascontiguousarray(rows[k], dtype=npdt) for k in KERNEL_ARGS]
    B, nv = rows["qs"].shape
    x, qfrc = np.zeros((B, nv), npdt), np.zeros((B, nv), npdt)
    fn = lib.run_f64 if dtype == "float64" else lib.run_f32
    fn(*[a.ctypes.data_as(ctypes.c_void_p) for a in (*args, x, qfrc)], B, fill)
    return x, qfrc


@pytest.fixture(scope="module")
def host_cases(go2_rows, synthetic):
    """name -> (key, rows, plain x, plain qfrc)"""
    tm = go2_rows["tm"]
    xg, fg = solver_cuda.solve_batched_reference(tm, *_torch_args(go2_rows["rows"]))
    return {
        "go2": (solver_cuda.solver_key(tm, 28), go2_rows["rows"], xg.numpy(), fg.numpy()),
        "synthetic": (solver_cuda.solver_key(synthetic["tm"], 12), synthetic["rows"], synthetic["x"], synthetic["f"]),
    }


@pytest.fixture(scope="module")
def host_solvers(host_cases, tmp_path_factory):
    """name -> {lanes: library}, built at first use"""
    libs = {name: {} for name in host_cases}

    def get(name, lanes=engine_cuda.LANES):
        if lanes not in libs[name]:
            d = tmp_path_factory.mktemp(f"host_{name}_{lanes}")
            libs[name][lanes] = _build_host_solver(host_cases[name][0], d, lanes=lanes)
        return libs[name][lanes]

    return get


def _assert_host_matches_plain(host_cases, case, x, f, dtype):
    """1e-9 at float64; float32 arithmetic against the float64 plain version
    to 1e-3 of the accelerations' size (the Hessian's conditioning amplifies
    the 6e-8 roundings)."""
    _, _, x_ref, f_ref = host_cases[case]
    scale = max(1.0, float(np.abs(x_ref).max()))
    tol = 1e-9 if dtype == "float64" else 1e-3
    np.testing.assert_allclose(x / scale, x_ref / scale, atol=tol)
    np.testing.assert_allclose(f / scale, f_ref / scale, atol=tol)


@HOST_RUN_LIMIT
@pytest.mark.parametrize("case", ["go2", "synthetic"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_solver_source_on_host_matches_plain_version(host_cases, host_solvers, case, dtype):
    """The kernel's arithmetic, checked where there is no nvcc and no card."""
    x, f = _run_host_solver(host_solvers(case), host_cases[case][1], dtype)
    _assert_host_matches_plain(host_cases, case, x, f, dtype)


@HOST_RUN_LIMIT
@pytest.mark.parametrize("lanes", [16, 8])
@pytest.mark.parametrize("case", ["go2", "synthetic"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_solver_source_with_fewer_lanes_matches_plain_version(host_cases, host_solvers, lanes, case, dtype):
    """The team size is a compile-time constant. At 16 lanes a Go2 lane owns
    two rows and two dofs; at 8 lanes the synthetic problem's elliptic groups
    span rows of two and three lanes and each lane holds more Hessian
    entries: the same function all the same."""
    x, f = _run_host_solver(host_solvers(case, lanes), host_cases[case][1], dtype)
    _assert_host_matches_plain(host_cases, case, x, f, dtype)


@pytest.fixture(scope="module")
def host_solvers_prefilled(host_cases, tmp_path_factory):
    """Host builds with every local variable pre-filled: zeros, a bit pattern."""
    return {
        name: [_build_host_solver(case[0], tmp_path_factory.mktemp(f"{name}_{fill}"), f"-ftrivial-auto-var-init={fill}")
               for fill in ("zero", "pattern")]
        for name, case in host_cases.items()
    }


@HOST_RUN_LIMIT
@pytest.mark.parametrize("case", ["go2", "synthetic"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_solver_source_reads_no_uninitialised_value(host_cases, host_solvers, host_solvers_prefilled, case, dtype):
    """Whatever the kernel's local variables and the team's shared memory held
    before (zeros, NaN), the outputs are the same bit for bit."""
    rows = host_cases[case][1]
    plain = _run_host_solver(host_solvers(case), rows, dtype)
    for lib in (host_solvers(case), *host_solvers_prefilled[case]):
        for fill in SHARED_FILLS:
            for a, b in zip(_run_host_solver(lib, rows, dtype, fill), plain):
                np.testing.assert_array_equal(a, b)


@HOST_RUN_LIMIT
@pytest.mark.parametrize("case,lanes", [("go2", 32), ("synthetic", 32), ("synthetic", 8)])
def test_solver_source_has_no_data_race(host_cases, host_solvers, tmp_path, case, lanes):
    """ThreadSanitizer over the lane-emulating host build, three samples in
    both types: no lane reads or writes a value another lane writes in the
    same phase (between two team syncs). Shuffles are barriers on the host,
    so this cannot see a missing sync that a shuffle stands in for. The
    outputs equal the plain host build's."""
    key, rows = host_cases[case][:2]
    cmd = _gxx_cmd(tmp_path, "-fsanitize=thread", "-g", lanes=lanes)
    _write_host_sources(key, tmp_path)
    r = subprocess.run([*cmd, "-o", str(tmp_path / "tsan"), str(tmp_path / "main.cpp")],
                       capture_output=True, text=True)
    if r.returncode != 0 and ("tsan" in r.stderr or "sanitize" in r.stderr):
        pytest.skip(f"this toolchain has no ThreadSanitizer: {r.stderr[-300:]}")
    assert r.returncode == 0, r.stderr[-4000:]
    nb = 3
    few = {k: rows[k][:nb] for k in KERNEL_ARGS}
    np.concatenate([np.ascontiguousarray(few[k], np.float64).ravel() for k in KERNEL_ARGS]).tofile(tmp_path / "in.bin")
    run = subprocess.run(
        [str(tmp_path / "tsan"), str(tmp_path / "in.bin"), str(nb), str(tmp_path / "out.bin")],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "TSAN_OPTIONS": "halt_on_error=1 exitcode=66"},
    )
    if "unexpected memory mapping" in run.stderr:
        pytest.skip("ThreadSanitizer cannot run under this kernel's memory layout")
    assert "ThreadSanitizer" not in run.stderr and run.returncode == 0, run.stderr[-6000:]
    raw = (tmp_path / "out.bin").read_bytes()
    nv = key[0]
    n = nb * nv
    x64, q64 = np.frombuffer(raw[: 2 * n * 8], np.float64).reshape(2, nb, nv)
    x32, q32 = np.frombuffer(raw[2 * n * 8 :], np.float32).reshape(2, nb, nv)
    lib = host_solvers(case, lanes)
    for dtype, got in (("float64", (x64, q64)), ("float32", (x32, q32))):
        for a, b in zip(got, _run_host_solver(lib, few, dtype)):
            np.testing.assert_array_equal(a, b)
