"""The Newton-solve kernel's plain version, wrapper and source against the JAX
package's solver (XLA route and Pallas kernel in interpret mode), CPU MuJoCo,
and itself.

Everything runs on the CPU (``device="cpu"``). Inputs are made from a seed
with numpy and handed to both sides as arrays.

Run with:  python -m pytest tests/test_torch_*.py -q
"""

import ctypes
import dataclasses
import functools
import os
import shutil
import subprocess
import types

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

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
from dial_mpc_tpu_torch.tools import solver_cases
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


@pytest.fixture(scope="module")
def go2_rows():
    """Go2 flat-scene constraint rows at B = 4, float64, from the JAX forward."""
    mj = load_mj(GO2)
    jm = jmodel.put_model(mj, dtype=jnp.float64)
    tm = put_model(mj, device="cpu", dtype=F64)
    qpos, qvel, ctrl = _go2_states(mj)
    jd = jax.jit(jax.vmap(functools.partial(jax_forward, jm)))(_jax_batch(jm, qpos, qvel, ctrl, jnp.float64))
    rows = dict(J=jd.efc.J, D=jd.efc.D, aref=jd.efc.aref, fl=jd.efc.frictionloss, eta=jd.efc.eta,
                M=jd.qM, qs=jd.qacc_smooth)
    rows = {k: np.asarray(v) for k, v in rows.items()}
    assert rows["J"].shape == (4, 28, 18) and (rows["D"] > 0).any(), "the batch must be in contact"
    efc = {f.name: np.asarray(getattr(jd.efc, f.name)) for f in dataclasses.fields(jd.efc)}
    return dict(mj=mj, jm=jm, tm=tm, rows=rows, efc=efc, qacc=np.asarray(jd.qacc),
                qfrc=np.asarray(jd.qfrc_constraint))


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
    xk, fk = _pallas(key, go2_rows["rows"])
    x, f = solver_cuda.solve_batched_reference(tm, *_torch_args(go2_rows["rows"]))
    scale = max(1.0, float(np.abs(xk).max()))
    np.testing.assert_allclose(x.numpy() / scale, xk / scale, atol=1e-9)
    np.testing.assert_allclose(f.numpy() / scale, fk / scale, atol=1e-9)


@pytest.mark.slow
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


@pytest.fixture(scope="module")
def synthetic():
    rows = solver_cases.synthetic_problem(seed=3, batch=B_SYN)
    tm = solver_cases.synthetic_model()
    x, f = solver_cuda.solve_batched_reference(tm, *_torch_args(rows))
    return dict(rows=rows, tm=tm, x=x.numpy(), f=f.numpy())


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
    jm = _jax_namespace()
    fn = jax.jit(jax.vmap(lambda *a: jsolver._solve_arrays(jm, *a)))
    xj, fj = fn(*[jnp.asarray(synthetic["rows"][k]) for k in ARGS])
    np.testing.assert_allclose(synthetic["x"], np.asarray(xj), atol=1e-9, rtol=1e-9)
    np.testing.assert_allclose(synthetic["f"], np.asarray(fj), atol=1e-9, rtol=1e-9)


def test_synthetic_plain_solve_matches_pallas_kernel(synthetic):
    key = solver_cuda.solver_key(synthetic["tm"], 12)
    assert key[5] == ((2, 3), (5, 6)) and key[6] == 2.0
    xk, fk = _pallas(key, synthetic["rows"])
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


@pytest.mark.parametrize("condim", [3, 6])
@pytest.mark.parametrize("impratio", [1.0, 10.0])
def test_elliptic_forward_matches_jax_and_mujoco(condim, impratio):
    """Against the JAX forward at float64 (1e-7, rows 1e-9 / 1e-7) and against
    CPU mj_forward with the tolerances of tests/test_physics_elliptic.py."""
    mj = _sphere_scene(condim, impratio)
    jm = jmodel.put_model(mj, dtype=jnp.float64)
    tm = put_model(mj, device="cpu", dtype=F64)
    assert constraint.elliptic_groups(tm) == ((0, condim),) and float(tm.opt.impratio) == impratio
    jfwd = jax.jit(lambda dd: jax_forward(jm, dd))
    qpos, qvel, qacc, qfrc = [], [], [], []
    for seed, scale, spin in _SPHERE_CASES:
        md = mujoco.MjData(mj)
        md.qvel[:] = np.random.default_rng(seed).normal(0, scale, 6)
        md.qvel[3:] += spin
        mujoco.mj_forward(mj, md)
        qpos.append(md.qpos.copy()); qvel.append(md.qvel.copy())
        qacc.append(md.qacc.copy()); qfrc.append(md.qfrc_constraint.copy())
    t = lambda a: torch.tensor(np.stack(a))
    td = tforward(tm, make_data(tm, len(qpos)).replace(qpos=t(qpos), qvel=t(qvel)))
    np.testing.assert_allclose(td.qacc.numpy(), np.stack(qacc), atol=5e-3)
    np.testing.assert_allclose(td.qfrc_constraint.numpy(), np.stack(qfrc), atol=2e-3)
    assert (td.efc.eta[:, 1:] > 0).all() and (td.efc.eta[:, 0] == 0).all()
    for i in range(len(qpos)):
        jd = jfwd(jreplace(jmodel.make_data(jm, dtype=jnp.float64), qpos=jnp.asarray(qpos[i]), qvel=jnp.asarray(qvel[i])))
        for name, tol in (("J", 1e-9), ("D", 1e-7), ("aref", 1e-7), ("eta", 0.0), ("frictionloss", 0.0)):
            np.testing.assert_allclose(getattr(td.efc, name)[i].numpy(), np.asarray(getattr(jd.efc, name)), atol=tol, rtol=1e-9, err_msg=name)
        np.testing.assert_allclose(td.qacc[i].numpy(), np.asarray(jd.qacc), atol=1e-7, rtol=1e-7)
        np.testing.assert_allclose(td.qfrc_constraint[i].numpy(), np.asarray(jd.qfrc_constraint), atol=1e-7, rtol=1e-7)


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


def test_solver_constants_header_and_key(go2_rows):
    tm = go2_rows["tm"]
    key = solver_cuda.solver_key(tm, 28)
    header = solver_cuda.render_constants_header(key)
    for line in ("#define SC_NV 18", "#define SC_NEFC 28", "#define SC_NGROUPS 0", "#define SCI_group_row0 {0}",
                 f"#define SC_ITERATIONS {tm.opt.iterations}", "#define SC_IMPRATIO 1.0"):
        assert line in header
    assert key == solver_cuda.solver_key(put_model(go2_rows["mj"], dtype=torch.float32), 28), \
        "one library serves both types"
    assert solver_cuda.in_rows(key) == 958  # and 36 values out: 994 a sample
    syn = solver_cuda.render_constants_header(solver_cuda.solver_key(solver_cases.synthetic_model(), 12))
    assert "#define SCI_row_simple {1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1}" in syn and "#define SCI_group_dim {3, 6}" in syn
    assert 1e4 < solver_cuda.solve_flops(key) < 1e6
    with pytest.raises(ValueError):
        solver_cuda.render_constants_header((6, 12, 2, 4, 1e-8, ((10, 3),), 1.0))
    packed = solver_cuda.pack_inputs(*_torch_args(go2_rows["rows"]))
    assert packed.shape == (958, 4) and packed.is_contiguous()
    assert torch.equal(packed[18 + 1], torch.tensor(go2_rows["rows"]["J"][:, 1, 1]))


def test_build_helper_is_shared_and_needs_nvcc(monkeypatch, tmp_path):
    """Both kernels build through cuda_build; without nvcc the build raises
    (there is no other way to a library)."""
    assert engine_cuda._CSRC == cuda_build.CSRC and "newton_solve_team.cuh" in engine_cuda._INCLUDES
    assert "newton_solve.cuh" not in engine_cuda._INCLUDES
    assert "newton_solve.cuh" in solver_cuda._INCLUDES
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
# (d) csrc/solver_newton.cu compiled for the host
# ---------------------------------------------------------------------------

_SHIM = """
#pragma once
#include <cmath>
#include <cstddef>
#define __device__
#define __forceinline__ inline
#define __noinline__
#define __constant__ static const
#define __global__
#define __restrict__
using std::sqrt; using std::fabs;
struct dim3_ { int x; };
static thread_local dim3_ blockIdx, blockDim, threadIdx;
"""
_HARNESS = """
#include "solver_newton_nolaunch.cu"
template <typename T> static void run(const T* in, T* out, int B) {
  blockDim.x = 1; threadIdx.x = 0;
  for (int t = 0; t < B; ++t) { blockIdx.x = t; solver_newton_kernel<T>(in, out, B); }
}
extern "C" void run_f64(const double* in, double* out, int B) { run<double>(in, out, B); }
extern "C" void run_f32(const float* in, float* out, int B) { run<float>(in, out, B); }
extern "C" int in_rows() { return sc::N_IN_ROWS; }
"""


def _build_host_solver(key, d, *flags):
    """csrc/solver_newton.cu compiled as host C++ (one thread per call) into d."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler")
    (d / "shim").mkdir()
    (d / "shim" / "cuda_runtime.h").write_text(_SHIM)
    (d / "solver_constants.h").write_text(solver_cuda.render_constants_header(key))
    src = open(os.path.join(cuda_build.CSRC, "solver_newton.cu")).read()
    (d / "solver_newton_nolaunch.cu").write_text(src[: src.index("constexpr int THREADS_PER_BLOCK")])
    (d / "harness.cpp").write_text(_HARNESS)
    cmd = [gxx, "-O1", *flags, "-std=c++17", "-shared", "-fPIC", "-x", "c++", "-I", str(d / "shim"),
           "-I", str(d), "-I", cuda_build.CSRC, "-o", str(d / "libh.so"), str(d / "harness.cpp")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if flags and "unrecognized command-line option" in r.stderr:
        pytest.skip(f"this g++ does not know {flags}")
    assert r.returncode == 0, r.stderr[-4000:]
    return ctypes.CDLL(str(d / "libh.so"))


def _run_host_solver(lib, rows, dtype):
    npdt = np.dtype(dtype)
    packed = solver_cuda.pack_inputs(*_torch_args(rows)).numpy().astype(npdt)
    B = packed.shape[1]
    assert packed.shape[0] == lib.in_rows()
    nv = rows["qs"].shape[1]
    out = np.zeros((2 * nv, B), npdt)
    fn = lib.run_f64 if dtype == "float64" else lib.run_f32
    fn(packed.ctypes.data_as(ctypes.c_void_p), out.ctypes.data_as(ctypes.c_void_p), B)
    return out[:nv].T, out[nv:].T


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
    return {name: _build_host_solver(case[0], tmp_path_factory.mktemp("host_" + name))
            for name, case in host_cases.items()}


@pytest.mark.parametrize("case", ["go2", "synthetic"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_solver_source_on_host_matches_plain_version(host_cases, host_solvers, case, dtype):
    """The kernel's arithmetic, checked where there is no nvcc and no card:
    1e-9 at float64; float32 arithmetic against the float64 plain version to
    1e-3 of the accelerations' size (the Hessian's conditioning amplifies
    the 6e-8 roundings)."""
    _, rows, x_ref, f_ref = host_cases[case]
    x, f = _run_host_solver(host_solvers[case], rows, dtype)
    scale = max(1.0, float(np.abs(x_ref).max()))
    tol = 1e-9 if dtype == "float64" else 1e-3
    np.testing.assert_allclose(x / scale, x_ref / scale, atol=tol)
    np.testing.assert_allclose(f / scale, f_ref / scale, atol=tol)


@pytest.fixture(scope="module")
def host_solvers_prefilled(host_cases, tmp_path_factory):
    """Host builds with every local variable pre-filled: zeros, a bit pattern."""
    return {
        name: [_build_host_solver(case[0], tmp_path_factory.mktemp(f"{name}_{fill}"), f"-ftrivial-auto-var-init={fill}")
               for fill in ("zero", "pattern")]
        for name, case in host_cases.items()
    }


@pytest.mark.parametrize("case", ["go2", "synthetic"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_solver_source_reads_no_uninitialised_value(host_cases, host_solvers, host_solvers_prefilled, case, dtype):
    """Whatever the kernel's local variables held before, the outputs are the
    same bit for bit."""
    rows = host_cases[case][1]
    plain = _run_host_solver(host_solvers[case], rows, dtype)
    for lib in host_solvers_prefilled[case]:
        for a, b in zip(_run_host_solver(lib, rows, dtype), plain):
            np.testing.assert_array_equal(a, b)
