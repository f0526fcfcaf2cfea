"""The standalone Newton-solve CUDA kernel: build, wrapper and plain version.

``solve_batched(model, J, D, aref, fl, eta, M, qs)`` solves, for each of B
samples, ``min_x 0.5 (x-qs)' M (x-qs) + sum_i s_i(J_i x - aref_i)`` on dense
inputs ``J (B, nefc, nv)``, ``M (B, nv, nv)``, ``D / aref / fl / eta
(B, nefc)``, ``qs (B, nv)`` and returns ``x`` and ``qfrc = J' force``, both
``(B, nv)``. On CUDA tensors it launches the hand-written kernel of
``csrc/solver_newton.cu`` (a team of lanes per sample, the working set in
shared memory) or raises; on CPU tensors it runs
:func:`solve_batched_reference`, the plain ``solver._solve_arrays``.

The kernel's statics are its key: nv, nefc, the solver schedule, the
tolerance, the elliptic groups' rows and impratio. One shared library is built
per key from ``csrc/`` plus a generated ``solver_constants.h`` that holds
exactly those; it serves float32 and float64.

The kernel reads the seven inputs in place, sample-major as they come, and
writes the two outputs in place: the wrapper makes no copy.
"""

from __future__ import annotations

import ctypes
import weakref

import torch

from dial_mpc_tpu_torch.physics import cuda_build, solver
from dial_mpc_tpu_torch.physics.constraint import elliptic_groups
from dial_mpc_tpu_torch.physics.model import Model

_INCLUDES = ("lane_math.cuh", "newton_solve_team.cuh")


def solver_key(m: Model, nefc: int) -> tuple:
    """(nv, nefc, iterations, ls_iterations, tolerance, groups, impratio)."""
    return (
        m.nv, int(nefc), m.opt.iterations, m.opt.ls_iterations, float(m.opt.tolerance),
        tuple(elliptic_groups(m)), float(m.opt.impratio),
    )


def io_values(key: tuple) -> tuple:
    """Values one sample reads (J, M, D, aref, fl, eta, qs) and writes (x, qfrc)."""
    nv, nefc = key[:2]
    return nefc * nv + nv * nv + 4 * nefc + nv, 2 * nv


def render_constants_header(key: tuple) -> str:
    """The text of ``solver_constants.h`` for this key."""
    nv, nefc, iterations, ls_iterations, tolerance, groups, impratio = key
    if nv < 1 or nefc < 1:
        raise ValueError(f"CUDA solver kernel: nv and nefc must be positive, got {(nv, nefc)}")
    for row0, dim in groups:
        if not (2 <= dim <= 6 and 0 <= row0 and row0 + dim <= nefc):
            raise ValueError(f"CUDA solver kernel: bad elliptic group {(row0, dim)} for nefc {nefc}")

    def init(values):
        return "{" + ", ".join(str(int(v)) for v in values) + "}" if values else "{0}"

    lines = [
        "// Generated from the solver kernel's key by solver_cuda.render_constants_header;",
        "// the kernel's code is in csrc/ and is not generated.",
        "#pragma once",
        f"#define SC_NV {nv}",
        f"#define SC_NEFC {nefc}",
        f"#define SC_ITERATIONS {iterations}",
        f"#define SC_LS_ITERATIONS {ls_iterations}",
        f"#define SC_NGROUPS {len(groups)}",
        f"#define SC_TOLERANCE {float(tolerance)!r}",
        f"#define SC_IMPRATIO {float(impratio)!r}",
        f"#define SCI_group_row0 {init([g[0] for g in groups])}",
        f"#define SCI_group_dim {init([g[1] for g in groups])}",
    ]
    return "\n".join(lines) + "\n"


def solve_flops(key: tuple) -> int:
    """Floating-point operations of the dense schedule for one sample (an
    add, a multiply, a divide or a square root each count one). The schedule
    is static, so the count does not depend on the data."""
    nv, nefc, iterations, ls_iterations, _tol, groups, _ir = key
    gdims = sum(dim for _, dim in groups)
    tri = nv * (nv + 1) // 2
    terms = 8 * nefc + sum(14 * dim + 20 for _, dim in groups)  # force, weight, cost per row
    jx = 2 * nefc * nv  # J v or J' w
    chol = nv**3 // 3 + 2 * nv * nv + 3 * nv  # factorisation and two triangular solves
    hessian = nefc * (nv + 2 * tri) + sum(2 * dim * nv + 3 * tri for _, dim in groups)
    per_ls = 2 * nefc + terms + 5 * nefc + 3 * gdims + 8
    per_iter = (
        terms + 2 * nv + jx + 2 * nv + hessian + chol + jx + 2 * nv * nv + 4 * nv
        + max(ls_iterations, 1) * per_ls + 2 * nefc + terms + 6 * nv + 8 + 6 * nv
    )
    return int(jx + nefc + iterations * per_iter + terms + jx)


class SolverLibrary:
    """A loaded shared library for one solver key."""

    def __init__(self, built: cuda_build.BuiltLibrary):
        self.path = built.path
        self.build_seconds = built.seconds
        self.build_log = built.log
        self.lib = ctypes.CDLL(built.path)
        for name in ("solver_newton_f32", "solver_newton_f64"):
            fn = getattr(self.lib, name)
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for name in ("solver_nv", "solver_nefc", "solver_lanes", "solver_team_bytes_f32",
                     "solver_team_bytes_f64", "solver_samples_per_block_f32",
                     "solver_samples_per_block_f64", "solver_teams_per_sm_f32",
                     "solver_teams_per_sm_f64"):
            getattr(self.lib, name).restype = ctypes.c_int
        self.nv = self.lib.solver_nv()
        self.nefc = self.lib.solver_nefc()
        self.lanes = self.lib.solver_lanes()
        self._shapes = {}

    def fn(self, dtype: torch.dtype):
        if dtype == torch.float32:
            return self.lib.solver_newton_f32
        if dtype == torch.float64:
            return self.lib.solver_newton_f64
        raise TypeError(f"CUDA solver kernel: dtype {dtype} is not supported (float32/float64)")

    def _tag(self, dtype: torch.dtype) -> str:
        self.fn(dtype)
        return "f32" if dtype == torch.float32 else "f64"

    def team_bytes(self, dtype: torch.dtype) -> int:
        """Shared memory of one sample's team."""
        return getattr(self.lib, f"solver_team_bytes_{self._tag(dtype)}")()

    def launch_shape(self, dtype: torch.dtype) -> tuple:
        """(samples a block, teams an SM) the launch uses (needs the card)."""
        shape = self._shapes.get(dtype)
        if shape is None:
            shape = self._shapes[dtype] = self._query_shape(dtype)
        return shape

    def _query_shape(self, dtype: torch.dtype) -> tuple:
        tag = self._tag(dtype)
        spb = getattr(self.lib, f"solver_samples_per_block_{tag}")()
        if spb < 0:
            raise RuntimeError(f"CUDA solver kernel: occupancy query failed with cudaError {-spb}")
        if spb == 0:
            raise RuntimeError(
                f"CUDA solver kernel: one sample's working set, {self.team_bytes(dtype)} bytes of "
                f"shared memory in {dtype}, exceeds what a block of this card may have"
            )
        return spb, getattr(self.lib, f"solver_teams_per_sm_{tag}")()


_LIBS: dict = {}  # solver key -> SolverLibrary
# Model -> {nefc: key}: reading impratio off the device once per model
_KEYS_OF_MODEL = weakref.WeakKeyDictionary()


def load_library(key: tuple) -> SolverLibrary:
    """Build (at first use) and load the kernel library for this key."""
    lib = _LIBS.get(key)
    if lib is None:
        built = cuda_build.build_library(
            "solver_newton", "solver_newton.cu", _INCLUDES,
            {"solver_constants.h": render_constants_header(key)},
        )
        lib = SolverLibrary(built)
        if (lib.nv, lib.nefc) != key[:2]:
            raise RuntimeError(
                f"CUDA solver kernel: library sizes {(lib.nv, lib.nefc)} do not match the key's {key[:2]}"
            )
        _LIBS[key] = lib
    return lib


def _check_inputs(m: Model, J, D, aref, fl, eta, M, qs):
    if J.dim() != 3 or J.shape[2] != m.nv:
        raise ValueError(f"J must have shape (B, nefc, {m.nv}), got {tuple(J.shape)}")
    B, nefc, nv = J.shape
    if B < 1 or nefc < 1:
        raise ValueError(f"empty batch or no constraint rows: J has shape {tuple(J.shape)}")
    shapes = (("D", D, (B, nefc)), ("aref", aref, (B, nefc)), ("fl", fl, (B, nefc)),
              ("eta", eta, (B, nefc)), ("M", M, (B, nv, nv)), ("qs", qs, (B, nv)))
    for name, t, shape in shapes:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.device != J.device or t.dtype != J.dtype:
            raise ValueError("J, D, aref, fl, eta, M and qs must share device and dtype")
    for row0, dim in elliptic_groups(m):
        if row0 + dim > nefc:
            raise ValueError(f"elliptic group {(row0, dim)} lies outside the {nefc} rows given")


def solve_batched(m: Model, J, D, aref, fl, eta, M, qs):
    """Batched Newton solve (axis 0 = samples) -> (x, qfrc), both (B, nv).

    CUDA tensors go to the kernel; CPU tensors go to the plain version.
    """
    _check_inputs(m, J, D, aref, fl, eta, M, qs)
    if J.device.type == "cpu":
        return solve_batched_reference(m, J, D, aref, fl, eta, M, qs)
    if J.device.type != "cuda":
        raise ValueError(f"CUDA solver kernel: unsupported device {J.device}")
    if not all(t.is_contiguous() for t in (J, D, aref, fl, eta, M, qs)):
        raise ValueError("CUDA solver kernel: J, D, aref, fl, eta, M and qs must be contiguous")
    B, nefc, nv = J.shape
    keys = _KEYS_OF_MODEL.setdefault(m, {})
    if nefc not in keys:
        keys[nefc] = solver_key(m, nefc)
    lib = load_library(keys[nefc])
    fn = lib.fn(J.dtype)
    lib.launch_shape(J.dtype)  # raises if a sample's working set does not fit a block
    x = torch.empty((B, nv), dtype=J.dtype, device=J.device)
    qfrc = torch.empty((B, nv), dtype=J.dtype, device=J.device)
    with torch.cuda.device(J.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in (J, M, D, aref, fl, eta, qs, x, qfrc)), B, stream)
    if err != 0:
        raise RuntimeError(f"CUDA solver kernel: launch failed with cudaError {err}")
    solve_batched.launches += 1
    return x, qfrc


solve_batched.launches = 0


def solve_batched_reference(m: Model, J, D, aref, fl, eta, M, qs):
    """The plain PyTorch version of :func:`solve_batched` (any device)."""
    return solver._solve_arrays(m, J, D, aref, fl, eta, M, qs)
