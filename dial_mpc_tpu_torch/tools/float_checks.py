"""What the kernels are held to against their plain versions, in one place.

``chip_smoke.py`` compares each kernel with its plain PyTorch version on the
card with these tolerances, and the CPU tests (``tests/test_torch_physics.py``)
ask of the same seeded batches which samples float32 arithmetic moves beyond
them, in the port's plain version and in the reference's step.
"""

from __future__ import annotations

import numpy as np
import torch

from dial_mpc_tpu_torch.physics import make_data, solver, step
from dial_mpc_tpu_torch.tools.scene_cases import start_qpos, start_qvel

# float64: the tolerances the JAX package holds its own kernel to.
TOL_F64 = {"qpos": 1e-9, "site_xpos": 1e-9, "x_pos": 1e-9, "cdist": 1e-9, "cpos": 1e-9}
TOL_F64_DEFAULT = 1e-7
# float32 kernel against the float64 plain version on the same inputs. One
# rounding is 6e-8 relative. The batch is violent on purpose (random torques,
# feet in the ground, joints at their limits): the legged keys' qacc spans
# 2e3..3e3 and the Newton solve amplifies rounding by the Hessian's
# conditioning, so qacc is held to 0.5 absolute, qvel to the timestep (0.02)
# times that, qpos to the timestep times qvel's; pre-step products to a few
# ulps.
TOL_F32 = {"qacc": 0.5, "qvel": 1e-2, "qpos": 2e-4, "xd_vel": 1e-4, "xd_ang": 1e-4}
TOL_F32_DEFAULT = 1e-5
# The solve's accelerations (the step's qacc, the solver kernel's x) are held
# to the larger of the limit above and this fraction of the batch's range of
# the float64 output; the step's qvel and qpos follow qacc's limit through the
# timestep. One rule for every key: at the legged keys (qacc
# range at most 3.1e3 in chip_smoke.py's batches) the floors above hold. The
# Allegro's light fingers under stiff servos span 3.8e5 (2.2e5 at its joint
# limits), and there the order of the sums alone moves float32 qacc: the
# float32 plain version departs from float64 by 0.66 at sample 500 of the
# settled batch run batched, by 8.9 run alone (2.4e-5 of the range; the
# reference's float32 step 0.42, the kernel on the card 7.65), and by at
# most 3.4 elsewhere (tools/float32_spread.py, the CPU). Twice that reading,
# 5e-5 of the range, gives 19 (11 at the joint limits). In float64 the plain
# version's own qacc moves by 4.7e-7 there under a 1e-15 relative change of
# the velocities (sample 1575), above the 1e-7 floor: 2.5e-11 of the range
# gives 9.5e-6.
SOLVE_REL = {torch.float64: 2.5e-11, torch.float32: 5e-5}
# The solver kernel: x is qacc, so the step's qacc rule holds; qfrc = J' f is
# held to the same floor (the legged keys' forces span up to 2e4, where the
# fraction would loosen it; the Allegro's qfrc stays within 0.003 of float64).
TOL_SOLVER = {torch.float64: TOL_F64_DEFAULT, torch.float32: TOL_F32["qacc"]}
# The synthetic solver problem is O(1)..O(10) and well conditioned
# (M = A A' + 6 I): errors relative to max(1, |reference|max).
TOL_SYNTHETIC = {torch.float64: 1e-9, torch.float32: 1e-3}


def _span(ref):
    ref = ref.double()
    return float(ref.max() - ref.min()) if ref.numel() else 0.0


def step_limits(dtype, qacc64, timestep):
    """(limit by output, default) of the step kernel on a batch whose
    float64 plain version gives the accelerations ``qacc64`` (B, nv)."""
    if dtype == torch.float64:
        return {**TOL_F64, "qacc": max(TOL_F64_DEFAULT, SOLVE_REL[dtype] * _span(qacc64))}, TOL_F64_DEFAULT
    acc = max(TOL_F32["qacc"], SOLVE_REL[dtype] * _span(qacc64))
    vel = max(TOL_F32["qvel"], timestep * acc)
    pos = max(TOL_F32["qpos"], timestep * vel)
    return {**TOL_F32, "qacc": acc, "qvel": vel, "qpos": pos}, TOL_F32_DEFAULT


def solve_limits(dtype, x64):
    """Limits of the solver kernel's x and qfrc on a batch whose float64
    plain solve gives the accelerations x64."""
    return {"x": max(TOL_SOLVER[dtype], SOLVE_REL[dtype] * _span(x64)), "qfrc": TOL_SOLVER[dtype]}


# Float32 rounding can flip a branch of the step where a state sits on its
# edge (a contact or a joint limit at its activation distance, two candidate
# corners at the same depth): the float32 plain version then departs from the
# float64 one as far as the kernel does. Such a sample is held to the float32
# plain version on the same inputs instead, with the same limits.
#
# Where the solve is ill conditioned, float32 rounding alone moves a sample
# far, by an amount that depends on the order of the sums. The samples of
# chip_smoke.py's seeded batches (settled, and three steps on at the joint
# limits) where the reference's own float32 step was measured departing from
# its float64 step are listed here with that departure (rounded down), by
# output; tests/test_torch_physics.py::test_float32_flips_are_the_references_own
# runs the reference at each and checks it. The float32 versions measured at
# these two samples (the reference's, the port's plain version on the CPU and
# on the card, the step kernel) depart by 0.04 to 5.3 times the reference's
# qacc departure (the float64 plain version moves by 171 and 70 there under
# one float32 rounding of its inputs, tools/float32_spread.py): at a listed
# sample the kernel (the step kernel; the solver kernel's x as qacc, and its
# qfrc as the step's qfrc_constraint) is held to float64 within
# REFERENCE_FACTOR times the reference's departure.
REFERENCE_DEPARTS = {
    ("allegro", "settled"): {1575: {"qacc": 150.0, "qvel": 0.55, "qpos": 1.5e-3, "qfrc": 0.59}},
    ("allegro", "at_limits"): {1238: {"qacc": 25.0, "qvel": 0.15, "qpos": 7.7e-4, "qfrc": 0.024}},
}
REFERENCE_FACTOR = 8.0
# At most this many samples of a batch may be held to the float32 plain
# version or to a listed departure.
MAX_FLIPPED = 4


def listed_limits(departure, limits):
    """The limits at a sample of REFERENCE_DEPARTS whose reference departed
    by ``departure`` (by output): an output's limit, or REFERENCE_FACTOR
    times that departure where that is larger."""
    return {**limits, **{n: max(limits.get(n, 0.0), REFERENCE_FACTOR * d) for n, d in departure.items()}}


def random_ctrl(name, mj, rng, start):
    """Random ctrl for the batch that starts at qpos ``start`` (batch, nq).
    Torques are uniform in +/- 8 where the motor is unlimited (the Go2's), in
    a quarter of the range where it is limited (the H1's, up to 300 N m). The
    Allegro's position servos get each sample's starting joint angles +/- 0.1
    rad as targets: its fingers hold the pose they start in, where targets far
    from it (the curled fingers' against the keyframe's) drive the light
    thumb unstably under the explicit servo at 0.005 s."""
    batch = start.shape[0]
    if name == "allegro":
        return start[:, 7:] + rng.uniform(-0.1, 0.1, (batch, mj.nu))
    hi = np.where(np.asarray(mj.actuator_ctrllimited) > 0,
                  0.25 * np.abs(np.asarray(mj.actuator_ctrlrange)).max(1), 8.0)
    return rng.uniform(-hi, hi, (batch, mj.nu))


def contact_rich_batch(name, mj, model, batch, seed=0, settle=5):
    """States settled into contact by the plain step under random ctrl, from
    the scene's start poses (tools/scene_cases.py), and a random ctrl: three
    tensors on the model's device and in its dtype."""
    rng = np.random.default_rng(seed)
    dtype, device = model.dtype, model.device
    qpos = start_qpos(name, mj, batch, rng)

    def t(a):
        return torch.tensor(a, dtype=dtype, device=device)

    d = make_data(model, batch).replace(qpos=t(qpos), qvel=t(start_qvel(name, mj, batch, rng)))
    for _ in range(settle):
        d = step(model, d.replace(ctrl=t(random_ctrl(name, mj, rng, qpos))), solver.solve_reference)
    if not bool(torch.isfinite(d.qpos).all()):
        raise AssertionError("settle rollout diverged")
    return d.qpos.contiguous(), d.qvel.contiguous(), t(random_ctrl(name, mj, rng, qpos))


def departing(names, outs, refs, tol, tol_default):
    """(B,) whether any output of a sample departs from refs beyond its
    tolerance (NaN departs). ``names`` name the outputs, in order."""
    bad = None
    for name, a, b in zip(names, outs, refs):
        err = (a.double() - b.double()).abs().reshape(a.shape[0], -1).max(-1).values
        over = ~(err <= tol.get(name, tol_default))
        bad = over if bad is None else bad | over
    return bad
