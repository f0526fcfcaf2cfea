#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py [--steps N] [--unfused-steps N] [--jump-steps N]
        [--jog-steps N] [--loco-steps N] [--crate-steps N] [--push-steps N]
        [--allegro-steps N] [--compare-only] [--parent DIR]

Phases, each printing one JSON line; any failure exits non-zero:
  1. environment (torch, CUDA, nvcc, card name and power limit);
  2. build of every kernel's library from dial_mpc_tpu_torch/csrc, all nvcc
     runs started together: the step kernel and the solver kernel for each
     scene of the tasks (Go2 flat, H1 walk, H1 loco, Go2 crate, H1 push
     crate, Allegro), and the solver kernel for a synthetic key with elliptic
     groups; with --parent DIR (another checkout of the repo, such as the
     parent commit's) also kernel E of every scene and kernel S of the Go2
     flat scene against that checkout's, on the same states, in turns
     (theirs, this, this, theirs: tools/time_step_kernel.py and
     tools/time_solver_kernel.py in processes of their own): the outputs
     must be the same bits; each run's times at B = 2049 and B = 1, shared
     memory a team, teams an SM, waves and ptxas numbers are printed;
  3. each kernel against its plain PyTorch version on the card, for each
     scene on a contact-rich batch (on the crate scenes posed against the
     crate, and the states with a box contact counted; on the Allegro scene
     the active condim-6 slots and the elliptic rows in each cone zone
     counted):
     - the step kernel: B = 2049 and B = 1, float64 and float32, and also
       at each other batch a path of phases 4 and 5 gives it on this scene
       (Nsample + 1 of the YAMLs: 3001 on H1 loco, 129 on the Allegro's
       gate; path_batches), n_steps = 4
       against four sequential launches, and two launches on the same inputs
       (bit for bit); the states at a joint limit counted; its occupancy
       (samples a block, teams per SM, and the waves of teams of a launch at
       B = 2049, step_core.waves), shared memory and ptxas numbers by type,
       and its time beside its bound;
     - the solver kernel: the constraint rows of the same batch (at-limit
       states included and counted), B = 2049 and B = 1, float64 and float32;
       on the Go2 flat scene also the synthetic problem of
       tools/solver_cases.py, which puts rows in every branch (friction loss
       on both sides of its clamp, elliptic groups of dimension 3 and 6 in
       every zone, counted), two launches on the same inputs (bit for bit),
       its occupancy and ptxas numbers;
     - the fused route (step kernel) against the unfused one (plain stages
       with the solver kernel) on the same states, float64;
     - the whole planner on a small input, card against CPU (Go2 trot);
  4. the paths, each through dial_mpc_tpu_torch.core.runner.run at the
     shipped width, float32, with the number of control steps cut and the
     launch counts checked: Go2 trot on the fused route (--steps), Go2 trot
     on the unfused route (--unfused-steps), Go2 seq-jump (--jump-steps), H1
     jog (--jog-steps), H1 loco (--loco-steps), Go2 crate climb
     (--crate-steps), H1 push crate (--push-steps) and Allegro in-hand
     reorientation (--allegro-steps) on the fused route;
  5. the asynchronous deploy path (dial_mpc_tpu_torch.deploy.planner_proc.
     MBDPublisher), float32 at the width of each deploy YAML, launch counts
     checked: (a) DEPLOY_TICKS ticks of each deploy example on a bus this
     script creates and holds at the home keyframe, with the tick's host time,
     the CUDA-event span of its device work and the profiler's device busy
     time; (b) a closed loop in sync mode, Go2 trot deploy for
     DEPLOY_LOOP_TICKS ticks against tools/plain_sim.py (the plain physics
     on the CPU, float64, in a subprocess) in the sim server's place. Each
     bus has segment names of its own run (shm.run_prefix), so that no other
     run's bus on the host is met or taken over;
  6. the sample-sharded planner (dial_mpc_tpu_torch.parallel.ShardedMBDPI) at
     the trot YAML's width, float32: (a) a group of one on NCCL, built as
     the JAX package's bench.py metric 2 builds it, for SHARDED_STEPS control
     steps (E's launches checked, the trajectory held to phase 4's trot run,
     the collectives a level counted and their device time traced); (b) two
     ranks sharing the card over gloo, two processes of this script (1024
     samples a rank, E at B = 1025), each driving runner.run and the deploy
     planner (MBDPublisher) with sharding "mesh": both build ShardedMBDPI,
     rank 0 alone writes the artifacts and attaches a bus of this run, the
     ranks agree bit for bit and follow (a)'s trajectory and predicted body
     positions; (c) runner.run with sharding "mesh" in the group of one (it
     builds MBDPI, and where mujoco is not installed writes the states and
     no viewer); (d) tools/glue_profile.py's three times;
  7. the kernels' times beside their bounds.
The last line is {"ok": true, "device": {...}}. With --compare-only the
script stops after phase 3 and prints no such line.
"""

import argparse
import concurrent.futures
import importlib.util
import json
import os
import pickle
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import yaml

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")

import dial_mpc_tpu_torch.envs as dial_envs
from dial_mpc_tpu_torch.core import runner
from dial_mpc_tpu_torch.core.dial_core import MBDPI
from dial_mpc_tpu_torch.deploy.planner_proc import MBDPublisher
from dial_mpc_tpu_torch.deploy.shm import run_prefix
from dial_mpc_tpu_torch.parallel import ShardedMBDPI, global_sample_mesh, init_distributed
from dial_mpc_tpu_torch.physics import (
    cuda_build, engine_cuda, forward, make_data, maths, put_model, solver, solver_cuda,
)
from dial_mpc_tpu_torch.physics.constraint import elliptic_groups
from dial_mpc_tpu_torch.physics.compiled_model import load_scene
from dial_mpc_tpu_torch.tools import deploy_bench, glue_profile, solver_cases
from dial_mpc_tpu_torch.tools.float_checks import (
    MAX_FLIPPED, REFERENCE_DEPARTS, TOL_SYNTHETIC, contact_rich_batch, departing, listed_limits, solve_limits,
    step_limits,
)
from dial_mpc_tpu_torch.tools.scene_cases import SCENES, TIMESTEP, box_slots
from dial_mpc_tpu_torch.utils.io_utils import get_example_path

DEVICE = "cuda"
QACC = engine_cuda.OUTPUT_NAMES.index("qacc")
B_FULL = 2049  # Nsample + 1 rollouts of the shipped configs
# the examples phase 4 runs at their YAML's width (phase 5 runs DEPLOY_WIDTHS'),
# the Allegro gate's width, and the scene (a key of SCENES) of each env
PATH_EXAMPLES = ("unitree_go2_trot", "unitree_go2_seq_jump", "unitree_h1_jog", "unitree_h1_loco",
                 "unitree_go2_crate_climb", "unitree_h1_push_crate", "allegro_reorient")
ALLEGRO_GATE_NSAMPLE = 128
ENV_SCENES = {"unitree_go2_walk": "go2", "unitree_go2_seq_jump": "go2", "unitree_h1_walk": "h1_walk",
              "unitree_h1_loco": "h1_loco", "unitree_go2_crate_climb": "go2_crate",
              "unitree_h1_push_crate": "h1_push_crate", "allegro_reorient": "allegro"}

H100_FP32_FLOPS = 67e12  # dense float32 outside the tensor cores, published peak
H100_HBM_BYTES_PER_S = 3.35e12

# Every tolerance the kernels are held to, and the float32 flip rule, are in
# dial_mpc_tpu_torch/tools/float_checks.py, which the CPU tests read too.


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def require(cond, message):
    if not cond:
        raise AssertionError(message)


def sh(cmd):
    return subprocess.run(cmd, shell=True, capture_output=True, text=True).stdout.strip()


def beyond_limits(model, qpos):
    """(B,) whether a limited joint of each state lies beyond its range."""
    lim = [j for j in range(model.njnt) if model.jnt_limited[j]]
    q = qpos[:, [model.jnt_qposadr[j] for j in lim]]
    jr = model.jnt_range[lim]
    return ((q < jr[:, 0]) | (q > jr[:, 1])).any(-1)


def worst_over_limit(names, limits, default, outs, refs, i):
    """(output, error, limit) of sample i's output farthest over its limit."""
    errs = [(float((a[i].double() - b[i].double()).abs().max()), limits.get(name, default), name)
            for name, a, b in zip(names, outs, refs)]
    err, limit, name = max(errs, key=lambda e: e[0] / e[1])
    return {"output": name, "err": err, "limit": limit}


def dump_failure(what, name, a, b, limit, inputs):
    """The samples of output ``name`` beyond ``limit``: their indices and
    errors for the message, and their inputs saved under chiprun_out/ so that
    they can be replayed where there is no card."""
    err = (a.double() - b.double()).abs().reshape(a.shape[0], -1).max(-1).values
    bad = (~(err <= limit)).nonzero().flatten()
    worst = bad[err[bad].argsort(descending=True)][:16].tolist()
    if inputs is not None:
        os.makedirs("chiprun_out", exist_ok=True)
        path = os.path.join("chiprun_out", what.replace(":", "").replace(" ", "_").replace("=", "") + ".npz")
        np.savez(path, samples=np.array(worst), **{k: v[worst].double().cpu().numpy()
                                                    for k, v in zip(("qpos", "qvel", "ctrl"), inputs)})
    return f"{len(bad)} samples, worst {[(i, float(err[i])) for i in worst[:6]]}"


def hold_departures(names, outs, refs, limits, default, what, plain32, flips, listed):
    """The float32 departures of one batch: a sample where the float32 plain
    version (plain32) departs from refs beyond the limits is held to it
    instead (a flipped branch); a sample of ``listed`` (float_checks.
    REFERENCE_DEPARTS of this key and batch: sample -> the reference's own
    float32 departure by output) is held to refs within float_checks.
    listed_limits, checked here. At most MAX_FLIPPED samples may be either;
    flips[what] lists each with the kernel's and the float32 plain version's
    worst error against float64. Returns the references the other samples are
    held to and the mask of the samples held so."""
    B = refs[0].shape[0]
    listed = {i: dep for i, dep in listed.items() if i < B}
    is_listed = torch.zeros(B, dtype=torch.bool, device=refs[0].device)
    is_listed[list(listed)] = True
    flipped = departing(names, plain32, refs, limits, default) & ~is_listed
    moved = departing(names, outs, refs, limits, default) & is_listed
    held = [torch.where(flipped[:, None], p.double(), b.double()) for p, b in zip(plain32, refs)]
    flips[what] = [
        {"sample": i, "kernel_vs_f64": worst_over_limit(names, limits, default, outs, refs, i),
         "plain32_vs_f64": worst_over_limit(names, limits, default, plain32, refs, i),
         "held_to": "reference's float32 departure" if bool(is_listed[i]) else "float32 plain version"}
        for i in (flipped | moved).nonzero().flatten().tolist()
    ]
    if len(flips[what]) > MAX_FLIPPED:
        raise AssertionError(f"{what}: float32 departs in {len(flips[what])} samples: {flips[what]}")
    for i, dep in listed.items():
        lim_i = listed_limits(dep, limits)
        for name, a, b in zip(names, outs, refs):
            err = float((a[i].double() - b[i].double()).abs().max())
            limit = lim_i.get(name, default)
            if not (err <= limit):
                raise AssertionError(f"{what}: sample {i} (listed) {name} differs by {err:.3e} > {limit:.2e}")
    return held, is_listed


def compare(model, outs, refs, limits, default, what, plain32=None, flips=None, inputs=None, listed=None):
    """Worst error of each output against refs; raises beyond its limit.
    With plain32, the float32 departures are held as hold_departures says."""
    names = engine_cuda.OUTPUT_NAMES
    if plain32 is not None:
        refs, is_listed = hold_departures(names, outs, refs, limits, default, what, plain32, flips, listed or {})
        outs, refs = [a[~is_listed] for a in outs], [b[~is_listed] for b in refs]
        if inputs is not None:
            inputs = [x[~is_listed] for x in inputs]
    worst = {}
    for name, a, b in zip(names, outs, refs):
        limit = limits.get(name, default)
        err = float((a.double() - b.double()).abs().max())
        worst[name] = err
        if not (err <= limit):  # also catches NaN
            raise AssertionError(
                f"{what}: {name} differs by {err:.3e} > {limit:.2e}; {dump_failure(what, name, a, b, limit, inputs)}"
            )
    return worst


def cuda_ms(fn, n):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def path_batches():
    """scene -> the batches other than B_FULL that the paths of phases 4-6
    give the step kernel there (Nsample + 1 of each YAML, of the Allegro
    gate's width, and of a rank's share on phase 6's gloo group)."""
    runs = [(e, None) for e in PATH_EXAMPLES + tuple(DEPLOY_WIDTHS)]
    runs.append(("allegro_reorient", ALLEGRO_GATE_NSAMPLE))
    # a rank's share of the samples on phase 6's gloo group
    runs.append((SHARDED_EXAMPLE, WIDTHS[SHARDED_EXAMPLE]["Nsample"] // SHARDED_GLOO_RANKS))
    batches = {}
    for example, nsample in runs:
        with open(get_example_path(example + ".yaml")) as f:
            cfg = yaml.safe_load(f)
        b = (nsample or cfg["Nsample"]) + 1
        if b != B_FULL:
            batches.setdefault(ENV_SCENES[cfg["env_name"]], set()).add(b)
    return {scene: sorted(bs) for scene, bs in batches.items()}


def phase_compare(name, mj, path_b=()):
    """Phase 3, kernel E on one scene; returns what phase 5 needs. ``path_b``:
    the other batches the paths give the kernel on this scene."""
    m64 = put_model(mj, device=DEVICE, dtype=torch.float64)
    m32 = put_model(mj, device=DEVICE, dtype=torch.float32)
    qpos, qvel, ctrl = contact_rich_batch(name, mj, m64, B_FULL)
    errs, flips, limits = {}, {}, {}
    h = float(mj.opt.timestep)

    ref1 = engine_cuda.step_core_reference(m64, qpos, qvel, ctrl, 1)
    out1 = engine_cuda.step_core(m64, qpos, qvel, ctrl, 1)
    torch.cuda.synchronize()
    lim64, d64 = limits["f64"] = step_limits(torch.float64, ref1[QACC], h)
    errs["f64_B2049"] = compare(m64, out1, ref1, lim64, d64, f"{name}: f64 B=2049", inputs=(qpos, qvel, ctrl))
    counts = {"samples_in_contact": int((out1[8][:, : m64.ncon] < 0).any(-1).sum())}
    require(counts["samples_in_contact"] > 0, f"{name}: no sample of the batch is in contact")
    if box_slots(m64.pair_table):
        counts["samples_touching_a_box"] = int((out1[8][:, box_slots(m64.pair_table)] < 0).any(-1).sum())
        require(counts["samples_touching_a_box"] > 0, f"{name}: no sample of the batch touches a box")

    one = engine_cuda.step_core(m64, qpos[:1], qvel[:1], ctrl[:1], 1)
    torch.cuda.synchronize()
    errs["f64_B1"] = compare(
        m64, one, [r[:1] for r in ref1], lim64, d64, f"{name}: f64 B=1"
    )

    # four steps under constant ctrl drive joints into their limits: the
    # fused launch against the plain version, and against four launches
    ref4 = engine_cuda.step_core_reference(m64, qpos, qvel, ctrl, 4)
    out4 = engine_cuda.step_core(m64, qpos, qvel, ctrl, 4)
    seq = out1
    for _ in range(3):
        seq = engine_cuda.step_core(m64, seq[0].contiguous(), seq[1].contiguous(), ctrl, 1)
    torch.cuda.synchronize()
    lim64_4, _ = limits["f64_n4"] = step_limits(torch.float64, ref4[QACC], h)
    errs["f64_B2049_n4"] = compare(m64, out4, ref4, lim64_4, d64, f"{name}: f64 n_steps=4",
                                   inputs=(qpos, qvel, ctrl))
    n_limit = int(beyond_limits(m64, engine_cuda.step_core(m64, qpos, qvel, ctrl, 3)[0]).sum())
    if n_limit == 0:
        raise AssertionError(f"{name}: no sample of the batch reached a joint limit")
    for out_name, a, b in zip(engine_cuda.OUTPUT_NAMES, out4, seq):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: n_steps=4 differs from four launches in {out_name}")

    q32, v32, c32 = qpos.float(), qvel.float(), ctrl.float()
    out32 = engine_cuda.step_core(m32, q32, v32, c32, 1)
    ref32 = engine_cuda.step_core_reference(m64, q32.double(), v32.double(), c32.double(), 1)
    plain32 = engine_cuda.step_core_reference(m32, q32, v32, c32, 1)
    torch.cuda.synchronize()
    lim32, d32 = limits["f32"] = step_limits(torch.float32, ref32[QACC], h)
    errs["f32_B2049"] = compare(m32, out32, ref32, lim32, d32, f"{name}: f32 B=2049", plain32, flips,
                                inputs=(q32, v32, c32), listed=REFERENCE_DEPARTS.get((name, "settled")))
    one32 = engine_cuda.step_core(m32, q32[:1], v32[:1], c32[:1], 1)
    torch.cuda.synchronize()
    errs["f32_B1"] = compare(
        m32, one32, [r[:1] for r in ref32], lim32, d32, f"{name}: f32 B=1", [p[:1] for p in plain32], flips,
    )
    # a path's other batch: another grid, another tail in the last block
    for b in path_b:
        qb, vb, cb = contact_rich_batch(name, mj, m64, b)
        refb = engine_cuda.step_core_reference(m64, qb, vb, cb, 1)
        outb = engine_cuda.step_core(m64, qb, vb, cb, 1)
        torch.cuda.synchronize()
        limb, db = limits[f"f64_B{b}"] = step_limits(torch.float64, refb[QACC], h)
        errs[f"f64_B{b}"] = compare(m64, outb, refb, limb, db, f"{name}: f64 B={b}", inputs=(qb, vb, cb))
        qb, vb, cb = qb.float(), vb.float(), cb.float()
        outb = engine_cuda.step_core(m32, qb, vb, cb, 1)
        refb = engine_cuda.step_core_reference(m64, qb.double(), vb.double(), cb.double(), 1)
        plainb = engine_cuda.step_core_reference(m32, qb, vb, cb, 1)
        torch.cuda.synchronize()
        limb, db = limits[f"f32_B{b}"] = step_limits(torch.float32, refb[QACC], h)
        errs[f"f32_B{b}"] = compare(m32, outb, refb, limb, db, f"{name}: f32 B={b}", plainb, flips,
                                    inputs=(qb, vb, cb))
        del qb, vb, cb, refb, outb, plainb
    # the float32 kernel on the states that sit at joint limits (after three steps)
    at_limit = engine_cuda.step_core(m64, qpos, qvel, ctrl, 3)
    ql, vl = at_limit[0].contiguous(), at_limit[1].contiguous()
    out32_l = engine_cuda.step_core(m32, ql.float(), vl.float(), c32, 1)
    ref32_l = engine_cuda.step_core_reference(
        m64, ql.float().double(), vl.float().double(), c32.double(), 1
    )
    plain32_l = engine_cuda.step_core_reference(m32, ql.float(), vl.float(), c32, 1)
    torch.cuda.synchronize()
    lim32_l, _ = limits["f32_at_limits"] = step_limits(torch.float32, ref32_l[QACC], h)
    errs["f32_B2049_at_limits"] = compare(
        m32, out32_l, ref32_l, lim32_l, d32, f"{name}: f32 at joint limits", plain32_l, flips,
        listed=REFERENCE_DEPARTS.get((name, "at_limits")),
    )
    out32_4 = engine_cuda.step_core(m32, q32, v32, c32, 4)
    seq32 = out32
    for _ in range(3):
        seq32 = engine_cuda.step_core(m32, seq32[0].contiguous(), seq32[1].contiguous(), c32, 1)
    torch.cuda.synchronize()
    for out_name, a, b in zip(engine_cuda.OUTPUT_NAMES, out32_4, seq32):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: float32 n_steps=4 differs from four launches in {out_name}")

    # two launches on the same inputs, the same bits: the team's sums have a
    # fixed order and no lane reads what another writes in the same phase
    for kind, model, args in (("float64", m64, (qpos, qvel, ctrl)), ("float32", m32, (q32, v32, c32))):
        a = engine_cuda.step_core(model, *args, 1)
        b = engine_cuda.step_core(model, *args, 1)
        torch.cuda.synchronize()
        for out_name, x, y in zip(engine_cuda.OUTPUT_NAMES, a, b):
            if not torch.equal(x, y):
                raise AssertionError(f"{name}, {kind}: two launches on the same inputs differ in {out_name}")

    emit(
        "compare", ok=True, scene=name, samples_at_joint_limit=n_limit, **counts,
        samples_float32_departs=flips, max_flipped=MAX_FLIPPED,
        repeat_launch_bit_equal=True,
        tolerance={k: {**lim, "rest": rest} for k, (lim, rest) in limits.items()},
        max_abs_err={k: max(v.values()) for k, v in errs.items()}, per_output=errs,
        n_steps4_equals_four_launches=True,
    )

    # ---- timings at the main path's shape: B = 2049, float32 ----
    for _ in range(5):
        engine_cuda.step_core(m32, q32, v32, c32, 1)
    torch.cuda.synchronize()
    wrapper_ms = cuda_ms(lambda: engine_cuda.step_core(m32, q32, v32, c32, 1), 100)
    waves = engine_cuda.step_core.waves  # of a launch at B = 2049 in float32
    lib = engine_cuda.load_library(m32)
    stream = torch.cuda.current_stream().cuda_stream

    def raw_launch(q, v, c_, n=1):
        """The bare kernel on packed sample-major arrays, timed by the caller."""
        packed_in = torch.cat([q, v, c_], dim=1)
        packed_out = torch.empty((q.shape[0], lib.out_rows), dtype=q.dtype, device=DEVICE)
        fn = lib.fn(q.dtype)

        def go():
            err = fn(packed_in.data_ptr(), packed_out.data_ptr(), q.shape[0], n, stream)
            require(err == 0, f"launch failed with cudaError {err}")

        return go

    raw = raw_launch(q32, v32, c32)
    kernel_ms = cuda_ms(raw, 100)
    kernel_b1_ms = cuda_ms(raw_launch(q32[:1], v32[:1], c32[:1]), 100)
    kernel64_ms = cuda_ms(raw_launch(qpos, qvel, ctrl), 50)
    engine_cuda.step_core_reference(m32, q32, v32, c32, 1)
    torch.cuda.synchronize()
    plain_ms = cuda_ms(lambda: engine_cuda.step_core_reference(m32, q32, v32, c32, 1), 3)
    b1_ms = cuda_ms(lambda: engine_cuda.step_core(m32, q32[:1], v32[:1], c32[:1], 1), 100)
    wrapper64_ms = cuda_ms(lambda: engine_cuda.step_core(m64, qpos, qvel, ctrl, 1), 50)

    nbytes = (lib.in_rows + lib.out_rows) * B_FULL * 4
    flops = engine_cuda.step_flops(m32) * B_FULL
    bytes_ms = nbytes / H100_HBM_BYTES_PER_S * 1e3
    ops_ms = flops / H100_FP32_FLOPS * 1e3
    timing = dict(
        max_abs_err=errs["f32_B2049"], wrapper_ms=wrapper_ms, kernel_ms=kernel_ms,
        plain_ms=plain_ms, b1_ms=b1_ms, wrapper64_ms=wrapper64_ms, bytes=nbytes, flops=flops,
        kernel_b1_ms=kernel_b1_ms, kernel64_ms=kernel64_ms, lanes=lib.lanes, waves=waves,
        teams_per_sm={"float32": lib.teams_per_sm(torch.float32), "float64": lib.teams_per_sm(torch.float64)},
        samples_per_block={"float32": lib.launch_shape(torch.float32)[0],
                           "float64": lib.launch_shape(torch.float64)[0]},
        team_shared_bytes={"float32": lib.team_bytes(torch.float32), "float64": lib.team_bytes(torch.float64)},
        ptxas=kernel_ptxas(lib, "engine_step_kernel"),
        bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
    )
    states = dict(settled=(qpos, qvel, ctrl), at_limits=(ql, vl, ctrl), n_limit=n_limit)
    return timing, m64, m32, states


def kernel_ptxas(lib, kernel):
    """Registers, stack, spills and static shared memory of a kernel, by type,
    from its library's build log."""
    kinds = {"IfE": "float32", "IdE": "float64"}
    return {
        kind: numbers
        for name, numbers in cuda_build.ptxas_entries(lib.build_log).items()
        if kernel in name
        for tag, kind in kinds.items() if tag in name
    }


def solver_rows(model, qpos, qvel, ctrl):
    """The solver's inputs at these states, and the plain solve's outputs, all
    from the plain physics (no kernel anywhere in the chain)."""
    d = make_data(model, qpos.shape[0]).replace(qpos=qpos, qvel=qvel, ctrl=ctrl)
    d = forward(model, d, solver.solve_reference)
    e = d.efc
    args = tuple(a.contiguous() for a in (e.J, e.D, e.aref, e.frictionloss, e.eta, d.qM, d.qacc_smooth))
    return args, (d.qacc, d.qfrc_constraint)


ZONES = ("top", "middle", "bottom")


def elliptic_counts(model, args, refs):
    """The active condim-6 slots, and the rows of active elliptic groups in
    each zone of the cone (top: separating; bottom: pressed in with little
    slip, inside the cone; middle: on it, the rank-1 term), as the solvers'
    group terms decide them, at the solve's start (qacc_smooth) and at its
    result."""
    J, D, aref, _, eta, _, qs = args
    ir = float(model.opt.impratio)
    out = {"active_condim6_slots": 0}
    for at, x in (("start", qs), ("result", refs[0])):
        jar = torch.einsum("bij,bj->bi", J, x) - aref
        for z in ZONES:
            out[f"rows_{z}_at_{at}"] = 0
        for row0, dim in elliptic_groups(model):
            active = D[:, row0] > 0
            N, mu = jar[:, row0], eta[:, row0 + 1]
            u = eta[:, row0 + 1 : row0 + dim] * jar[:, row0 + 1 : row0 + dim]
            U = torch.sqrt((u * u).sum(-1) + 1e-30)
            top = N >= U
            bottom = ~top & (N <= -(ir / (mu * mu).clamp_min(1e-12)) * U)
            for z, mask in zip(ZONES, (top, ~top & ~bottom, bottom)):
                out[f"rows_{z}_at_{at}"] += dim * int((active & mask).sum())
            if dim == 6 and at == "start":
                out["active_condim6_slots"] += int(active.sum())
    return out


def solver_errors(outs, refs, limits, what, relative=False, plain32=None, flips=None, listed=None):
    """Worst error of x and qfrc against refs; raises beyond their limits.
    With plain32 (the float32 plain solve's outputs) the float32 departures
    are held as hold_departures says; at a listed sample x and qfrc are
    held within the reference's own float32 departure of qacc and
    qfrc_constraint."""
    names = ("x", "qfrc")
    if plain32 is not None:
        listed = {i: {"x": dep["qacc"], "qfrc": dep["qfrc"]} for i, dep in (listed or {}).items()}
        refs, is_listed = hold_departures(names, outs, refs, limits, 0.0, f"solver kernel, {what}", plain32,
                                          flips, listed)
        outs, refs = [a[~is_listed] for a in outs], [b[~is_listed] for b in refs]
    worst = {}
    for name, a, b in zip(names, outs, refs):
        err = float((a.double() - b.double()).abs().max())
        if relative:
            err /= max(1.0, float(b.abs().max()))
        worst[name] = err
        if not (err <= limits[name]):  # also catches NaN
            raise AssertionError(f"solver kernel, {what}: {name} differs by {err:.3e} > {limits[name]:.2e}")
    return worst


def phase_solver_compare(scene, m64, m32, states):
    """Phase 3, kernel S on one scene's rows (and, with the Go2 flat scene,
    the synthetic problem); returns what phase 5 needs."""
    errs, counts, flips, limits = {}, {}, {}, {}
    lay = engine_cuda.static_layout(m64)
    r0 = len(lay["fric_dof"])  # rows: friction loss, limits from r0, contacts from r1
    r1 = r0 + len(lay["limit_jnt"])

    # ---- the scene's rows: settled (contact-rich) and at-limit states ----
    for name, (qpos, qvel, ctrl) in (("settled", states["settled"]), ("at_limits", states["at_limits"])):
        args, refs = solver_rows(m64, qpos, qvel, ctrl)
        D = args[1]
        counts[name] = dict(
            samples_with_active_limit_row=int((D[:, r0:r1] > 0).any(-1).sum()),
            samples_with_active_contact_row=int((D[:, r1:] > 0).any(-1).sum()),
        )
        if r0:
            counts[name]["samples_with_friction_loss_row"] = int((D[:, :r0] > 0).any(-1).sum())
        if elliptic_groups(m64):
            counts[name].update(elliptic_counts(m64, args, refs))
        outs = solver_cuda.solve_batched(m64, *args)
        torch.cuda.synchronize()
        lim64 = limits[f"f64_{name}"] = solve_limits(torch.float64, refs[0])
        errs[f"f64_B2049_{name}"] = solver_errors(outs, refs, lim64, f"{scene} f64 {name}")
        one = solver_cuda.solve_batched(m64, *[a[:1] for a in args])
        torch.cuda.synchronize()
        errs[f"f64_B1_{name}"] = solver_errors(one, [r[:1] for r in refs], lim64, f"{scene} f64 B=1 {name}")
        args32 = tuple(a.float() for a in args)
        refs32 = solver_cuda.solve_batched_reference(m64, *[a.double() for a in args32])
        plain32 = solver_cuda.solve_batched_reference(m32, *args32)
        outs32 = solver_cuda.solve_batched(m32, *args32)
        torch.cuda.synchronize()
        lim32 = limits[f"f32_{name}"] = solve_limits(torch.float32, refs32[0])
        errs[f"f32_B2049_{name}"] = solver_errors(outs32, refs32, lim32, f"{scene} f32 {name}", plain32=plain32,
                                                  flips=flips, listed=REFERENCE_DEPARTS.get((scene, name)))
        one32 = solver_cuda.solve_batched(m32, *[a[:1] for a in args32])
        torch.cuda.synchronize()
        errs[f"f32_B1_{name}"] = solver_errors(one32, [r[:1] for r in refs32], lim32, f"{scene} f32 B=1 {name}")
        if name == "settled":
            timing_args, timing_args32 = args, args32
    require(counts["at_limits"]["samples_with_active_limit_row"] > 0, f"{scene}: no sample has an active joint-limit row")
    require(counts["settled"]["samples_with_active_contact_row"] > 0, f"{scene}: no sample is in contact")
    if elliptic_groups(m64):
        total = lambda key: sum(c[key] for c in counts.values())
        require(total("active_condim6_slots") > 0, f"{scene}: no condim-6 slot is active")
        for z in ZONES:
            require(total(f"rows_{z}_at_start") + total(f"rows_{z}_at_result") > 0,
                    f"{scene}: no elliptic row lies in the cone's {z} zone")
    if scene == "go2":
        zones = phase_synthetic_solver(errs)
    else:
        zones = None

    emit(
        "solver_compare", ok=True, scene=scene, rows=counts, synthetic_samples=zones,
        samples_float32_departs=flips, max_flipped=MAX_FLIPPED,
        tolerance={**limits, "synthetic_relative": {str(k): v for k, v in TOL_SYNTHETIC.items()}},
        max_abs_err={k: max(v.values()) for k, v in errs.items()}, per_output=errs,
    )
    return solver_timing(scene, m64, m32, timing_args, timing_args32, errs)


def phase_synthetic_solver(errs):
    """The synthetic problem: every row kind, every zone."""
    rows = solver_cases.synthetic_problem(seed=0, batch=B_FULL)
    zones = {}
    for gi, (row0, dim) in enumerate(solver_cases.SPEC["groups"]):
        for zname, z in (("inactive", -1), ("top", solver_cases.TOP), ("middle", solver_cases.MIDDLE),
                         ("bottom", solver_cases.BOTTOM)):
            zones[f"dim{dim}_{zname}"] = int((rows["zone0"][:, gi] == z).sum())
    zones["frictionloss_within_clamp"] = int((~rows["clamped0"]).sum())
    zones["frictionloss_beyond_clamp"] = int(rows["clamped0"].sum())
    require(min(zones.values()) > 0, f"the synthetic problem misses a branch: {zones}")
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[1]
        tol = {"x": TOL_SYNTHETIC[dtype], "qfrc": TOL_SYNTHETIC[dtype]}
        ms = solver_cases.synthetic_model(DEVICE, dtype)
        a = [torch.tensor(rows[k], dtype=dtype, device=DEVICE) for k in ("J", "D", "aref", "fl", "eta", "M", "qs")]
        ref = solver_cuda.solve_batched_reference(
            solver_cases.synthetic_model(DEVICE, torch.float64), *[t.double() for t in a]
        )
        out = solver_cuda.solve_batched(ms, *a)
        torch.cuda.synchronize()
        errs[f"synthetic_{name}_B2049"] = solver_errors(out, ref, tol, f"synthetic {name}", relative=True)
        one = solver_cuda.solve_batched(ms, *[t[:1] for t in a])
        torch.cuda.synchronize()
        errs[f"synthetic_{name}_B1"] = solver_errors(
            one, [r[:1] for r in ref], tol, f"synthetic {name} B=1", relative=True
        )
    return zones


def solver_timing(scene, m64, m32, timing_args, timing_args32, errs):
    """Repeat launches bit for bit, and the times at this scene's rows."""
    # two launches on the same inputs, the same bits: the team's sums have a
    # fixed order and no lane reads what another writes in the same phase
    for model, a in ((m64, timing_args), (m32, timing_args32)):
        first = solver_cuda.solve_batched(model, *a)
        second = solver_cuda.solve_batched(model, *a)
        torch.cuda.synchronize()
        for out_name, x, y in zip(("x", "qfrc"), first, second):
            require(torch.equal(x, y), f"solver kernel, {scene}, {a[0].dtype}: two launches differ in {out_name}")
    emit("solver_repeat_launch", ok=True, scene=scene, bit_equal=True, dtypes=["float64", "float32"], B=B_FULL)

    # ---- timings at the unfused path's shape: the scene's rows, B = 2049, float32 ----
    key = solver_cuda.solver_key(m32, timing_args32[0].shape[1])
    lib = solver_cuda.load_library(key)
    for _ in range(5):
        solver_cuda.solve_batched(m32, *timing_args32)
    torch.cuda.synchronize()
    wrapper_ms = cuda_ms(lambda: solver_cuda.solve_batched(m32, *timing_args32), 100)
    stream = torch.cuda.current_stream().cuda_stream

    def raw_launch(args):
        """The bare kernel on the inputs as they are, timed by the caller."""
        J, D, aref, fl, eta, M, qs = args
        outs = [torch.empty_like(qs) for _ in range(2)]
        fn = lib.fn(J.dtype)
        ptrs = [t.data_ptr() for t in (J, M, D, aref, fl, eta, qs, *outs)]

        def go():
            err = fn(*ptrs, J.shape[0], stream)
            require(err == 0, f"launch failed with cudaError {err}")

        return go

    kernel_ms = cuda_ms(raw_launch(timing_args32), 100)
    kernel_b1_ms = cuda_ms(raw_launch([a[:1] for a in timing_args32]), 100)
    kernel64_ms = cuda_ms(raw_launch(timing_args), 50)
    solver_cuda.solve_batched_reference(m32, *timing_args32)
    torch.cuda.synchronize()
    plain_ms = cuda_ms(lambda: solver_cuda.solve_batched_reference(m32, *timing_args32), 5)
    b1_ms = cuda_ms(lambda: solver_cuda.solve_batched(m32, *[a[:1] for a in timing_args32]), 100)
    wrapper64_ms = cuda_ms(lambda: solver_cuda.solve_batched(m64, *timing_args), 50)

    # each dense operand once in, each result once out
    nbytes = sum(solver_cuda.io_values(key)) * B_FULL * 4
    flops = solver_cuda.solve_flops(key) * B_FULL
    bytes_ms = nbytes / H100_HBM_BYTES_PER_S * 1e3
    ops_ms = flops / H100_FP32_FLOPS * 1e3
    shapes = {name: lib.launch_shape(dt) for name, dt in (("float32", torch.float32), ("float64", torch.float64))}
    return dict(
        max_abs_err=errs["f32_B2049_settled"], wrapper_ms=wrapper_ms, kernel_ms=kernel_ms,
        plain_ms=plain_ms, b1_ms=b1_ms, wrapper64_ms=wrapper64_ms, kernel64_ms=kernel64_ms,
        kernel_b1_ms=kernel_b1_ms, bytes=nbytes, flops=flops, bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations", lanes=lib.lanes,
        samples_per_block={k: v[0] for k, v in shapes.items()},
        teams_per_sm={k: v[1] for k, v in shapes.items()},
        team_shared_bytes={"float32": lib.team_bytes(torch.float32), "float64": lib.team_bytes(torch.float64)},
        ptxas=kernel_ptxas(lib, "solver_newton_kernel"),
    )


def phase_fused_vs_unfused(scene, m64, states):
    """The same states and controls through the step kernel and through the
    plain stages with the solver kernel, float64, inside phase 3's tolerances."""
    errs = {}
    before = solver_cuda.solve_batched.launches
    for name in ("settled", "at_limits"):
        qpos, qvel, ctrl = states[name]
        fused = engine_cuda.step_core(m64, qpos, qvel, ctrl, 1)
        unfused = engine_cuda.step_core_reference(m64, qpos, qvel, ctrl, 1, solver.solve)
        torch.cuda.synchronize()
        errs[name] = compare(m64, fused, unfused, *step_limits(torch.float64, unfused[QACC], float(m64.opt.timestep)),
                             f"{scene}: fused vs unfused, {name}")
    require(solver_cuda.solve_batched.launches == before + 2, "the unfused step did not launch the solver kernel")
    emit("fused_vs_unfused", ok=True, scene=scene, samples_at_joint_limit=states["n_limit"],
         max_abs_err={k: max(v.values()) for k, v in errs.items()}, per_output=errs)


def phase_small_input():
    """The whole planner on a small input: the card (kernel) against the CPU
    (plain physics), float64, with the same injected noise."""
    from dial_mpc_tpu_torch.core.dial_config import DialConfig
    from dial_mpc_tpu_torch.utils.io_utils import load_dataclass_from_dict

    with open(get_example_path("unitree_go2_trot.yaml")) as f:
        cfgd = yaml.safe_load(f)
    cfgd.update(Nsample=8, Ndiffuse=1, Ndiffuse_init=2)
    cfg = load_dataclass_from_dict(DialConfig, cfgd)
    rng = np.random.default_rng(0)
    levels = [cfg.Ndiffuse_init, cfg.Ndiffuse, cfg.Ndiffuse]
    draws = [rng.standard_normal((n, cfg.Nsample, cfg.Hnode + 1, 12)) for n in levels]
    runs = {}
    for device in ("cpu", DEVICE):
        env_cfg = load_dataclass_from_dict(dial_envs.get_config(cfg.env_name), cfgd)
        env = dial_envs.get_environment(cfg.env_name, env_cfg, device=device, dtype=torch.float64)
        planner = MBDPI(cfg, env)
        state = env.reset()
        Y = torch.zeros(cfg.Hnode + 1, planner.nu, device=device, dtype=torch.float64)
        trace = []
        for eps in draws:
            eps = torch.tensor(eps, device=device, dtype=torch.float64)
            state, Y, _ = planner.control_step(state, Y, eps.shape[0], eps=eps)
            trace.append(torch.cat([Y.reshape(-1), state.pipeline_state.qpos[0], state.reward]).cpu())
        runs[device] = torch.stack(trace)
    err = float((runs["cpu"] - runs[DEVICE]).abs().max())
    # float64 on both sides; the softmax over rewards amplifies the kernel's
    # 1e-12 differences by 1 / (std * temperature)
    require(err <= 1e-8, f"planner on the card differs from the CPU by {err:.3e}")
    emit("small_input", ok=True, control_steps=len(draws), Nsample=cfg.Nsample,
         max_abs_err_card_vs_cpu=err, tolerance=1e-8)


WIDTHS = {
    "unitree_go2_trot": dict(Nsample=2048, Hsample=16, Hnode=4, Ndiffuse=2, Ndiffuse_init=10),
    "unitree_go2_seq_jump": dict(Nsample=2048, Hsample=20, Hnode=5, Ndiffuse=2, Ndiffuse_init=10),
    "unitree_h1_jog": dict(Nsample=2048, Hsample=25, Hnode=5, Ndiffuse=4, Ndiffuse_init=10),
    "unitree_h1_loco": dict(Nsample=2048, Hsample=20, Hnode=5, Ndiffuse=1, Ndiffuse_init=10),
    "unitree_go2_crate_climb": dict(Nsample=2048, Hsample=25, Hnode=5, Ndiffuse=4, Ndiffuse_init=10),
    "unitree_h1_push_crate": dict(Nsample=2048, Hsample=24, Hnode=6, Ndiffuse=4, Ndiffuse_init=10),
    "allegro_reorient": dict(Nsample=2048, Hsample=20, Hnode=4, Ndiffuse=2, Ndiffuse_init=10),
}


# Same seed, same draws, the same arithmetic up to float32 rounding (which the
# softmax over rewards amplifies): a run too short to show the walk must
# retrace another route's (or planner's) first steps. 0.02 (rad, m) is far
# below what a different plan would give.
SAME_AS_TOL = 0.02


def env_steps(cfg, n_steps):
    """Env steps of n_steps control steps: one advance each, Hsample + 1 a
    level, Ndiffuse_init levels the first step and Ndiffuse the others."""
    per_level = cfg["Hsample"] + 1
    return n_steps + per_level * (cfg["Ndiffuse_init"] + cfg["Ndiffuse"] * (n_steps - 1))


def phase_path(example, engine, n_steps, same_as=None, overrides=None):
    """One path through runner.run at the shipped width (or with the config's
    ``overrides``), float32. Both launch counts are set to 0 just before and
    read just after. The route's kernel must have been launched once per env step;
    besides, env.reset runs the plain forward once on either route, and its
    solve stage is one launch of the solver kernel. ``same_as`` is the qpos
    trajectory of another route's run of the same example and seed, which
    this run must follow."""
    with open(get_example_path(example + ".yaml")) as f:
        cfg = yaml.safe_load(f)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    cfg.update(n_steps=n_steps, output_dir=out_dir)
    width = {k: cfg[k] for k in WIDTHS[example]}
    require(width == WIDTHS[example], width)
    cfg.update(overrides or {})
    width.update({k: v for k, v in (overrides or {}).items() if k in width})
    # physics steps an env step: one launch of the step kernel runs them all
    n_frames = round(cfg["dt"] / cfg["timestep"])

    engine_cuda.step_core.launches = 0
    solver_cuda.solve_batched.launches = 0
    t0 = time.time()
    summary = runner.run(cfg, progress=False, device=DEVICE, dtype=torch.float32, engine=engine)
    wall = time.time() - t0
    launches = {"engine_step": engine_cuda.step_core.launches,
                "solver_newton": solver_cuda.solve_batched.launches}

    per_level = cfg["Hsample"] + 1
    expected = env_steps(cfg, n_steps)
    if engine == "fused":
        mine, want = "engine_step", {"engine_step": expected, "solver_newton": 1}
    else:
        mine, want = "solver_newton", {"engine_step": 0, "solver_newton": expected + 1}
    require(launches == want, f"{example}/{engine}: launches {launches} != {want}")

    states = np.load(summary["states_path"])
    artifacts = sorted(os.listdir(out_dir))
    shutil.rmtree(out_dir)
    final = summary["state"]
    nq, nv, nu = (final.pipeline_state.qpos.shape[1], final.pipeline_state.qvel.shape[1],
                  final.pipeline_state.ctrl.shape[1])
    require(states.shape == (n_steps, 1 + nq + nv + nu), states.shape)
    qpos, qvel = states[:, 1 : 1 + nq], states[:, 1 + nq : 1 + nq + nv]
    require(np.isfinite(states).all(), "non-finite state")
    require(np.isfinite(summary["rews"]).all(), "non-finite reward")
    # the state the planner froze (its advance diverged) repeats exactly
    guards = dict(rollouts_dropped=int(sum(summary["rollouts_dropped"])),
                  states_frozen=int((np.diff(states[:, 1 : 1 + nq + nv], axis=0) == 0).all(-1).sum()),
                  steps_with_nonfinite_planned_reward=int((~np.isfinite(summary["rews_plan"])).sum()))
    if example != "allegro_reorient":
        require(np.isfinite(summary["rews_plan"]).all(), "non-finite planned reward")
    advance = float(qpos[-1, 0] - qpos[0, 0])
    extra = {}
    if example == "allegro_reorient":
        # The ball does not explode. The reference's behaviour gate
        # (tests/test_behavior.py: qvel[5], the free joint's angular velocity
        # about the ball's own z axis, averages above +0.01 rad/s over 50
        # steps) was calibrated at Nsample 128, where it must hold; at the
        # shipped width it is evaluated and reported, met or not (its sign
        # there follows the seed, in float64 as in float32: PERF.md section
        # 6). Printed beside it: the same about the world's z axis, and how
        # far the ball's z axis tilted from the world's.
        wz = qvel[:, 5]
        R = maths.quat_to_mat(torch.tensor(qpos[:, 3:7], dtype=torch.float64))
        w_world = torch.einsum("tij,tj->ti", R, torch.tensor(qvel[:, 3:6], dtype=torch.float64))
        tilt = torch.rad2deg(torch.arccos(R[:, 2, 2].clamp(-1.0, 1.0)))
        extra = dict(ball_wz_mean=float(wz.mean()), ball_wz_abs_max=float(np.abs(wz).max()),
                     ball_world_wz_mean=float(w_world[:, 2].mean()), ball_tilt_deg_max=float(tilt.max()))
        require(extra["ball_wz_abs_max"] < 20.0, f"ball angular velocity reached {extra['ball_wz_abs_max']:.2f}")
        extra["reference_spin_gate_met"] = n_steps >= 50 and extra["ball_wz_mean"] > 0.01
        extra["seed"] = cfg["seed"]
        if n_steps >= 50 and cfg["Nsample"] == 128:
            require(extra["reference_spin_gate_met"], f"ball wz averaged {extra['ball_wz_mean']:+.4f} rad/s; {extra}")
    elif example == "unitree_go2_trot":  # still walking
        require(qpos[:, 2].min() > 0.18, f"base fell to {qpos[:, 2].min():.3f} m")
        if n_steps >= 50:
            require(advance > 0.05, f"base x advanced only {advance:.3f} m")
        if same_as is not None:
            n = min(n_steps, same_as.shape[0])
            extra["max_qpos_diff_to_other_route"] = float(np.abs(qpos[:n] - same_as[:n]).max())
            require(extra["max_qpos_diff_to_other_route"] <= SAME_AS_TOL,
                    f"the routes part by {extra['max_qpos_diff_to_other_route']:.3e}")
    elif example == "unitree_go2_seq_jump":  # alive, and the stage clock advances every jump_dt / dt steps
        require(qpos[:, 2].min() > 0.1, f"base fell to {qpos[:, 2].min():.3f} m")
        info = final.info
        stage, step = int(info["contact_stage"][0]), int(info["step"][0])
        n_stage = info["pose_target_sequence"].shape[1]
        require(step == n_steps, f"env step count {step} != {n_steps}")
        require(stage == min(int(n_steps * cfg["dt"] / cfg["jump_dt"]), n_stage - 1), f"contact_stage {stage}")
        require(stage >= 1 or n_steps * cfg["dt"] < cfg["jump_dt"], "contact_stage did not advance")
        extra = dict(contact_stage=stage, done=float(final.done[0]))
    elif example == "unitree_go2_crate_climb":  # the base stays up
        require(qpos[:, 2].min() > 0.12, f"base fell to {qpos[:, 2].min():.3f} m")
    else:  # an H1 task: standing (pelvis and, at the end, torso above 0.6 m)
        scene = load_scene("unitree_h1", dial_envs.get_env_class(cfg["env_name"]).scene)
        torso_z = float(final.pipeline_state.x_pos[0, scene.body_id("torso_link") - 1, 2])
        require(qpos[:, 2].min() > 0.6, f"pelvis fell to {qpos[:, 2].min():.3f} m")
        require(torso_z > 0.6, f"torso at {torso_z:.3f} m")
        extra["torso_z_final"] = torso_z
        if example == "unitree_h1_jog" and n_steps >= 30:  # and jogging forward
            require(advance > 0.02, f"base x advanced only {advance:.3f} m")
    step_ms = sorted(1e3 / f for f in summary["freqs"][1:])
    emit(
        "path", ok=True, example=example, engine=engine, n_steps=n_steps, **width, dtype="float32",
        launches=launches, launches_expected=want, env_steps=expected, physics_steps_per_launch=n_frames,
        launches_first_step=1 + per_level * cfg["Ndiffuse_init"],
        launches_per_step=1 + per_level * cfg["Ndiffuse"],
        first_step_ms=1e3 / summary["freqs"][0], control_step_ms_median=step_ms[len(step_ms) // 2],
        control_step_ms_p90=step_ms[int(len(step_ms) * 0.9)], mean_reward=summary["mean_reward"],
        base_x_final=float(qpos[-1, 0]), base_x_advance=advance, base_z_min=float(qpos[:, 2].min()),
        wall_s=wall, **guards, **extra, planner=summary["planner"], artifacts=artifacts,
    )
    return dict(launches=launches[mine], step_ms=step_ms[len(step_ms) // 2],
                p90_ms=step_ms[int(len(step_ms) * 0.9)], first_ms=1e3 / summary["freqs"][0], qpos=qpos,
                planner=summary["planner"], artifacts=artifacts)


DEPLOY_WIDTHS = {
    "unitree_go2_trot_deploy": dict(Nsample=2048, Hsample=16, Hnode=4, Ndiffuse=1, Ndiffuse_init=10),
    "unitree_go2_seq_jump_deploy": dict(Nsample=2048, Hsample=20, Hnode=5, Ndiffuse=1, Ndiffuse_init=10),
    "unitree_h1_loco_deploy": dict(Nsample=3000, Hsample=20, Hnode=5, Ndiffuse=1, Ndiffuse_init=10),
}
DEPLOY_TICKS = 30  # ticks of each deploy example on a static bus
DEPLOY_LOOP_TICKS = 100  # ticks of the closed sync-mode loop (Go2 trot deploy)


def deploy_run(example, pub, n_ticks):
    """n_ticks of pub.main_loop with both launch counts set to 0 just before
    and read just after. A tick runs its levels' rollouts (Hsample + 1 env
    steps a level, one launch of the step kernel each) and no env advance;
    init_state runs the plain forward twice (the env's reset and the state
    at the bus's q), each solve one launch of the solver kernel."""
    cfg = pub.dial_config
    engine_cuda.step_core.launches = 0
    solver_cuda.solve_batched.launches = 0
    pub.main_loop(max_iters=n_ticks, verbose=False)
    launches = {"engine_step": engine_cuda.step_core.launches,
                "solver_newton": solver_cuda.solve_batched.launches}
    per_level = cfg.Hsample + 1
    want = {"engine_step": per_level * (cfg.Ndiffuse_init + cfg.Ndiffuse * (n_ticks - 1)), "solver_newton": 2}
    require(launches == want, f"{example}: launches {launches} != {want}")
    require(pub.last_latency["n"] == n_ticks - 1, f"{example}: latency holds {pub.last_latency['n']} ticks")
    width = {k: getattr(cfg, k) for k in DEPLOY_WIDTHS[example]}
    require(width == DEPLOY_WIDTHS[example], width)
    return dict(launches=launches, width=width, launches_first_tick=per_level * cfg.Ndiffuse_init,
                launches_per_tick=per_level * cfg.Ndiffuse)


def check_published(example, pub):
    """What the planner published on the bus: finite joint targets, torques
    and body positions, torques not all zero, refs written (the publisher
    seeds them with 1.0) and of a body's height, the plan time written."""
    acts, tau, refs = np.array(pub.bus.acts), np.array(pub.bus.tau), np.array(pub.bus.refs)
    nb = pub._nb
    require(np.isfinite(acts).all() and np.isfinite(tau).all() and np.isfinite(refs).all(),
            f"{example}: non-finite plan on the bus")
    require(np.abs(tau).max() > 0.0, f"{example}: the planner published empty torques")
    require(not np.allclose(refs[:, :nb], 1.0) and np.abs(refs[:, :nb, 2]).max() < 2.0,
            f"{example}: refs not written by the packed transfer")
    require(float(pub.bus.plan_time[0]) >= 0.0, f"{example}: plan time never written")
    return dict(tau_abs_max=float(np.abs(tau).max()), plan_time=float(pub.bus.plan_time[0]))


def phase_deploy_ticks(example, n_ticks):
    """(a) The publisher's ticks on a static bus at the deploy YAML's width."""
    _, cfg, env_cfg, env = deploy_bench.load_example(example)
    prefix = run_prefix()
    bus = deploy_bench.static_bus(env, cfg, prefix)
    try:
        pub = MBDPublisher(env, env_cfg, cfg, bus_prefix=prefix)
        try:
            spans = deploy_bench.record_device_spans(pub)
            t0 = time.time()
            run = deploy_run(example, pub, n_ticks)
            wall = time.time() - t0
            published = check_published(example, pub)
            stats = deploy_bench.tick_stats(pub, spans)
            busy = deploy_bench.device_busy_ms(pub, stats["host_ms_p50"])
        finally:
            pub.close()
    finally:
        bus.close()
    emit("deploy_ticks", ok=True, example=example, n_ticks=n_ticks, **run["width"], dtype="float32",
         launches=run["launches"], launches_first_tick=run["launches_first_tick"],
         launches_per_tick=run["launches_per_tick"], **stats, **busy, **published, wall_s=wall, card=deploy_bench.card())
    return dict(launches=run["launches"]["engine_step"], **stats, **busy)


def phase_deploy_closed_loop(n_ticks):
    """(b) Go2 trot deploy in sync mode at full width against the plain
    physics (tools/plain_sim.py, a subprocess that creates the bus, as the
    sim server does). Held to what tests/test_deploy.py's sync integration
    holds the JAX package to (the sim clock advanced, a plan was published,
    torques not all zero), every published state finite, and the trot path's
    gate: the base above 0.18 m over the run."""
    example = "unitree_go2_trot_deploy"
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    out = os.path.join(out_dir, "plain_sim.npz")
    prefix = run_prefix()
    sim = subprocess.Popen(
        [sys.executable, "-m", "dial_mpc_tpu_torch.tools.plain_sim", "--example", example, "--out", out,
         "--bus-prefix", prefix],
        cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True,
    )
    try:
        lines = []
        while not lines or "PLAIN_SIM_READY" not in lines[-1]:
            line = sim.stdout.readline()
            require(line != "", f"the plain sim exited before creating the bus: {''.join(lines)[-2000:]}")
            lines.append(line)
        _, cfg, env_cfg, env = deploy_bench.load_example(example)
        pub = MBDPublisher(env, env_cfg, cfg, bus_prefix=prefix)
        try:
            t0 = time.time()
            run = deploy_run(example, pub, n_ticks)
            wall = time.time() - t0
            published = check_published(example, pub)
            t_sim = float(pub.bus.time[0])
            latency = pub.last_latency
        finally:
            pub.close()
        sim.send_signal(signal.SIGTERM)
        sim_out, _ = sim.communicate(timeout=120)
        require(sim.returncode == 0 and "PLAIN_SIM_DONE" in sim_out, f"plain sim failed: {sim_out[-2000:]}")
        with np.load(out) as z:
            states, nq = z["states"], int(z["nq"])
    finally:
        if sim.poll() is None:
            sim.kill()
            sim.communicate()
        shutil.rmtree(out_dir, ignore_errors=True)
    require(t_sim > 0.0, "sim clock never advanced")
    require(np.isfinite(states).all(), "the plain sim published a non-finite state")
    base_z = states[:, 1 + 2]  # columns: t, qpos, qvel, ctrl
    gate = dict(base_z_min=float(base_z.min()), base_z_final=float(base_z[-1]),
                base_x_advance=float(states[-1, 1] - states[0, 1]))
    emit("deploy_closed_loop", ok=bool(base_z.min() > 0.18), example=example, n_ticks=n_ticks,
         **run["width"], dtype="float32", launches=run["launches"], sim_steps=int(states.shape[0]),
         sim_time_s=t_sim, sim_dt=0.005, nq=nq, **gate, **published, host_ms_p50=latency["p50_ms"],
         host_ms_p90=latency["p90_ms"], host_ms_max=latency["max_ms"], wall_s=wall)
    require(base_z.min() > 0.18, f"closed loop: base fell to {base_z.min():.3f} m")
    return dict(launches=run["launches"]["engine_step"], **gate)


SHARDED_EXAMPLE = "unitree_go2_trot"
SHARDED_STEPS = 20  # control steps of the group of one
SHARDED_GLOO_RANKS = 2  # ranks sharing the one card over gloo (NCCL refuses two ranks on a device)
SHARDED_GLOO_STEPS = 10  # the runner's control steps in those ranks
SHARDED_DEPLOY_EXAMPLE = "unitree_go2_trot_deploy"
SHARDED_DEPLOY_TICKS = 5  # the deploy planner's ticks in those ranks


def sharded_trot(n_steps):
    """n_steps control steps of ShardedMBDPI over the started group, built as
    the JAX package's bench.py metric 2 builds its one-device mesh: the trot
    YAML's width, float32, the generator seeded from the YAML, env.reset on
    it, a zero plan, the first step Ndiffuse_init levels. Each step reads
    back the qpos and the plan's predicted body positions (xbar), as the
    runner's artifacts hold them. Both launch counts are set to 0 just
    before and read just after."""
    from dial_mpc_tpu_torch.core.dial_config import DialConfig
    from dial_mpc_tpu_torch.utils.io_utils import load_dataclass_from_dict

    with open(get_example_path(SHARDED_EXAMPLE + ".yaml")) as f:
        cfgd = yaml.safe_load(f)
    width = {k: cfgd[k] for k in WIDTHS[SHARDED_EXAMPLE]}
    require(width == WIDTHS[SHARDED_EXAMPLE], width)
    cfg = load_dataclass_from_dict(DialConfig, cfgd)
    env_cfg = load_dataclass_from_dict(dial_envs.get_config(cfg.env_name), cfgd, convert_list_to_array=True,
                                       device=DEVICE)
    env = dial_envs.get_environment(cfg.env_name, env_cfg, device=DEVICE, dtype=torch.float32)
    generator = torch.Generator(device=DEVICE).manual_seed(cfg.seed)
    planner = ShardedMBDPI(cfg, env, global_sample_mesh(), generator)

    engine_cuda.step_core.launches = 0
    solver_cuda.solve_batched.launches = 0
    state = env.reset(generator)
    Y = torch.zeros(cfg.Hnode + 1, planner.nu, device=DEVICE)
    nq = env.mj_model.nq
    qpos, xbar, step_ms = [], [], []
    for t in range(n_steps):
        t0 = time.time()
        state, Y, info = planner.control_step(state, Y, cfg.Ndiffuse_init if t == 0 else cfg.Ndiffuse)
        row = torch.cat([state.pipeline_state.qpos[0], info["xbar"][-1].reshape(-1)]).cpu().numpy()
        step_ms.append((time.time() - t0) * 1e3)
        qpos.append(row[:nq])
        xbar.append(row[nq:].reshape(info["xbar"].shape[1:]))
    launches = {"engine_step": engine_cuda.step_core.launches, "solver_newton": solver_cuda.solve_batched.launches}
    want = {"engine_step": env_steps(cfgd, n_steps), "solver_newton": 1}
    require(launches == want, f"ShardedMBDPI: launches {launches} != {want}")
    qpos, xbar = np.stack(qpos), np.stack(xbar)
    require(np.isfinite(qpos).all() and np.isfinite(xbar).all(), "the sharded planner's run is not finite")
    levels = cfg.Ndiffuse_init + cfg.Ndiffuse * (n_steps - 1)
    return dict(planner=planner, state=state, Y=Y, launches=launches, want=want, levels=levels, qpos=qpos,
                xbar=xbar, step_ms=step_ms)


def sharded_rank(rank, store):
    """One rank of phase 6 (b), a process of this script. It joins a gloo
    group of SHARDED_GLOO_RANKS ranks on card 0 and drives both entry points
    with sharding "mesh": runner.run on the trot YAML for SHARDED_GLOO_STEPS
    steps (into a directory of its own), then the deploy planner for
    SHARDED_DEPLOY_TICKS ticks on a static bus that rank 0 creates under a
    prefix of this run. Both launch counts are set to 0 just before each and
    read just after (deploy_run checks the ticks'). What the rank saw goes
    to ``store``/rank<R>.pkl."""
    torch.cuda.set_device(0)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{os.path.join(store, 'gloo')}", world_size=SHARDED_GLOO_RANKS, rank=rank)
    try:
        with open(get_example_path(SHARDED_EXAMPLE + ".yaml")) as f:
            cfgd = yaml.safe_load(f)
        out_dir = os.path.join(store, f"out{rank}")
        cfgd.update(n_steps=SHARDED_GLOO_STEPS, output_dir=out_dir, sharding="mesh")
        engine_cuda.step_core.launches = 0
        solver_cuda.solve_batched.launches = 0
        summary = runner.run(cfgd, progress=False, device=DEVICE, dtype=torch.float32)
        final = summary["state"].pipeline_state
        seen = dict(
            planner=summary["planner"],
            launches={"engine_step": engine_cuda.step_core.launches,
                      "solver_newton": solver_cuda.solve_batched.launches},
            rews=np.array(summary["rews"]), rews_plan=np.array(summary["rews_plan"]),
            qpos=final.qpos.cpu().numpy(), qvel=final.qvel.cpu().numpy(), step_ms=1e3 / np.array(summary["freqs"]),
            artifacts=sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else [],
        )
        if summary["states_path"] is not None:
            seen.update(states=np.load(summary["states_path"]), predictions=np.load(summary["predictions_path"]))

        _, cfg, env_cfg, env = deploy_bench.load_example(SHARDED_DEPLOY_EXAMPLE)
        prefix = run_prefix()
        bus = deploy_bench.static_bus(env, cfg, prefix) if rank == 0 else None
        try:
            pub = MBDPublisher(env, env_cfg, cfg, sharding="mesh", bus_prefix=prefix)
            try:
                tick = deploy_run(SHARDED_DEPLOY_EXAMPLE, pub, SHARDED_DEPLOY_TICKS)
                levels = cfg.Ndiffuse_init + cfg.Ndiffuse * (SHARDED_DEPLOY_TICKS - 1)
                seen.update(
                    pub_planner=type(pub.mbdpi).__name__, attached=pub.bus is not None, Y=pub.Y.cpu().numpy(),
                    generator=pub.generator.get_state().numpy(), tick_launches=tick["launches"],
                    tick_collectives_per_level=pub.mbdpi.collectives / levels, tick_ms_p50=pub.last_latency["p50_ms"],
                    published=check_published(SHARDED_DEPLOY_EXAMPLE, pub) if pub.bus is not None else {},
                )
            finally:
                pub.close()
        finally:
            if bus is not None:
                bus.close()
    finally:
        torch.distributed.destroy_process_group()
    with open(os.path.join(store, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(seen, f)


def nccl_trace(planner, state, Y, n_steps):
    """n_steps control steps traced: the NCCL kernels (count, device ms) and
    the device's busy ms, a step each; and the host time of one all_reduce
    of a level's largest packed tensor, alone."""
    nd = planner.args.Ndiffuse
    x = torch.zeros(3 + planner.args.Nsample, device=DEVICE)
    for _ in range(10):
        torch.distributed.all_reduce(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        torch.distributed.all_reduce(x)
    torch.cuda.synchronize()
    all_reduce_us = (time.perf_counter() - t0) / 200 * 1e6
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n_steps):
            state, Y, _ = planner.control_step(state, Y, nd)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
    nccl = [e for e in kernels if "nccl" in e.key.lower()]
    levels = n_steps * nd
    return dict(nccl_kernels_per_level=sum(e.count for e in nccl) / levels,
                nccl_device_ms_per_level=sum(dev_us(e) for e in nccl) / 1e3 / levels,
                nccl_kernel_names=sorted({e.key[:60] for e in nccl}), all_reduce_host_us=all_reduce_us,
                device_busy_ms_per_step=sum(dev_us(e) for e in kernels) / 1e3 / n_steps)


def step_stats(step_ms):
    """Median and p90 of the steps after the first (which runs Ndiffuse_init
    levels), and the first."""
    ms = sorted(step_ms[1:])
    return dict(step_ms=float(ms[len(ms) // 2]), p90_ms=float(ms[int(len(ms) * 0.9)]), first_ms=float(step_ms[0]))


def phase_sharded(trot):
    """Phase 6: the sample-sharded planner at the trot YAML's width; ``trot``
    is phase 4's fused trot run. Returns the records of the paths and of the
    deploy ticks for the kernels line, and the glue profile."""
    paths, deploy = {}, {}
    has_mujoco = importlib.util.find_spec("mujoco") is not None
    store = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        # (a) a group of one on NCCL (the JAX package's one-device mesh)
        t0 = time.time()
        init_distributed(f"file://{os.path.join(store, 'nccl')}", 1, 0, device=DEVICE)
        try:
            require(torch.distributed.get_backend() == "nccl", torch.distributed.get_backend())
            a = sharded_trot(SHARDED_STEPS)
            per_level = a["planner"].collectives / a["levels"]
            require(per_level == 4, f"{per_level} collectives a level, not 4")
            n = min(SHARDED_STEPS, trot["qpos"].shape[0])
            diff = float(np.abs(a["qpos"][:n] - trot["qpos"][:n]).max())
            require(diff <= SAME_AS_TOL, f"the sharded trot parts from phase 4's by {diff:.3e}")
            trace = nccl_trace(a["planner"], a["state"], a["Y"], 3)
            paths["trot_sharded_world1_nccl"] = dict(launches=a["launches"]["engine_step"], **step_stats(a["step_ms"]))
            s = paths["trot_sharded_world1_nccl"]
            emit("sharded_group_of_one", ok=True, backend="nccl", world=1, n_steps=SHARDED_STEPS,
                 **WIDTHS[SHARDED_EXAMPLE], dtype="float32", launches=a["launches"], launches_expected=a["want"],
                 collectives_per_level=per_level, max_qpos_diff_to_phase4_trot=diff, tolerance=SAME_AS_TOL,
                 first_step_ms=s["first_ms"], control_step_ms_median=s["step_ms"], control_step_ms_p90=s["p90_ms"],
                 phase4_trot_control_step_ms_median=trot["step_ms"], base_z_min=float(a["qpos"][:, 2].min()),
                 **trace, seconds=time.time() - t0)

            # (c) the runner's mesh branch in this group of one: MBDPI, and
            # the viewer only where mujoco is installed
            t0 = time.time()
            c = phase_path(SHARDED_EXAMPLE, "fused", 3, overrides={"sharding": "mesh"})
            require(c["planner"] == "MBDPI", f"the runner built {c['planner']} in a group of one")
            npy = [n for n in c["artifacts"] if n.endswith(".npy")]
            html = [n for n in c["artifacts"] if n.endswith(".html")]
            require(len(npy) == 2 and len(html) == int(has_mujoco), f"artifacts {c['artifacts']}")
            emit("sharded_runner_mesh", ok=True, world=1, planner=c["planner"], artifacts=c["artifacts"],
                 mujoco_installed=has_mujoco, seconds=time.time() - t0)
            paths["trot_runner_mesh_world1"] = c
        finally:
            torch.distributed.destroy_process_group()

        # (b) two ranks on the one card over gloo, each a process of this
        # script: the runner and the deploy planner with sharding "mesh"
        t0 = time.time()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--sharded-rank", str(rank),
                                   "--sharded-store", store],
                                  cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for rank in range(SHARDED_GLOO_RANKS)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=300)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for rank, (p, log) in enumerate(zip(procs, logs)):
            require(p.returncode == 0, f"gloo rank {rank} failed: {log[-3000:]}")
        ranks = []
        for rank in range(SHARDED_GLOO_RANKS):
            with open(os.path.join(store, f"rank{rank}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
        want = {"engine_step": env_steps(WIDTHS[SHARDED_EXAMPLE], SHARDED_GLOO_STEPS), "solver_newton": 1}
        for rank, r in enumerate(ranks):
            require(r["planner"] == "ShardedMBDPI" and r["pub_planner"] == "ShardedMBDPI",
                    f"gloo rank {rank}: the runner built {r['planner']}, the deploy planner {r['pub_planner']}")
            require(r["launches"] == want, f"gloo rank {rank}: the runner's launches {r['launches']} != {want}")
            require(r["tick_collectives_per_level"] == 4,
                    f"gloo rank {rank}: {r['tick_collectives_per_level']} collectives a level of a tick, not 4")
        require([r["attached"] for r in ranks] == [rank == 0 for rank in range(SHARDED_GLOO_RANKS)],
                "a rank other than 0 attached the bus, or rank 0 did not")
        lead = ranks[0]
        require(sum(n.endswith(".npy") for n in lead["artifacts"]) == 2
                and sum(n.endswith(".html") for n in lead["artifacts"]) == int(has_mujoco),
                f"rank 0's artifacts {lead['artifacts']}")
        require(all(r["artifacts"] == [] for r in ranks[1:]), "a rank other than 0 wrote artifacts")
        for k in ("rews", "rews_plan", "qpos", "qvel", "Y", "generator"):
            require(all(np.array_equal(r[k], lead[k]) for r in ranks), f"the gloo ranks' {k} differ")
        nq = a["qpos"].shape[1]
        n = min(SHARDED_GLOO_STEPS, SHARDED_STEPS)
        diffs = dict(qpos=float(np.abs(lead["states"][:n, 1 : 1 + nq] - a["qpos"][:n]).max()),
                     xbar=float(np.abs(lead["predictions"][:n] - a["xbar"][:n]).max()))
        require(max(diffs.values()) <= SAME_AS_TOL, f"the gloo ranks part from the group of one: {diffs}")
        paths["trot_runner_sharded_world2_gloo"] = dict(launches=lead["launches"]["engine_step"],
                                                        **step_stats(lead["step_ms"]))
        deploy[f"{SHARDED_DEPLOY_EXAMPLE}, sharded world 2 gloo"] = dict(launches=lead["tick_launches"]["engine_step"])
        s = paths["trot_runner_sharded_world2_gloo"]
        emit("sharded_two_ranks", ok=True, backend="gloo", world=SHARDED_GLOO_RANKS, n_steps=SHARDED_GLOO_STEPS,
             **WIDTHS[SHARDED_EXAMPLE], samples_per_rank=WIDTHS[SHARDED_EXAMPLE]["Nsample"] // SHARDED_GLOO_RANKS,
             dtype="float32", planner=lead["planner"], launches_per_rank=lead["launches"], launches_expected=want,
             ranks_bit_equal=True, artifacts_by_rank=[r["artifacts"] for r in ranks],
             max_diff_to_group_of_one=diffs, tolerance=SAME_AS_TOL, first_step_ms=s["first_ms"],
             control_step_ms_median=s["step_ms"], control_step_ms_p90=s["p90_ms"],
             rank1_control_step_ms_median=step_stats(ranks[1]["step_ms"])["step_ms"],
             deploy_example=SHARDED_DEPLOY_EXAMPLE, deploy_ticks=SHARDED_DEPLOY_TICKS,
             deploy_launches_per_rank=lead["tick_launches"],
             deploy_collectives_per_level=lead["tick_collectives_per_level"],
             deploy_tick_host_ms_p50=lead["tick_ms_p50"], deploy_attached_by_rank=[r["attached"] for r in ranks],
             **lead["published"], seconds=time.time() - t0)
    finally:
        shutil.rmtree(store, ignore_errors=True)

    # (d) the glue profiler at trot width
    t0 = time.time()
    glue = glue_profile.profile(SHARDED_EXAMPLE, DEVICE, trials=5)
    emit("glue_profile", ok=True, **glue, seconds=time.time() - t0)
    return paths, deploy, glue


def build_all(models):
    """Phase 2: every library of the paths below, all nvcc runs started
    together: the step kernel and the solver kernel for each scene, and the
    solver kernel for the synthetic key."""
    jobs = {}
    for name, m32 in models.items():
        nefc = engine_cuda.static_layout(m32)["j_sup"].shape[0]
        jobs[f"engine_step[{name}]"] = lambda m32=m32: engine_cuda.load_library(m32)
        jobs[f"solver_newton[{name}]"] = lambda m32=m32, nefc=nefc: solver_cuda.load_library(
            solver_cuda.solver_key(m32, nefc))
    jobs["solver_newton[synthetic]"] = lambda: solver_cuda.load_library(
        solver_cuda.solver_key(solver_cases.synthetic_model(DEVICE), solver_cases.SPEC["nefc"])
    )
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {name: pool.submit(job) for name, job in jobs.items()}
        libs = {name: f.result() for name, f in futures.items()}
    emit(
        "build", ok=True, seconds=time.time() - t0,
        libraries={
            name: dict(seconds=lib.build_seconds, library=os.path.relpath(lib.path),
                       ptxas=cuda_build.ptxas_entries(lib.build_log))
            for name, lib in libs.items()
        },
    )


def phase_parent_bits(parent):
    """Phase 2, with --parent: kernel E of every scene and kernel S of the Go2
    flat scene, this checkout's against another's, on the same states; the
    timing tools in processes of their own, in turns parent, this, this,
    parent. Every run must print the same output hashes."""
    here = os.path.dirname(os.path.abspath(__file__))
    parent = os.path.abspath(parent)
    tools = os.path.join(here, "dial_mpc_tpu_torch", "tools")
    inputs = tempfile.mkdtemp(prefix="parent_bits_")
    runs = []
    t0 = time.time()
    for label, tree in (("parent", parent), ("this", here), ("this", here), ("parent", parent)):
        env = {**os.environ, "PYTHONPATH": tree}
        lines = {}
        for tool, more in (("time_step_kernel.py", ["--scene", "all", "--inputs", inputs]),
                           ("time_solver_kernel.py", [])):
            r = subprocess.run([sys.executable, os.path.join(tools, tool), "--label", label, *more],
                               env=env, cwd=tree, capture_output=True, text=True)
            require(r.returncode == 0, f"{tool} on {tree} failed:\n{r.stderr[-3000:]}")
            for line in r.stdout.splitlines():
                if line.startswith("{"):
                    rec = json.loads(line)
                    lines[rec.get("scene", "solver_go2")] = rec
        runs.append((label, lines))
    hashes = ("float32_output_sha256", "float64_output_sha256")
    per_key = {}
    for key in runs[0][1]:
        seen = {(label, h, lines[key][h]) for label, lines in runs for h in hashes}
        require(len({(h, v) for _, h, v in seen}) == 2,
                f"{key}: kernel outputs differ between the checkouts or runs: {sorted(seen)}")
        per_key[key] = {
            label: {k: v for k, v in lines[key].items() if k not in ("label", "card")}
            for label, lines in runs[:2]
        }
        for name in ("float32_kernel_ms", "float32_B1_kernel_ms", "float64_kernel_ms", "float64_B1_kernel_ms"):
            per_key[key][name + "_in_turns"] = [lines[key].get(name) for _, lines in runs]
    emit("parent_bits", ok=True, parent=parent, seconds=time.time() - t0, order=[label for label, _ in runs],
         identical_outputs=True, per_key=per_key)


def key_record(t, scene_model):
    """What the kernels line keeps of one key's timing."""
    return dict(
        nv=scene_model.nv, nefc=int(engine_cuda.static_layout(scene_model)["j_sup"].shape[0]),
        kernel_ms=t["kernel_ms"], wrapper_ms=t["wrapper_ms"], plain_ms=t["plain_ms"],
        bound_ms=t["bound_ms"], bound_by=t["bound_by"], kernel_b1_ms=t["kernel_b1_ms"],
        f64_kernel_ms=t["kernel64_ms"], max_abs_err=max(t["max_abs_err"].values()),
        teams_per_sm=t["teams_per_sm"], team_shared_bytes=t["team_shared_bytes"],
        samples_per_block=t["samples_per_block"], ptxas=t["ptxas"], waves=t.get("waves"),
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=50, help="control steps of Go2 trot, fused route")
    ap.add_argument("--unfused-steps", type=int, default=3, help="control steps of Go2 trot, unfused route")
    ap.add_argument("--jump-steps", type=int, default=55, help="control steps of Go2 seq-jump, fused route")
    ap.add_argument("--jog-steps", type=int, default=40, help="control steps of H1 jog, fused route")
    ap.add_argument("--loco-steps", type=int, default=20, help="control steps of H1 loco, fused route")
    ap.add_argument("--crate-steps", type=int, default=30, help="control steps of Go2 crate climb, fused route")
    ap.add_argument("--push-steps", type=int, default=20, help="control steps of H1 push crate, fused route")
    ap.add_argument("--allegro-steps", type=int, default=50,
                    help="control steps of Allegro in-hand reorientation, fused route")
    ap.add_argument("--compare-only", action="store_true",
                    help="build and compare the kernels, then stop (a short run after a kernel edit)")
    ap.add_argument("--parent", type=str, default=None,
                    help="another checkout whose kernels E and S must give the same bits (phase 2)")
    # one rank of phase 6 (b); the script starts these itself
    ap.add_argument("--sharded-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--sharded-store", type=str, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.sharded_rank is not None:
        sharded_rank(args.sharded_rank, args.sharded_store)
        return
    t_start = time.time()

    smi = sh("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader")
    emit(
        "environment", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, nvcc=sh("nvcc --version | tail -n 2 | head -n 1")
        or sh("/usr/local/cuda/bin/nvcc --version | tail -n 2 | head -n 1"),
        card=smi, device_count=torch.cuda.device_count(),
    )
    torch.backends.cuda.matmul.allow_tf32 = False

    mjs = {}
    for name, (robot, xml) in SCENES.items():
        mjs[name] = load_scene(robot, xml)
        mjs[name].opt.timestep = TIMESTEP.get(name, 0.02)
    build_all({name: put_model(mj, device=DEVICE, dtype=torch.float32) for name, mj in mjs.items()})
    if args.parent:
        phase_parent_bits(args.parent)

    keys_e, keys_s = {}, {}
    batches = path_batches()
    emit("path_batches", B_full=B_FULL, others=batches)
    for name, mj in mjs.items():
        t_scene = time.time()
        t_e, m64, m32, states = phase_compare(name, mj, batches.get(name, ()))
        emit("engine_step_timing", scene=name, **{k: v for k, v in t_e.items() if k != "max_abs_err"},
             card=smi)
        t_s = phase_solver_compare(name, m64, m32, states)
        emit("solver_newton_timing", scene=name, **{k: v for k, v in t_s.items() if k != "max_abs_err"},
             card=smi)
        phase_fused_vs_unfused(name, m64, states)
        keys_e[name], keys_s[name] = key_record(t_e, m64), key_record(t_s, m64)
        if name == "go2":  # the kernels line's main numbers
            timing_e, timing_s = t_e, t_s
        emit("scene_done", scene=name, seconds=time.time() - t_scene)
        del states
        torch.cuda.empty_cache()
    phase_small_input()
    if args.compare_only:
        emit("done", seconds=time.time() - t_start, compare_only=True)
        return
    paths = {}
    paths["trot"] = phase_path("unitree_go2_trot", "fused", args.steps)
    paths["trot_unfused"] = phase_path(
        "unitree_go2_trot", "unfused", args.unfused_steps, same_as=paths["trot"]["qpos"]
    )
    paths["seq_jump"] = phase_path("unitree_go2_seq_jump", "fused", args.jump_steps)
    paths["h1_jog"] = phase_path("unitree_h1_jog", "fused", args.jog_steps)
    paths["h1_loco"] = phase_path("unitree_h1_loco", "fused", args.loco_steps)
    paths["go2_crate_climb"] = phase_path("unitree_go2_crate_climb", "fused", args.crate_steps)
    paths["h1_push_crate"] = phase_path("unitree_h1_push_crate", "fused", args.push_steps)
    paths["allegro_reorient"] = phase_path("allegro_reorient", "fused", args.allegro_steps)
    for seed in range(4):  # the reference's spin gate at its own width, over seeds
        paths[f"allegro_reorient_gate_seed{seed}"] = phase_path(
            "allegro_reorient", "fused", 50, overrides={"Nsample": ALLEGRO_GATE_NSAMPLE, "seed": seed})
    fused = {k: v for k, v in paths.items() if k != "trot_unfused"}
    deploy = {example: phase_deploy_ticks(example, DEPLOY_TICKS) for example in DEPLOY_WIDTHS}
    deploy["unitree_go2_trot_deploy, closed loop"] = phase_deploy_closed_loop(DEPLOY_LOOP_TICKS)
    sharded, sharded_deploy, glue = phase_sharded(paths["trot"])
    fused.update(sharded)
    deploy.update(sharded_deploy)

    def kernel_line(name, source, replaces, launches, t, **more):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "shape": f"B={B_FULL},f32", "launches": launches,
            "max_abs_err": max(t["max_abs_err"].values()), "ms": t["wrapper_ms"],
            "kernel_ms": t["kernel_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None, "b1_ms": t["b1_ms"],
            "f64_ms": t["wrapper64_ms"], "bytes": t["bytes"], "flops": t["flops"], **more,
        }

    kernels = [
        kernel_line(
            "engine_step", "dial_mpc_tpu_torch/csrc/engine_step.cu",
            "dial_mpc_tpu/physics/engine_pallas.py:1341", paths["trot"]["launches"], timing_e,
            path="unitree_go2_trot, fused route",
            launches_by_path={k: v["launches"] for k, v in fused.items()},
            control_step_ms_by_path={k: dict(median=v["step_ms"], p90=v["p90_ms"], first=v["first_ms"])
                                     for k, v in fused.items()},
            deploy_launches_by_path={k: v["launches"] for k, v in deploy.items()},
            deploy_tick_ms={k: dict(host_p50=v["host_ms_p50"], host_p90=v["host_ms_p90"], host_max=v["host_ms_max"],
                                    device_span_p50=v["device_span_ms_p50"], device_busy=v["device_busy_ms"],
                                    device_idle_share=v["device_idle_share"])
                            for k, v in deploy.items() if "host_ms_p50" in v},
            glue_profile_ms={k: glue[k] for k in ("control_step_ms", "rollouts_ms", "reverse_once_ms")},
            kernel_b1_ms=timing_e["kernel_b1_ms"], f64_kernel_ms=timing_e["kernel64_ms"],
            lanes=timing_e["lanes"], teams_per_sm=timing_e["teams_per_sm"],
            team_shared_bytes=timing_e["team_shared_bytes"], ptxas=timing_e["ptxas"],
            keys=keys_e,
        ),
        kernel_line(
            "solver_newton", "dial_mpc_tpu_torch/csrc/solver_newton.cu",
            "dial_mpc_tpu/physics/solver_pallas.py:430", paths["trot_unfused"]["launches"], timing_s,
            path="unitree_go2_trot, unfused route", control_step_ms_median=paths["trot_unfused"]["step_ms"],
            kernel_b1_ms=timing_s["kernel_b1_ms"], f64_kernel_ms=timing_s["kernel64_ms"],
            lanes=timing_s["lanes"], samples_per_block=timing_s["samples_per_block"],
            teams_per_sm=timing_s["teams_per_sm"], team_shared_bytes=timing_s["team_shared_bytes"],
            ptxas=timing_s["ptxas"], keys=keys_s,
        ),
    ]
    emit("done", seconds=time.time() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
