#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py [--steps N]

Phases, each printing one JSON line; any failure exits non-zero:
  1. environment (torch, CUDA, nvcc, card name and power limit);
  2. build of the step kernel's library from dial_mpc_tpu_torch/csrc;
  3. the kernel against its plain PyTorch version on the card: Go2 flat
     scene, a contact-rich batch, B = 2049 and B = 1, float64 and float32,
     and n_steps = 4 against four sequential launches; then the whole
     planner on a small input, card against CPU;
  4. the main path: the synchronous Go2 trot solve through
     dial_mpc_tpu_torch.core.runner.run at the shipped width (Nsample 2048,
     Hsample 16, Hnode 4, Ndiffuse 2, Ndiffuse_init 10), float32, with the
     number of control steps cut to --steps, and the launch count checked;
  5. the kernel's times beside its bound.
The last line is {"ok": true, "device": {...}}.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import yaml

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")

from dial_mpc_tpu_torch.core import runner
from dial_mpc_tpu_torch.physics import engine_cuda, make_data, put_model, step
from dial_mpc_tpu_torch.physics.compiled_model import load_scene
from dial_mpc_tpu_torch.utils.io_utils import get_example_path

DEVICE = "cuda"
B_FULL = 2049  # Nsample + 1 rollouts of the shipped trot config
H100_FP32_FLOPS = 67e12  # dense float32 outside the tensor cores, published peak
H100_HBM_BYTES_PER_S = 3.35e12

# float64: the tolerances the JAX package holds its own kernel to.
TOL_F64 = {"qpos": 1e-9, "site_xpos": 1e-9, "x_pos": 1e-9, "cdist": 1e-9, "cpos": 1e-9}
TOL_F64_DEFAULT = 1e-7
# float32 kernel against the float64 plain version on the same inputs. One
# rounding is 6e-8 relative. The batch is violent on purpose (random torques,
# feet in the ground, joints at their limits): qacc reaches 1e3..1e4 and the
# Newton solve amplifies rounding by the Hessian's conditioning, so qacc is
# held to 0.5 absolute (about 1e-4 of its range), qvel to timestep times
# that, qpos to timestep times qvel's; pre-step products to a few ulps.
TOL_F32 = {"qacc": 0.5, "qvel": 1e-2, "qpos": 2e-4, "xd_vel": 1e-4, "xd_ang": 1e-4}
TOL_F32_DEFAULT = 1e-5


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def require(cond, message):
    if not cond:
        raise AssertionError(message)


def sh(cmd):
    return subprocess.run(cmd, shell=True, capture_output=True, text=True).stdout.strip()


def contact_rich_batch(mj, model, batch, seed=0, settle=5):
    """States settled into contact by the plain step under random ctrl."""
    rng = np.random.default_rng(seed)
    dtype = model.dtype
    qpos = np.tile(np.asarray(mj.key_qpos[0], np.float64), (batch, 1))
    qpos += rng.normal(0, 0.01, qpos.shape)
    qpos[:, 3:7] /= np.linalg.norm(qpos[:, 3:7], axis=1, keepdims=True)

    def t(a):
        return torch.tensor(a, dtype=dtype, device=DEVICE)

    d = make_data(model, batch).replace(qpos=t(qpos), qvel=t(rng.normal(0, 0.2, (batch, mj.nv))))
    for _ in range(settle):
        d = step(model, d.replace(ctrl=t(rng.uniform(-8.0, 8.0, (batch, mj.nu)))))
    require(bool(torch.isfinite(d.qpos).all()), "settle rollout diverged")
    return d.qpos.contiguous(), d.qvel.contiguous(), t(rng.uniform(-8.0, 8.0, (batch, mj.nu)))


def compare(model, outs, refs, tol, tol_default, what):
    worst = {}
    for (name, _), a, b in zip(engine_cuda.out_specs(model), outs, refs):
        err = float((a.double() - b.double()).abs().max())
        worst[name] = err
        limit = tol.get(name, tol_default)
        if not (err <= limit):  # also catches NaN
            raise AssertionError(f"{what}: {name} differs by {err:.3e} > {limit:.1e}")
    return worst


def cuda_ms(fn, n):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def phase_compare(mj):
    """Phase 3; returns what phase 5 needs."""
    m64 = put_model(mj, device=DEVICE, dtype=torch.float64)
    m32 = put_model(mj, device=DEVICE, dtype=torch.float32)
    qpos, qvel, ctrl = contact_rich_batch(mj, m64, B_FULL)
    errs = {}

    ref1 = engine_cuda.step_core_reference(m64, qpos, qvel, ctrl, 1)
    out1 = engine_cuda.step_core(m64, qpos, qvel, ctrl, 1)
    torch.cuda.synchronize()
    errs["f64_B2049"] = compare(m64, out1, ref1, TOL_F64, TOL_F64_DEFAULT, "f64 B=2049")

    one = engine_cuda.step_core(m64, qpos[:1], qvel[:1], ctrl[:1], 1)
    torch.cuda.synchronize()
    errs["f64_B1"] = compare(
        m64, one, [r[:1] for r in ref1], TOL_F64, TOL_F64_DEFAULT, "f64 B=1"
    )

    # four steps under constant ctrl drive joints into their limits: the
    # fused launch against the plain version, and against four launches
    ref4 = engine_cuda.step_core_reference(m64, qpos, qvel, ctrl, 4)
    out4 = engine_cuda.step_core(m64, qpos, qvel, ctrl, 4)
    seq = out1
    for _ in range(3):
        seq = engine_cuda.step_core(m64, seq[0].contiguous(), seq[1].contiguous(), ctrl, 1)
    torch.cuda.synchronize()
    errs["f64_B2049_n4"] = compare(m64, out4, ref4, TOL_F64, TOL_F64_DEFAULT, "f64 n_steps=4")
    jr = m64.jnt_range[1:]
    q_before_last = engine_cuda.step_core(m64, qpos, qvel, ctrl, 3)[0][:, 7:]
    n_limit = int(((q_before_last < jr[:, 0]) | (q_before_last > jr[:, 1])).any(-1).sum())
    if n_limit == 0:
        raise AssertionError("no sample of the batch reached a joint limit")
    for name, a, b in zip(engine_cuda.OUTPUT_NAMES, out4, seq):
        if not torch.equal(a, b):
            raise AssertionError(f"n_steps=4 differs from four launches in {name}")

    q32, v32, c32 = qpos.float(), qvel.float(), ctrl.float()
    out32 = engine_cuda.step_core(m32, q32, v32, c32, 1)
    ref32 = engine_cuda.step_core_reference(m64, q32.double(), v32.double(), c32.double(), 1)
    torch.cuda.synchronize()
    errs["f32_B2049"] = compare(m32, out32, ref32, TOL_F32, TOL_F32_DEFAULT, "f32 B=2049")
    one32 = engine_cuda.step_core(m32, q32[:1], v32[:1], c32[:1], 1)
    torch.cuda.synchronize()
    errs["f32_B1"] = compare(
        m32, one32, [r[:1] for r in ref32], TOL_F32, TOL_F32_DEFAULT, "f32 B=1"
    )
    # the float32 kernel on the states that sit at joint limits (after three steps)
    at_limit = engine_cuda.step_core(m64, qpos, qvel, ctrl, 3)
    ql, vl = at_limit[0].contiguous(), at_limit[1].contiguous()
    out32_l = engine_cuda.step_core(m32, ql.float(), vl.float(), c32, 1)
    ref32_l = engine_cuda.step_core_reference(
        m64, ql.float().double(), vl.float().double(), c32.double(), 1
    )
    torch.cuda.synchronize()
    errs["f32_B2049_at_limits"] = compare(
        m32, out32_l, ref32_l, TOL_F32, TOL_F32_DEFAULT, "f32 at joint limits"
    )
    out32_4 = engine_cuda.step_core(m32, q32, v32, c32, 4)
    seq32 = out32
    for _ in range(3):
        seq32 = engine_cuda.step_core(m32, seq32[0].contiguous(), seq32[1].contiguous(), c32, 1)
    torch.cuda.synchronize()
    for name, a, b in zip(engine_cuda.OUTPUT_NAMES, out32_4, seq32):
        if not torch.equal(a, b):
            raise AssertionError(f"float32 n_steps=4 differs from four launches in {name}")

    emit(
        "compare", ok=True, samples_at_joint_limit=n_limit,
        tolerance={"f64": {**TOL_F64, "rest": TOL_F64_DEFAULT}, "f32": {**TOL_F32, "rest": TOL_F32_DEFAULT}},
        max_abs_err={k: max(v.values()) for k, v in errs.items()}, per_output=errs,
        n_steps4_equals_four_launches=True,
    )

    # ---- timings at the main path's shape: B = 2049, float32 ----
    for _ in range(5):
        engine_cuda.step_core(m32, q32, v32, c32, 1)
    torch.cuda.synchronize()
    wrapper_ms = cuda_ms(lambda: engine_cuda.step_core(m32, q32, v32, c32, 1), 100)
    lib = engine_cuda.load_library(m32)
    packed_in = torch.cat([q32, v32, c32], dim=1).t().contiguous()
    packed_out = torch.empty((lib.out_rows, B_FULL), dtype=torch.float32, device=DEVICE)
    stream = torch.cuda.current_stream().cuda_stream
    fn = lib.fn(torch.float32)

    def raw():
        err = fn(packed_in.data_ptr(), packed_out.data_ptr(), B_FULL, 1, stream)
        require(err == 0, f"launch failed with cudaError {err}")

    kernel_ms = cuda_ms(raw, 100)
    engine_cuda.step_core_reference(m32, q32, v32, c32, 1)
    torch.cuda.synchronize()
    plain_ms = cuda_ms(lambda: engine_cuda.step_core_reference(m32, q32, v32, c32, 1), 3)
    b1_ms = cuda_ms(lambda: engine_cuda.step_core(m32, q32[:1], v32[:1], c32[:1], 1), 100)
    wrapper64_ms = cuda_ms(lambda: engine_cuda.step_core(m64, qpos, qvel, ctrl, 1), 50)

    nbytes = (lib.in_rows + lib.out_rows) * B_FULL * 4
    flops = engine_cuda.step_flops(m32) * B_FULL
    bytes_ms = nbytes / H100_HBM_BYTES_PER_S * 1e3
    ops_ms = flops / H100_FP32_FLOPS * 1e3
    return dict(
        max_abs_err=errs["f32_B2049"], wrapper_ms=wrapper_ms, kernel_ms=kernel_ms,
        plain_ms=plain_ms, b1_ms=b1_ms, wrapper64_ms=wrapper64_ms, bytes=nbytes, flops=flops,
        bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
    )


def phase_small_input():
    """The whole planner on a small input: the card (kernel) against the CPU
    (plain physics), float64, with the same injected noise."""
    import dial_mpc_tpu_torch.envs as dial_envs
    from dial_mpc_tpu_torch.core.dial_config import DialConfig
    from dial_mpc_tpu_torch.core.dial_core import MBDPI
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


def phase_main_path(n_steps):
    with open(get_example_path("unitree_go2_trot.yaml")) as f:
        cfg = yaml.safe_load(f)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    cfg.update(n_steps=n_steps, output_dir=out_dir)
    width = {k: cfg[k] for k in ("Nsample", "Hsample", "Hnode", "Ndiffuse", "Ndiffuse_init")}
    require(width == dict(Nsample=2048, Hsample=16, Hnode=4, Ndiffuse=2, Ndiffuse_init=10), width)

    engine_cuda.step_core.launches = 0
    t0 = time.time()
    summary = runner.run(cfg, progress=False, device=DEVICE, dtype=torch.float32)
    wall = time.time() - t0
    launches = engine_cuda.step_core.launches

    per_level = cfg["Hsample"] + 1
    expected = n_steps + per_level * (cfg["Ndiffuse_init"] + cfg["Ndiffuse"] * (n_steps - 1))
    require(launches == expected, f"step kernel launches {launches} != {expected}")

    states = np.load(summary["states_path"])
    shutil.rmtree(out_dir)
    qpos = states[:, 1:20]
    require(states.shape == (n_steps, 1 + 19 + 18 + 12), states.shape)
    require(np.isfinite(states).all(), "non-finite state")
    require(np.isfinite(summary["rews"]).all(), "non-finite reward")
    require(np.isfinite(summary["rews_plan"]).all(), "non-finite planned reward")
    require(qpos[:, 2].min() > 0.18, f"base fell to {qpos[:, 2].min():.3f} m")
    advance = float(qpos[-1, 0] - qpos[0, 0])
    require(advance > (0.05 if n_steps >= 50 else 0.0), f"base x advanced only {advance:.3f} m")
    step_ms = sorted(1e3 / f for f in summary["freqs"][1:])
    emit(
        "main_path", ok=True, n_steps=n_steps, **width, dtype="float32", launches=launches,
        launches_expected=expected, launches_first_step=1 + per_level * cfg["Ndiffuse_init"],
        launches_per_step=1 + per_level * cfg["Ndiffuse"],
        first_step_ms=1e3 / summary["freqs"][0], control_step_ms_median=step_ms[len(step_ms) // 2],
        control_step_ms_p90=step_ms[int(len(step_ms) * 0.9)], mean_reward=summary["mean_reward"],
        base_x_final=float(qpos[-1, 0]), base_z_min=float(qpos[:, 2].min()), wall_s=wall,
    )
    return launches, step_ms[len(step_ms) // 2]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=50, help="control steps of the main path")
    args = ap.parse_args()
    t_start = time.time()

    smi = sh("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader")
    emit(
        "environment", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, nvcc=sh("nvcc --version | tail -n 2 | head -n 1")
        or sh("/usr/local/cuda/bin/nvcc --version | tail -n 2 | head -n 1"),
        card=smi, device_count=torch.cuda.device_count(),
    )
    torch.backends.cuda.matmul.allow_tf32 = False

    mj = load_scene("unitree_go2", "mjx_scene_force.xml")
    mj.opt.timestep = 0.02
    lib = engine_cuda.load_library(put_model(mj, device=DEVICE, dtype=torch.float32))
    emit(
        "build", ok=True, seconds=lib.build_seconds, library=os.path.relpath(lib.path),
        ptxas=[l.strip() for l in lib.build_log.splitlines() if "spill" in l or "registers" in l],
    )

    timing = phase_compare(mj)
    phase_small_input()
    launches, step_ms = phase_main_path(args.steps)

    kernels = [
        {
            "name": "engine_step",
            "route": "cuda",
            "source": "dial_mpc_tpu_torch/csrc/engine_step.cu",
            "replaces": "dial_mpc_tpu/physics/engine_pallas.py:1341",
            "shape": f"B={B_FULL},f32",
            "launches": launches,
            "max_abs_err": max(timing["max_abs_err"].values()),
            "ms": timing["wrapper_ms"],
            "kernel_ms": timing["kernel_ms"],
            "plain_ms": timing["plain_ms"],
            "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"],
            "library_ms": None,
            "b1_ms": timing["b1_ms"],
            "f64_ms": timing["wrapper64_ms"],
            "bytes": timing["bytes"],
            "flops": timing["flops"],
            "control_step_ms_median": step_ms,
        }
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
