"""Where one Go2 control step spends its time on the card.

    python3 -m dial_mpc_tpu_torch.tools.profile_trot [--steps 5] [--out profile_trot.json]
        [--example unitree_go2_trot|unitree_go2_seq_jump] [--engine fused|unfused]

Runs the planner at the example's shipped width (trot: Nsample 2048, Hsample
16, Hnode 4, Ndiffuse 2) in float32 on the chosen engine route, warms up, then
traces ``--steps`` control steps with ``torch.profiler`` and prints one JSON
object: wall time per step, device time per step summed over kernels, the
device's idle share, the step kernel's and the solver kernel's share, and the
ten kernels with the most device time. Needs a CUDA
device; there is no CPU mode because every number here is a device metric.
"""

import argparse
import json
import os
import subprocess
import time

import torch
import yaml

import dial_mpc_tpu_torch.envs as dial_envs
from dial_mpc_tpu_torch.core.dial_config import DialConfig
from dial_mpc_tpu_torch.core.dial_core import MBDPI
from dial_mpc_tpu_torch.envs.base_env import ENGINES
from dial_mpc_tpu_torch.physics import engine_cuda, solver_cuda
from dial_mpc_tpu_torch.utils.io_utils import get_example_path, load_dataclass_from_dict


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--example", type=str, default="unitree_go2_trot")
    ap.add_argument("--engine", type=str, default="fused", choices=ENGINES)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_trot needs a CUDA device")

    with open(get_example_path(args.example + ".yaml")) as f:
        cfgd = yaml.safe_load(f)
    cfg = load_dataclass_from_dict(DialConfig, cfgd)
    env_cfg = load_dataclass_from_dict(
        dial_envs.get_config(cfg.env_name), cfgd, convert_list_to_array=True, device="cuda"
    )
    env = dial_envs.get_environment(
        cfg.env_name, env_cfg, device="cuda", dtype=torch.float32, engine=args.engine
    )
    planner = MBDPI(cfg, env, torch.Generator(device="cuda").manual_seed(cfg.seed))
    state = env.reset()
    Y = torch.zeros(cfg.Hnode + 1, planner.nu, device="cuda")
    state, Y, _ = planner.control_step(state, Y, cfg.Ndiffuse_init)
    for _ in range(3):
        state, Y, _ = planner.control_step(state, Y, cfg.Ndiffuse)
    torch.cuda.synchronize()

    launches0 = engine_cuda.step_core.launches
    solves0 = solver_cuda.solve_batched.launches
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.steps):
            state, Y, _ = planner.control_step(state, Y, cfg.Ndiffuse)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
    total_us = sum(dev_us(e) for e in kernels)
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    step_us = sum(dev_us(e) for e in kernels if "engine_step_kernel" in e.key)
    solver_us = sum(dev_us(e) for e in kernels if "solver_newton_kernel" in e.key)
    device_ms = total_us / 1e3 / args.steps
    result = {
        "card": subprocess.run(
            "nvidia-smi --query-gpu=name,power.limit --format=csv,noheader",
            shell=True, capture_output=True, text=True,
        ).stdout.strip(),
        "example": args.example,
        "engine": args.engine,
        "steps": args.steps,
        "wall_ms_per_step_traced": wall_ms,
        "device_ms_per_step": device_ms,
        "step_kernel_device_ms_per_step": step_us / 1e3 / args.steps,
        "step_kernel_launches_per_step": (engine_cuda.step_core.launches - launches0) / args.steps,
        "solver_kernel_device_ms_per_step": solver_us / 1e3 / args.steps,
        "solver_kernel_launches_per_step": (solver_cuda.solve_batched.launches - solves0) / args.steps,
        "device_kernel_launches_per_step": sum(e.count for e in kernels) / args.steps,
        "top_kernels": [
            {"name": e.key[:80], "count_per_step": e.count / args.steps,
             "device_ms_per_step": dev_us(e) / 1e3 / args.steps}
            for e in top
        ],
    }
    # the same steps untraced: the profiler's own cost
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, Y, _ = planner.control_step(state, Y, cfg.Ndiffuse)
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    result["wall_ms_per_step_untraced"] = untraced_ms
    result["device_idle_share"] = 1.0 - device_ms / untraced_ms if total_us else None
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)


if __name__ == "__main__":
    main()
