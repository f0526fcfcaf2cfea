"""Where a control step's time goes: the batched rollouts against the planner's glue.

    python -m dial_mpc_tpu_torch.tools.glue_profile [--example unitree_go2_trot] [--trials 7]
        [--device cuda|cpu] [--nsample N]

Builds the example's planner (float32, the YAML's width unless ``--nsample``
cuts it), warms it with a control step of Ndiffuse_init levels and one of
Ndiffuse, then times three things from that state, each the median of
``--trials`` trials in one call:

  1. ``control_step``: env advance + plan shift + Ndiffuse annealing levels;
  2. the batched rollouts alone (``rollout_us`` at Nsample + 1);
  3. one ``reverse_once``: sampling, spline, the rollouts, softmax, xbar.

Each trial is timed by the host clock around work that ends in a
synchronisation and, on the card, by CUDA events around the same work.
glue a level = reverse_once - rollouts; advance + shift = control_step -
Ndiffuse x reverse_once. Prints one JSON line. Runs on the card unless
``--device cpu`` is given; there the device times are None (not measured).
"""

import argparse
import json
import time

import numpy as np
import torch
import yaml

import dial_mpc_tpu_torch.envs as dial_envs
from dial_mpc_tpu_torch.core.dial_config import DialConfig
from dial_mpc_tpu_torch.core.dial_core import MBDPI, rollout_us
from dial_mpc_tpu_torch.envs.base_env import expand_state, require_device
from dial_mpc_tpu_torch.utils.io_utils import get_example_path, load_dataclass_from_dict


def timed(fn, device: torch.device, trials: int) -> dict:
    """Median host ms and (on the card) CUDA-event ms of ``fn`` over trials."""
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    host, dev = [], []
    for _ in range(trials):
        sync()
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        fn()
        if cuda:
            end.record()
        sync()
        host.append((time.perf_counter() - t0) * 1e3)
        if cuda:
            dev.append(start.elapsed_time(end))
    return {"host": float(np.median(host)), "device": float(np.median(dev)) if dev else None}


def profile(example="unitree_go2_trot", device="cuda", trials=7, nsample=None) -> dict:
    device = require_device(device)
    with open(get_example_path(example + ".yaml")) as f:
        cfgd = yaml.safe_load(f)
    if nsample is not None:
        cfgd["Nsample"] = nsample
    cfg = load_dataclass_from_dict(DialConfig, cfgd)
    env_cfg = load_dataclass_from_dict(
        dial_envs.get_config(cfg.env_name), cfgd, convert_list_to_array=True, device=device
    )
    env = dial_envs.get_environment(cfg.env_name, env_cfg, device=device, dtype=torch.float32)
    planner = MBDPI(cfg, env, torch.Generator(device=device).manual_seed(cfg.seed))
    nd = cfg.Ndiffuse

    state = env.reset()
    Y = torch.zeros(cfg.Hnode + 1, planner.nu, device=device)
    state, Y, _ = planner.control_step(state, Y, cfg.Ndiffuse_init)
    state, Y, _ = planner.control_step(state, Y, nd)
    factor = planner.diffuse_factors(nd)[0]
    us = planner.node2u(planner.sample_nodes(Y, factor))
    batch = expand_state(state, cfg.Nsample + 1)

    t_full = timed(lambda: planner.control_step(state, Y, nd), device, trials)
    t_roll = timed(lambda: rollout_us(env.step, batch, us), device, trials)
    t_rev = timed(lambda: planner.reverse_once(state, Y, factor), device, trials)
    return {
        "example": example,
        "device": str(device),
        "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else None,
        "Nsample": cfg.Nsample,
        "Hsample": cfg.Hsample,
        "Ndiffuse": nd,
        "trials": trials,
        "control_step_ms": t_full,
        "rollouts_ms": t_roll,
        "reverse_once_ms": t_rev,
        "glue_per_level_host_ms": t_rev["host"] - t_roll["host"],
        "advance_and_shift_host_ms": t_full["host"] - nd * t_rev["host"],
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--example", type=str, default="unitree_go2_trot")
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu; there is no fallback")
    ap.add_argument("--trials", type=int, default=7)
    ap.add_argument("--nsample", type=int, default=None, help="Nsample in place of the YAML's")
    args = ap.parse_args(argv)
    print(json.dumps(profile(args.example, args.device, args.trials, args.nsample)), flush=True)


if __name__ == "__main__":
    main()
