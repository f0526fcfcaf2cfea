"""The Allegro in-hand reorientation task's spin, over seeds and types.

    python -m dial_mpc_tpu_torch.tools.allegro_spin [--seeds 0 1 2 3] [--dtype float32|float64]
        [--nsample 2048] [--steps 50] [--device cuda]

Runs ``runner.run`` on the shipped ``allegro_reorient`` config (fused route)
once per seed and prints one JSON line a run: the ball's mean angular
velocity about its own z axis (``qvel[5]``, what the reference's behaviour
gate in tests/test_behavior.py reads), the same about the world's z axis,
how far the ball's z axis tilted, where the ball ended, the rollouts the
planner's guard dropped, and the run's mean reward. A closing line gives the
card's name and power limit.
"""

import argparse
import json
import shutil
import subprocess
import tempfile

import numpy as np
import torch
import yaml

from dial_mpc_tpu_torch.core import runner
from dial_mpc_tpu_torch.physics import maths
from dial_mpc_tpu_torch.utils.io_utils import get_example_path


def spin(states, nq):
    """Spin and tilt of the ball from the runner's state rows (step, qpos, qvel, ctrl)."""
    qpos, qvel = states[:, 1 : 1 + nq], states[:, 1 + nq :]
    R = maths.quat_to_mat(torch.tensor(qpos[:, 3:7], dtype=torch.float64))
    w_world = torch.einsum("tij,tj->ti", R, torch.tensor(qvel[:, 3:6], dtype=torch.float64))
    return dict(
        wz_mean=float(qvel[:, 5].mean()), world_wz_mean=float(w_world[:, 2].mean()),
        wz_abs_max=float(np.abs(qvel[:, 5]).max()),
        tilt_deg_max=float(torch.rad2deg(torch.arccos(R[:, 2, 2].clamp(-1.0, 1.0))).max()),
        ball_pos_final=[float(x) for x in qpos[-1, :3]],
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    ap.add_argument("--nsample", type=int, default=None, help="default: the config's")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    with open(get_example_path("allegro_reorient.yaml")) as f:
        base = yaml.safe_load(f)
    for seed in args.seeds:
        cfg = dict(base, seed=seed, n_steps=args.steps, output_dir=tempfile.mkdtemp(prefix="allegro_spin_"))
        if args.nsample is not None:
            cfg["Nsample"] = args.nsample
        summary = runner.run(cfg, progress=False, device=args.device, dtype=getattr(torch, args.dtype))
        states = np.load(summary["states_path"])
        shutil.rmtree(cfg["output_dir"])
        nq = summary["state"].pipeline_state.qpos.shape[1]
        nv = summary["state"].pipeline_state.qvel.shape[1]
        print(json.dumps(dict(
            seed=seed, dtype=args.dtype, Nsample=cfg["Nsample"], n_steps=args.steps,
            **spin(states[:, : 1 + nq + nv], nq), rollouts_dropped=int(sum(summary["rollouts_dropped"])),
            mean_reward=summary["mean_reward"],
        )), flush=True)
    smi = subprocess.run("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader", shell=True,
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)


if __name__ == "__main__":
    main()
