"""Time the whole-step CUDA kernel alone, for comparing two checkouts on one card.

    PYTHONPATH=<checkout> python <this file> [--repeats N] [--lanes N] [--label TEXT]

Builds the step kernel of whichever ``dial_mpc_tpu_torch`` is first on the
path, settles the Go2 flat scene into contact at B = 2049 with the plain
physics on the CPU, and times 100 raw launches (CUDA events) ``--repeats``
times in float32 and float64, at B = 2049 and B = 1. It uses only what every
version of the package has (``engine_cuda.load_library``, the library's C
functions), so one copy of this file can time an older checkout: a library
that exports ``engine_sample_major`` takes (B, rows) arrays, an older one
(rows, B). ``--lanes`` builds a team size other than the package's default
(needs a package whose ``load_library`` takes ``lanes``); ``--iterations``
and ``--ls-iterations`` build a shorter solver schedule, so that differences
of times show what the Newton steps and the line search cost. Run it once per
checkout inside one call, in turns (a, b, b, a), and compare only within that
call. Prints one JSON line with the card's name and power limit, a hash of
each type's outputs at B = 2049 (two checkouts that compute the same bits
print the same hash) and, where ``cuobjdump`` is installed, a hash of the
library's machine code (its SASS instructions, without addresses' comments).
"""

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

from dial_mpc_tpu_torch.physics import engine_cuda, make_data, put_model, step
from dial_mpc_tpu_torch.physics.compiled_model import load_scene

B = 2049


def sass_hash(path):
    """A hash of the instructions cuobjdump prints for a library, or None."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", path], capture_output=True, text=True).stdout
    code = [line.split("/*")[1].split("*/")[1].strip() for line in sass.splitlines()
            if line.strip().startswith("/*") and line.count("*/") >= 1 and ";" in line]
    return hashlib.sha256("\n".join(code).encode()).hexdigest()[:16] if code else None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--label", type=str, default="")
    ap.add_argument("--lanes", type=int, default=0, help="team size to build (0: the package's own)")
    ap.add_argument("--iterations", type=int, default=None,
                    help="Newton iterations to build (default: the scene's); with --ls-iterations it "
                         "splits the step's time between the solve and the rest")
    ap.add_argument("--ls-iterations", type=int, default=None, help="line-search updates to build")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    mj = load_scene("unitree_go2", "mjx_scene_force.xml")
    mj.opt.timestep = 0.02
    rng = np.random.default_rng(0)
    cpu = put_model(mj, device="cpu", dtype=torch.float32)
    qpos = np.tile(np.asarray(mj.key_qpos[0], np.float64), (B, 1)) + rng.normal(0, 0.01, (B, mj.nq))
    qpos[:, 3:7] /= np.linalg.norm(qpos[:, 3:7], axis=1, keepdims=True)
    t = lambda a: torch.tensor(a, dtype=torch.float32)
    d = make_data(cpu, B).replace(qpos=t(qpos), qvel=t(rng.normal(0, 0.2, (B, mj.nv))))
    for _ in range(5):
        d = step(cpu, d.replace(ctrl=t(rng.uniform(-8.0, 8.0, (B, mj.nu)))))
    ctrl = t(rng.uniform(-8.0, 8.0, (B, mj.nu)))
    if args.iterations is not None:  # the kernel's schedule only; the states are the same
        mj.opt.iterations = args.iterations
    if args.ls_iterations is not None:
        mj.opt.ls_iterations = args.ls_iterations
    out = {"label": args.label, "B": B, "iterations": mj.opt.iterations,
           "ls_iterations": mj.opt.ls_iterations}
    for dtype in (torch.float32, torch.float64):
        model = put_model(mj, device="cuda", dtype=dtype)
        lib = engine_cuda.load_library(model, lanes=args.lanes) if args.lanes else engine_cuda.load_library(model)
        sample_major = hasattr(lib.lib, "engine_sample_major")
        stream = torch.cuda.current_stream().cuda_stream
        fn = lib.fn(dtype)
        name = str(dtype).split(".")[1]
        for batch in (B, 1):
            packed_in = torch.cat([d.qpos, d.qvel, ctrl], dim=1)[:batch].to("cuda", dtype)
            shape = (batch, lib.out_rows) if sample_major else (lib.out_rows, batch)
            packed_in = packed_in.contiguous() if sample_major else packed_in.t().contiguous()
            packed_out = torch.empty(shape, dtype=dtype, device="cuda")
            times = []
            for _ in range(args.repeats + 1):  # the first round warms up
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(100):
                    if fn(packed_in.data_ptr(), packed_out.data_ptr(), batch, 1, stream) != 0:
                        sys.exit("launch failed")
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end) / 100)
            if not torch.isfinite(packed_out).all():
                sys.exit("non-finite output")
            out[name + ("_kernel_ms" if batch == B else "_B1_kernel_ms")] = times[1:]
            if batch == B:  # outputs in the (B, rows) order whatever the layout
                rows_major = packed_out if sample_major else packed_out.t()
                out[name + "_output_sha256"] = hashlib.sha256(
                    rows_major.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]
        out["sample_major"] = sample_major
        out["lanes"] = getattr(lib, "lanes", 1)
        out["sass_sha256"] = sass_hash(lib.path)
    out["card"] = subprocess.run(
        "nvidia-smi --query-gpu=name,power.limit --format=csv,noheader",
        shell=True, capture_output=True, text=True,
    ).stdout.strip()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
