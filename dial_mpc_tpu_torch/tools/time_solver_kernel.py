"""Time the standalone Newton-solve CUDA kernel alone, for comparing two checkouts on one card.

    PYTHONPATH=<checkout> python <this file> [--repeats N] [--label TEXT]

Builds the solver kernel of whichever ``dial_mpc_tpu_torch`` is first on the
path for the Go2 flat scene's key, makes that scene's constraint rows at
B = 2049 with the plain physics on the CPU (states settled into contact), and
times 100 raw launches (CUDA events) ``--repeats`` times in float32 and
float64, at B = 2049 and B = 1. It uses only what every version of the
package has (``solver_cuda.solver_key``, ``load_library``, the library's C
functions), so one copy of this file can time an older checkout: a library
that exports ``solver_sample_major`` takes the seven (B, ...) inputs and two
(B, nv) outputs as they are, an older one one packed (rows, B) input and one
(2 nv, B) output. Run it once per checkout inside one call, in turns
(a, b, b, a), and compare only within that call. Prints one JSON line with the
card's name and power limit and, for a sample-major library, a hash of each
type's outputs at B = 2049 (two checkouts that compute the same bits print
the same hash).
"""

import argparse
import hashlib
import json
import subprocess
import sys

import numpy as np
import torch

from dial_mpc_tpu_torch.physics import forward, make_data, put_model, solver, solver_cuda, step
from dial_mpc_tpu_torch.physics.compiled_model import load_scene

B = 2049


def go2_rows():
    """The solver's seven inputs (float64, CPU) at settled Go2 states."""
    mj = load_scene("unitree_go2", "mjx_scene_force.xml")
    mj.opt.timestep = 0.02
    rng = np.random.default_rng(0)
    cpu = put_model(mj, device="cpu", dtype=torch.float64)
    qpos = np.tile(np.asarray(mj.key_qpos[0], np.float64), (B, 1)) + rng.normal(0, 0.01, (B, mj.nq))
    qpos[:, 3:7] /= np.linalg.norm(qpos[:, 3:7], axis=1, keepdims=True)
    t = torch.tensor
    d = make_data(cpu, B).replace(qpos=t(qpos), qvel=t(rng.normal(0, 0.2, (B, mj.nv))))
    for _ in range(5):
        d = step(cpu, d.replace(ctrl=t(rng.uniform(-8.0, 8.0, (B, mj.nu)))), solver.solve_reference)
    d = forward(cpu, d.replace(ctrl=t(rng.uniform(-8.0, 8.0, (B, mj.nu)))), solver.solve_reference)
    e = d.efc
    return mj, [a.contiguous() for a in (e.J, e.D, e.aref, e.frictionloss, e.eta, d.qM, d.qacc_smooth)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--label", type=str, default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    mj, rows = go2_rows()
    out = {"label": args.label, "B": B}
    for dtype in (torch.float32, torch.float64):
        model = put_model(mj, device="cuda", dtype=dtype)
        key = solver_cuda.solver_key(model, rows[0].shape[1])
        lib = solver_cuda.load_library(key)
        sample_major = hasattr(lib.lib, "solver_sample_major")
        stream = torch.cuda.current_stream().cuda_stream
        fn = lib.fn(dtype)
        name = str(dtype).split(".")[1]
        nv = key[0]
        for batch in (B, 1):
            J, D, aref, fl, eta, M, qs = [a[:batch].to("cuda", dtype).contiguous() for a in rows]
            if sample_major:
                outs = [torch.empty((batch, nv), dtype=dtype, device="cuda") for _ in range(2)]
                ptrs = [t.data_ptr() for t in (J, M, D, aref, fl, eta, qs, *outs)]
            else:
                packed_in = solver_cuda.pack_inputs(J, D, aref, fl, eta, M, qs)
                outs = [torch.empty((2 * nv, batch), dtype=dtype, device="cuda")]
                ptrs = [packed_in.data_ptr(), outs[0].data_ptr()]
            times = []
            for _ in range(args.repeats + 1):  # the first round warms up
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(100):
                    if fn(*ptrs, batch, stream) != 0:
                        sys.exit("launch failed")
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end) / 100)
            if not all(torch.isfinite(t).all() for t in outs):
                sys.exit("non-finite output")
            out[name + ("_kernel_ms" if batch == B else "_B1_kernel_ms")] = times[1:]
            if batch == B and sample_major:  # two checkouts that compute the same bits print the same hash
                out[name + "_output_sha256"] = hashlib.sha256(
                    b"".join(t.cpu().numpy().tobytes() for t in outs)).hexdigest()[:16]
        out["sample_major"] = sample_major
        out["lanes"] = getattr(lib, "lanes", 1)
    out["card"] = subprocess.run(
        "nvidia-smi --query-gpu=name,power.limit --format=csv,noheader",
        shell=True, capture_output=True, text=True,
    ).stdout.strip()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
