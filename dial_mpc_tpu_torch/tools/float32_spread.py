"""How far float32 rounding alone moves the step's accelerations, per sample.

    python -m dial_mpc_tpu_torch.tools.float32_spread allegro [--stride 4] [--device cpu]

Makes ``chip_smoke.py``'s seeded batches of a scene (``tools/float_checks.py``:
the settled states, and three steps on, at the joint limits), rounds them to
float32, and prints for each batch one JSON line: the range of the float64
plain version's qacc, and the samples where the float32 plain version departs
most from it, run on the whole batch and run on each sample alone (every
``--stride``-th sample; the order of the sums differs), with the float64
plain version's own movement when its inputs move by one float32 rounding
(2^-24 relative, random signs, four draws). These readings set the float32
limits of ``tools/float_checks.py``.
"""

import argparse
import json

import numpy as np
import torch

from dial_mpc_tpu_torch.physics import engine_cuda, put_model
from dial_mpc_tpu_torch.physics.compiled_model import load_scene
from dial_mpc_tpu_torch.tools.float_checks import contact_rich_batch
from dial_mpc_tpu_torch.tools.scene_cases import SCENES, TIMESTEP

QACC = engine_cuda.OUTPUT_NAMES.index("qacc")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("key", choices=sorted(SCENES))
    ap.add_argument("--stride", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2049)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    cm = load_scene(*SCENES[args.key])
    cm.opt.timestep = TIMESTEP.get(args.key, 0.02)
    m64 = put_model(cm, device=args.device, dtype=torch.float64)
    m32 = put_model(cm, device=args.device, dtype=torch.float32)
    q, v, c = contact_rich_batch(args.key, cm, m64, args.batch)
    lim = engine_cuda.step_core_reference(m64, q, v, c, 3)
    gen = torch.Generator(device=args.device).manual_seed(0)
    for name, (qb, vb) in (("settled", (q, v)), ("at_limits", (lim[0], lim[1]))):
        q32, v32, c32 = qb.float(), vb.float(), c.float()
        ref = engine_cuda.step_core_reference(m64, q32.double(), v32.double(), c32.double(), 1)[QACC]
        batched = (engine_cuda.step_core_reference(m32, q32, v32, c32, 1)[QACC].double() - ref).abs().max(1).values
        idx = list(range(0, args.batch, args.stride))
        alone = torch.tensor([
            float((engine_cuda.step_core_reference(m32, q32[i : i + 1], v32[i : i + 1], c32[i : i + 1], 1)[QACC]
                   .double() - ref[i : i + 1]).abs().max())
            for i in idx
        ])
        sens = torch.zeros_like(batched)
        for _ in range(4):
            def jig(a):
                sign = 2 * torch.randint(0, 2, a.shape, generator=gen, device=a.device) - 1
                return a.double() * (1 + 2.0 ** -24 * sign)
            moved = engine_cuda.step_core_reference(m64, jig(q32), jig(v32), jig(c32), 1)[QACC]
            sens = torch.maximum(sens, (moved - ref).abs().max(1).values)
        top_b = batched.argsort(descending=True)[:8].tolist()
        top_a = alone.argsort(descending=True)[:8].tolist()
        print(json.dumps(dict(
            key=args.key, batch=name, qacc_range=float(ref.max() - ref.min()),
            batched_worst=[(i, float(batched[i]), float(sens[i])) for i in top_b],
            alone_worst=[(idx[j], float(alone[j]), float(batched[idx[j]]), float(sens[idx[j]])) for j in top_a],
            note="(sample, float32 departure, [batched departure,] float64 movement under one float32 rounding)",
        )), flush=True)


if __name__ == "__main__":
    main()
