"""The legged scenes and seeded start poses that put each of them in contact.

The CPU tests and ``chip_smoke.py`` both hold the physics (plain and kernel)
to these batches: the keyframe with noise, the H1 standing 1 cm into the floor,
the Go2 on the crate's top and against its side, the H1's crate slid into the
robot, so that every pair kind of a scene is in contact somewhere in a batch.
"""

from __future__ import annotations

import numpy as np

from dial_mpc_tpu_torch.physics.compiled_model import CompiledModel
from dial_mpc_tpu_torch.physics.model import BOX

# name -> (robot, MJCF) of the compiled scenes of the legged tasks
SCENES = {
    "go2": ("unitree_go2", "mjx_scene_force.xml"),
    "h1_walk": ("unitree_h1", "mjx_scene_h1_walk.xml"),
    "h1_loco": ("unitree_h1", "mjx_scene_h1_loco.xml"),
    "go2_crate": ("unitree_go2", "mjx_scene_force_crate.xml"),
    "h1_push_crate": ("unitree_h1", "mjx_scene_h1_push_crate.xml"),
}


def start_qpos(name: str, cm: CompiledModel, batch: int, rng: np.random.Generator) -> np.ndarray:
    """(batch, nq) start poses of scene ``name``: the keyframe with noise.

    The H1 stands 1 cm into the floor. On the Go2 crate scene even samples
    stand on the crate's top and odd ones press the base into its side (base
    box into the crate, head spheres and calves inside it). On the H1 push
    crate scene the crate slides 0.1-0.4 m toward the robot, into its hands,
    knees and torso.
    """
    qpos = np.tile(np.asarray(cm.key_qpos[0], np.float64), (batch, 1))
    qpos += rng.normal(0, 0.01, qpos.shape)
    if name == "go2_crate":
        g = cm.geom_id("static_box")
        centre = cm.body_pos[cm.geom_bodyid[g]] + cm.geom_pos[g]  # a body welded to the world
        half = cm.geom_size[g]
        qpos[0::2, 0] += centre[0]
        qpos[0::2, 2] += centre[2] + half[2] - 0.005
        qpos[1::2, 0] += centre[0] - half[0] - 0.1
    elif name == "h1_push_crate":
        qpos[:, -1] -= rng.uniform(0.1, 0.4, batch)
    if name.startswith("h1"):
        qpos[:, 2] -= 0.01
    qpos[:, 3:7] /= np.linalg.norm(qpos[:, 3:7], axis=1, keepdims=True)
    return qpos


def box_slots(pair_table) -> list:
    """Contact slots of the pairs that hold a box."""
    return [s for (g1, g2, t1, t2, _, adr, n) in pair_table if BOX in (t1, t2) for s in range(adr, adr + n)]
