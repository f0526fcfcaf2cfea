"""The task scenes and seeded start poses that put each of them in contact.

The CPU tests and ``chip_smoke.py`` both hold the physics (plain and kernel)
to these batches: the keyframe with noise, the H1 standing 1 cm into the floor,
the Go2 on the crate's top and against its side, the H1's crate slid into the
robot, the Allegro hand's ball in its fingertips or on the floor and its
fingers curled into each other, so that every pair kind of a scene that can
touch is in contact somewhere in a batch.
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
    "allegro": ("wonik_allegro", "scene_left.xml"),
}
# the physics step each scene's task runs (dt / n_frames of its example)
TIMESTEP = {"allegro": 0.005}


def start_qpos(name: str, cm: CompiledModel, batch: int, rng: np.random.Generator) -> np.ndarray:
    """(batch, nq) start poses of scene ``name``: the keyframe with noise.

    The H1 stands 1 cm into the floor. On the Go2 crate scene even samples
    stand on the crate's top and odd ones press the base into its side (base
    box into the crate, head spheres and calves inside it). On the H1 push
    crate scene the crate slides 0.1-0.4 m toward the robot, into its hands,
    knees and torso.
    On the Allegro scene (the hand fixed, its ball on a free joint), samples
    go round four poses: the ball lowered 0.8-1.5 cm onto the fingertips
    (sphere-capsule, condim 6), the ball dropped on the floor (plane-sphere,
    condim 6), the fingers curled to 0.67 of their range (fingertips into
    each other: capsule-capsule; curled to 0.7 some of them diverge within a
    few steps, the stiff contact on the light fingers at 0.005 s), and the
    keyframe. The fingertips cannot
    reach the floor, so the plane-capsule pairs stay apart.
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
    elif name == "allegro":
        into, floor, curl = (np.arange(batch) % 4 == k for k in range(3))
        qpos[into, 0:2] += rng.uniform(-0.01, 0.01, (into.sum(), 2))
        qpos[into, 2] -= rng.uniform(0.008, 0.015, into.sum())
        ball = int(np.flatnonzero(cm.geom_bodyid == cm.body_id("object"))[0])
        rest = cm.geom_pos[cm.geom_id("floor")][2] + cm.geom_size[ball][0]
        qpos[floor, 2] = rest - rng.uniform(0.001, 0.004, floor.sum())
        lo, hi = cm.jnt_range[1:, 0], cm.jnt_range[1:, 1]
        frac = np.full(16, 0.67)
        frac[0::4] = 0.3  # each finger's first joint spreads it
        qpos[curl, 7:] = lo + frac * (hi - lo) + rng.normal(0, 0.01, (curl.sum(), 16))
    if name.startswith("h1"):
        qpos[:, 2] -= 0.01
    qpos[:, 3:7] /= np.linalg.norm(qpos[:, 3:7], axis=1, keepdims=True)
    return qpos


def start_qvel(name: str, cm: CompiledModel, batch: int, rng: np.random.Generator) -> np.ndarray:
    """(batch, nv) start velocities: normal with 0.2 spread. On the Allegro
    scene the balls dropped on the floor start still (pressed in with no
    slip: the elliptic cone's bottom zone) or, every other one, rising at
    0.3 m/s out of the floor (separating: its top zone)."""
    qvel = rng.normal(0, 0.2, (batch, cm.nv))
    if name == "allegro":
        floor = np.flatnonzero(np.arange(batch) % 4 == 1)
        qvel[floor, :6] = 0.0
        qvel[floor[1::2], 2] = 0.3
    return qvel


def box_slots(pair_table) -> list:
    """Contact slots of the pairs that hold a box."""
    return [s for (g1, g2, t1, t2, _, adr, n) in pair_table if BOX in (t1, t2) for s in range(adr, adr + n)]
