"""A compiled scene's constants, loaded from its ``.npz`` file.

The scenes of the benchmark's configurations are kept beside this file
(``scenes/``, one file each, named by its task), frozen: a copy of the
compiled MuJoCo scenes the port ships, so a later change of the port's
scene files shows as a disagreement.
Attribute names are ``mujoco.MjModel``'s.
"""

from __future__ import annotations

import os
import types

import numpy as np

_SIZES = ("nq", "nv", "nu", "nbody", "njnt", "ngeom", "nsite", "nkey")
_OPT = (
    "timestep", "gravity", "impratio", "iterations", "ls_iterations", "integrator",
    "cone", "disableflags", "tolerance", "ls_tolerance",
)
_ARRAYS = (
    "qpos0", "key_qpos", "key_ctrl",
    "body_parentid", "body_rootid", "body_weldid", "body_jntadr", "body_jntnum",
    "body_dofadr", "body_dofnum", "body_pos", "body_quat", "body_ipos", "body_iquat",
    "body_mass", "body_inertia", "body_invweight0", "body_subtreemass",
    "jnt_type", "jnt_qposadr", "jnt_dofadr", "jnt_bodyid", "jnt_limited", "jnt_pos",
    "jnt_axis", "jnt_range", "jnt_solref", "jnt_solimp", "jnt_margin",
    "dof_parentid", "dof_bodyid", "dof_jntid", "dof_armature", "dof_damping",
    "dof_invweight0", "dof_frictionloss", "dof_solref", "dof_solimp",
    "geom_type", "geom_contype", "geom_conaffinity", "geom_condim", "geom_priority",
    "geom_bodyid", "geom_friction", "geom_solref", "geom_solimp", "geom_solmix",
    "geom_margin", "geom_gap", "geom_pos", "geom_quat", "geom_size",
    "site_pos", "site_quat", "site_bodyid",
    "actuator_trnid", "actuator_biastype", "actuator_gear", "actuator_gainprm",
    "actuator_biasprm", "actuator_ctrlrange", "actuator_ctrllimited",
    "actuator_forcerange", "actuator_forcelimited",
)
_DISABLE_BITS = ("EULERDAMP", "CONTACT", "LIMIT", "GRAVITY")
_NAME_KINDS = ("body", "site", "key", "geom")
SCENES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scenes")


class CompiledModel:
    """Constants of one compiled scene. ``opt`` is mutable: a task sets
    ``opt.timestep`` from its configuration."""

    def __init__(self, arrays: dict, opt: dict, disable_bits: dict, names: dict):
        for k, v in arrays.items():
            setattr(self, k, v)
        self.opt = types.SimpleNamespace(**opt)
        self.disable_bits = dict(disable_bits)
        self.names = {k: list(v) for k, v in names.items()}

    def disabled(self, flag: str) -> bool:
        return bool(int(self.opt.disableflags) & self.disable_bits[flag])

    def _id(self, kind: str, name: str) -> int:
        if name not in self.names[kind]:
            raise KeyError(f"no {kind} named {name!r} in the compiled model")
        return self.names[kind].index(name)

    def body_id(self, name: str) -> int:
        return self._id("body", name)

    def site_id(self, name: str) -> int:
        return self._id("site", name)

    def geom_id(self, name: str) -> int:
        return self._id("geom", name)

    def keyframe_qpos(self, name: str) -> np.ndarray:
        return np.array(self.key_qpos[self._id("key", name)])


def load(path: str) -> CompiledModel:
    with np.load(path) as z:
        arrays = {k: int(z[k]) for k in _SIZES}
        arrays.update({k: z[k] for k in _ARRAYS})
        opt = {}
        for k in _OPT:
            v = z[f"opt.{k}"]
            opt[k] = v if v.ndim else v.item()
        bits = {k: int(z[f"bit.{k}"]) for k in _DISABLE_BITS}
        names = {k: [str(s) for s in z[f"names.{k}"]] for k in _NAME_KINDS}
    return CompiledModel(arrays, opt, bits, names)


def load_scene(file_name: str) -> CompiledModel:
    """A scene of ``scenes/`` by its file name."""
    return load(os.path.join(SCENES_DIR, file_name))
