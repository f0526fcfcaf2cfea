"""A compiled MuJoCo model as plain numpy arrays.

MuJoCo is this package's offline MJCF *compiler*: it parses the XML and
produces constants; it never runs in the hot path. ``snapshot`` copies the
constants the physics engine and the task environments read out of a
``mujoco.MjModel`` into a :class:`CompiledModel`, which has the same
attribute names and can be saved to and loaded from one ``.npz`` file. The
environments load their scene from such a file (``models/*.npz`` in this
package), so running them needs no ``mujoco`` installation; ``mujoco`` is
imported only to compile a scene again:

    python -m dial_mpc_tpu_torch.physics.compiled_model unitree_go2 mjx_scene_force.xml
"""

from __future__ import annotations

import os
import sys
import types

import numpy as np

from dial_mpc_tpu_torch.utils.io_utils import get_model_path

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
_MODELS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "models")


class CompiledModel:
    """Constants of one compiled scene, under ``mujoco.MjModel``'s names.

    ``opt`` is mutable (the environments set ``opt.timestep`` from their
    config). ``disable_bits`` maps a disable flag's name to its bit in
    ``opt.disableflags``, as the compiling MuJoCo version numbers them.
    ``source`` is the (robot, MJCF) pair a shipped scene was compiled from
    (``load_scene``), None otherwise.
    """

    def __init__(self, arrays: dict, opt: dict, disable_bits: dict, names: dict):
        for k, v in arrays.items():
            setattr(self, k, v)
        self.opt = types.SimpleNamespace(**opt)
        self.disable_bits = dict(disable_bits)
        self.names = {k: list(v) for k, v in names.items()}
        self.source = None

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

    def keyframe_ctrl(self, name: str) -> np.ndarray:
        return np.array(self.key_ctrl[self._id("key", name)])


def snapshot(mj) -> CompiledModel:
    """Copy a ``mujoco.MjModel``'s constants (a CompiledModel passes through)."""
    if isinstance(mj, CompiledModel):
        return mj
    import mujoco

    arrays = {k: int(getattr(mj, k)) for k in _SIZES}
    arrays.update({k: np.array(getattr(mj, k)) for k in _ARRAYS})
    opt = {}
    for k in _OPT:
        v = getattr(mj.opt, k)
        opt[k] = np.array(v) if isinstance(v, np.ndarray) else v
    bits = {
        n: int(getattr(mujoco.mjtDisableBit, f"mjDSBL_{n}").value) for n in _DISABLE_BITS
    }
    kinds = (
        ("body", mujoco.mjtObj.mjOBJ_BODY, mj.nbody),
        ("site", mujoco.mjtObj.mjOBJ_SITE, mj.nsite),
        ("geom", mujoco.mjtObj.mjOBJ_GEOM, mj.ngeom),
        ("key", mujoco.mjtObj.mjOBJ_KEY, mj.nkey),
    )
    names = {
        kind: [mujoco.mj_id2name(mj, obj.value, i) or "" for i in range(n)]
        for kind, obj, n in kinds
    }
    return CompiledModel(arrays, opt, bits, names)


def compile_mjcf(xml_path: str) -> CompiledModel:
    """Compile an MJCF file with MuJoCo (needs the ``mujoco`` package)."""
    import mujoco

    return snapshot(mujoco.MjModel.from_xml_path(str(xml_path)))


def save(cm: CompiledModel, path: str) -> None:
    flat = {k: np.asarray(getattr(cm, k)) for k in _SIZES + _ARRAYS}
    flat.update({f"opt.{k}": np.asarray(getattr(cm.opt, k)) for k in _OPT})
    flat.update({f"bit.{k}": np.asarray(v) for k, v in cm.disable_bits.items()})
    flat.update({f"names.{k}": np.asarray(v, dtype=str) for k, v in cm.names.items()})
    np.savez_compressed(path, **flat)


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


def compiled_path(robot_name: str, model_name: str) -> str:
    stem = os.path.splitext(model_name)[0]
    return os.path.join(_MODELS_DIR, f"{robot_name}__{stem}.npz")


def load_scene(robot_name: str, model_name: str) -> CompiledModel:
    """The compiled scene shipped with this package for an MJCF of the model suite."""
    path = compiled_path(robot_name, model_name)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} is missing; compile it with "
            f"python -m dial_mpc_tpu_torch.physics.compiled_model {robot_name} {model_name}"
        )
    cm = load(path)
    cm.source = (robot_name, model_name)
    return cm


def main(argv=None):
    robot_name, model_name = (argv or sys.argv[1:])[:2]
    os.makedirs(_MODELS_DIR, exist_ok=True)
    path = compiled_path(robot_name, model_name)
    save(compile_mjcf(get_model_path(robot_name, model_name)), path)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
