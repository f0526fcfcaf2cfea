"""Bring another implementation's Model / Data / Efc / State leaves into this one.

The inputs are plain dictionaries of numpy arrays (and Python scalars and
tuples for static fields) under the field names of ``physics.model.Model``,
``physics.model.Data``, ``physics.constraint.Efc`` and ``envs.base_env.State``. Tests use these to check
``put_model`` field by field and to start two implementations from the same
state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dial_mpc_tpu_torch.envs.base_env import State
from dial_mpc_tpu_torch.physics.constraint import Efc
from dial_mpc_tpu_torch.physics.model import Contact, Data, Model, Option

_INT_FIELDS = {"geom_bodyid", "site_bodyid", "actuator_dofadr", "con_geom", "con_dim", "geom", "dim"}


def _tensor(name, value, device, dtype):
    a = np.asarray(value)
    if name in _INT_FIELDS or a.dtype.kind in "iu":
        return torch.tensor(a.astype(np.int64), dtype=torch.int32, device=device)
    if a.dtype.kind == "b":
        return torch.tensor(a, dtype=torch.bool, device=device)
    return torch.tensor(a.astype(np.float64), dtype=dtype, device=device)


def _fields(cls, leaves: dict, device, dtype, skip=()):
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name in skip or f.name not in leaves or leaves[f.name] is None:
            continue
        v = leaves[f.name]
        if isinstance(v, (np.ndarray, np.generic)):
            kw[f.name] = _tensor(f.name, v, device, dtype)
        else:
            kw[f.name] = v
    return kw


def model_from_numpy(leaves: dict, device="cpu", dtype=torch.float32, disable_bits=None) -> Model:
    """A Model from a dict of its fields; ``opt`` is a nested dict.

    ``disable_bits`` maps EULERDAMP / CONTACT / LIMIT to their bits in
    ``opt.disableflags``; by default they are read from the installed
    ``mujoco`` package.
    """
    if disable_bits is None:
        import mujoco

        disable_bits = {
            n: int(getattr(mujoco.mjtDisableBit, f"mjDSBL_{n}").value)
            for n in ("EULERDAMP", "CONTACT", "LIMIT")
        }
    opt_kw = _fields(Option, leaves["opt"], device, dtype)
    flags = int(opt_kw["disableflags"])
    opt_kw.update(
        disable_eulerdamp=bool(flags & disable_bits["EULERDAMP"]),
        disable_contact=bool(flags & disable_bits["CONTACT"]),
        disable_limit=bool(flags & disable_bits["LIMIT"]),
    )
    return Model(opt=Option(**opt_kw), **_fields(Model, leaves, device, dtype, skip=("opt",)))


def efc_from_numpy(leaves: dict, device="cpu", dtype=torch.float32, batched=True) -> Efc:
    """Constraint rows (J, D, aref, pos, frictionloss, eta) from a dict of
    arrays, so that the same rows can go through two solvers. With
    ``batched=False`` the leaves describe one sample."""
    kw = _fields(Efc, leaves, device, dtype)
    return Efc(**{k: v if batched else v[None] for k, v in kw.items()})


def data_from_numpy(leaves: dict, device="cpu", dtype=torch.float32, batched=True) -> Data:
    """A Data from a dict of its fields. With ``batched=False`` the leaves
    describe one sample and get a leading batch axis of one."""

    def lift(t):
        return t if batched else t[None]

    kw = {
        k: lift(v) if isinstance(v, torch.Tensor) else v
        for k, v in _fields(Data, leaves, device, dtype, skip=("contact", "efc")).items()
    }
    contact = leaves.get("contact")
    if contact is not None:
        ckw = _fields(Contact, contact, device, dtype)
        for name in ("dist", "pos", "frame"):
            ckw[name] = lift(ckw[name]) if ckw.get(name) is not None else None
        kw["contact"] = Contact(**ckw)
    if leaves.get("efc") is not None:
        kw["efc"] = efc_from_numpy(leaves["efc"], device, dtype, batched)
    return Data(**kw)


def state_from_numpy(leaves: dict, device="cpu", dtype=torch.float32, batched=True) -> State:
    """A State from a dict with keys pipeline_state, obs, reward, done, info.

    Info entries that are arrays become tensors (integer and boolean arrays
    keep their kind); other entries are kept; a reference's ``rng`` entry is
    dropped, since this package draws from a ``torch.Generator``.
    """

    def leaf(name, v):
        if isinstance(v, (np.ndarray, np.generic)):
            t = _tensor(name, v, device, dtype)
            return t if batched else t[None]
        return v

    info = {k: leaf(k, v) for k, v in leaves.get("info", {}).items() if k != "rng"}
    return State(
        pipeline_state=data_from_numpy(leaves["pipeline_state"], device, dtype, batched),
        obs=leaf("obs", np.asarray(leaves["obs"])),
        reward=leaf("reward", np.asarray(leaves["reward"])),
        done=leaf("done", np.asarray(leaves["done"])),
        metrics={},
        info=info,
    )
