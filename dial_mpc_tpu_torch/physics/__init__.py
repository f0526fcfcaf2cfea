"""MuJoCo-semantics rigid-body physics on batch-first tensors."""

from dial_mpc_tpu_torch.physics.forward import forward, step
from dial_mpc_tpu_torch.physics.model import Contact, Data, Model, Option, make_data, put_model

__all__ = [
    "Contact",
    "Data",
    "Model",
    "Option",
    "forward",
    "make_data",
    "put_model",
    "step",
]
