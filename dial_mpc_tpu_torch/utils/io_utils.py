"""Resource paths and YAML->dataclass loading.

Models (MJCF + meshes) and example YAMLs are data shared with the JAX
package: they are resolved by filesystem path inside its directory and are
never duplicated or imported.
"""

from __future__ import annotations

import os

import torch

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
_DATA_ROOT = os.path.join(_REPO_ROOT, "dial_mpc_tpu")


def get_model_path(robot_name: str, model_name: str) -> str:
    return os.path.join(_DATA_ROOT, "models", robot_name, model_name)


def get_example_path(example_name: str) -> str:
    return os.path.join(_DATA_ROOT, "examples", example_name)


def load_dataclass_from_dict(
    dataclass, data_dict, convert_list_to_array=False, device="cpu",
    dtype=torch.float32,
):
    """Intersect dict keys with dataclass fields (flat-YAML union configs).

    With ``convert_list_to_array`` list values become tensors on ``device``.
    """
    keys = dataclass.__dataclass_fields__.keys() & data_dict.keys()
    kwargs = {key: data_dict[key] for key in keys}
    if convert_list_to_array:
        for key, value in kwargs.items():
            if isinstance(value, list):
                kwargs[key] = torch.tensor(value, dtype=dtype, device=device)
    return dataclass(**kwargs)
