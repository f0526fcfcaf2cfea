"""Environment + config registries.

One extension point for user plug-ins:

    from dial_mpc_tpu_torch.envs import register_env
    register_env("my_env", MyEnv, MyEnvConfig)
"""

from typing import Any, Dict

_envs: Dict[str, Any] = {}
_configs: Dict[str, Any] = {}


def register_env(name: str, env_class, config_class=None) -> None:
    _envs[name] = env_class
    if config_class is not None:
        _configs[name] = config_class


def register_config(name: str, config_class) -> None:
    _configs[name] = config_class


def get_config(name: str):
    if name not in _configs:
        raise ValueError(f"unknown env config {name!r}; known: {sorted(_configs)}")
    return _configs[name]


def get_env_class(name: str):
    if name not in _envs:
        raise ValueError(f"unknown env {name!r}; known: {sorted(_envs)}")
    return _envs[name]


def get_environment(name: str, config=None, device="cuda", dtype=None, engine="fused"):
    """Instantiate a registered environment on ``device`` (the card unless
    the caller asks for the CPU) with the given physics ``engine`` route."""
    cls = get_env_class(name)
    if config is None:
        config = get_config(name)()
    kw = {} if dtype is None else {"dtype": dtype}
    return cls(config, device=device, engine=engine, **kw)


# import side registers the built-in env families
from dial_mpc_tpu_torch.envs import unitree_go2_env as _go2  # noqa: E402,F401
from dial_mpc_tpu_torch.envs import unitree_h1_env as _h1  # noqa: E402,F401
from dial_mpc_tpu_torch.envs import manipulation as _manip  # noqa: E402,F401

__all__ = [
    "register_env",
    "register_config",
    "get_config",
    "get_env_class",
    "get_environment",
]
