"""Environment hyperparameter dataclass.

Field-compatible with the shipped flat YAML configs. ``backend`` is accepted
for compatibility but ignored: the only backend is this package's own
physics engine.
"""

from dataclasses import dataclass


@dataclass
class BaseEnvConfig:
    task_name: str = "default"
    randomize_tasks: bool = False
    kp: float = 30.0  # P gain, scalar or per-joint list
    kd: float = 1.0  # D gain, scalar or per-joint list
    debug: bool = False
    dt: float = 0.02  # environment control step
    timestep: float = 0.02  # underlying simulator step
    backend: str = "mjx"  # accepted for config compatibility; unused
    leg_control: str = "torque"  # "torque" or "position"
    action_scale: float = 1.0
