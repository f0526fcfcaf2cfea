"""DIAL-MPC planner hyperparameters (field-compatible with the shipped YAMLs)."""

from dataclasses import dataclass


@dataclass
class DialConfig:
    # exp
    seed: int = 0
    output_dir: str = "output"
    n_steps: int = 100
    # env
    env_name: str = "unitree_h1_walk"
    # diffusion
    Nsample: int = 2048  # number of sampled trajectories per level
    Hsample: int = 16  # dense control horizon
    Hnode: int = 4  # spline node count (decision variables = Hnode+1)
    Ndiffuse: int = 2  # annealing levels per control step
    Ndiffuse_init: int = 10  # annealing levels for the first step
    temp_sample: float = 0.06  # softmax temperature
    horizon_diffuse_factor: float = 0.9  # per-node noise ramp across horizon
    traj_diffuse_factor: float = 0.5  # per-level noise decay
    update_method: str = "mppi"
    sigma_scale: float = 1.0
