from dial_mpc_tpu_torch.config.base_env_config import BaseEnvConfig

__all__ = ["BaseEnvConfig"]
