"""Allegro-hand in-hand reorientation task: spin the ball about z.

16 position-servo finger joints whose targets are offsets from the keyframe
pose; a fixed 100-step episode; torque control is not supported. The scene
(``wonik_allegro/scene_left.xml``) runs elliptic cones (impratio 10),
condim-6 fingertip contacts and implicit joint damping (eulerdamp).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Union

import torch

from dial_mpc_tpu_torch.config.base_env_config import BaseEnvConfig
from dial_mpc_tpu_torch.envs import register_env
from dial_mpc_tpu_torch.envs.base_env import BaseEnv, State
from dial_mpc_tpu_torch.physics.compiled_model import load_scene


@dataclass
class AllegroReorientEnvConfig(BaseEnvConfig):
    kp: Union[float, torch.Tensor] = 1.0
    kd: Union[float, torch.Tensor] = 0.1


class AllegroReorientEnv(BaseEnv):
    def __init__(self, config: AllegroReorientEnvConfig, device="cuda", dtype=torch.float32,
                 engine="fused"):
        super().__init__(config, device=device, dtype=dtype, engine=engine)
        self._object_body_idx = self.mj_model.body_id("object")
        self._init_q = self._tensor(self.mj_model.keyframe_qpos("in_hand_reorient"))

    def make_system(self, config: AllegroReorientEnvConfig):
        mj_model = load_scene("wonik_allegro", "scene_left.xml")
        mj_model.opt.timestep = config.timestep
        return mj_model

    def reset(self, generator: torch.Generator = None) -> State:
        """The B = 1 start state at the keyframe, at rest."""
        pipeline_state = self.pipeline_init(
            self._init_q[None], torch.zeros(1, self._nv, device=self.device, dtype=self.dtype)
        )
        z = lambda *shape: torch.zeros(1, *shape, device=self.device, dtype=self.dtype)
        state_info = {
            "ang_vel_tar": self._tensor([[0.0, 0.0, 0.5]]),
            "pos_tar": self._tensor([[0.0, 0.0, 0.13]]),
            "step": torch.zeros(1, dtype=torch.int32, device=self.device),
        }
        return State(pipeline_state, z(1), z(), z(), {}, state_info)

    def step(self, state: State, action: torch.Tensor, pipeline_next=None) -> State:
        if self._config.leg_control != "position":
            raise NotImplementedError("Allegro supports position control only")
        ctrl = self.act2joint(action)
        pipeline_state = self.advance(state, ctrl, pipeline_next)

        obj = self._object_body_idx - 1
        # the pi/180 factor on the angular velocity is part of the task
        # definition, as the reference writes it
        ball_ang_vel = pipeline_state.xd_ang[:, obj] * math.pi / 180.0
        ball_pos = pipeline_state.x_pos[:, obj]
        reward_ang_vel = -((ball_ang_vel - state.info["ang_vel_tar"]) ** 2).sum(-1)
        reward_pos = -((ball_pos - state.info["pos_tar"]) ** 2).sum(-1)
        reward_joint_angle_deviation = -((pipeline_state.qpos[:, 7:] - self._init_q[7:]) ** 2).sum(-1)
        reward = reward_ang_vel * 1.0 + reward_pos * 5.0 + reward_joint_angle_deviation * 0.1

        # one value a sample on reset and step alike (the reference's note:
        # its upstream returned a different shape from step than from reset)
        done = (state.info["step"] >= 100).to(self.dtype)
        info = dict(state.info)
        info["step"] = state.info["step"] + 1
        return State(pipeline_state, state.obs, reward, done, {}, info)

    def act2joint(self, act: torch.Tensor) -> torch.Tensor:
        """Offsets from the keyframe pose rather than absolute targets."""
        act_normalized = (act * self._config.action_scale + 1.0) / 2.0
        joint_targets = (
            self.joint_range[:, 0]
            + self._init_q[7:]
            + act_normalized * (self.joint_range[:, 1] - self.joint_range[:, 0])
        )
        return torch.clamp(
            joint_targets, self.physical_joint_range[:, 0], self.physical_joint_range[:, 1]
        )


register_env("allegro_reorient", AllegroReorientEnv, AllegroReorientEnvConfig)
