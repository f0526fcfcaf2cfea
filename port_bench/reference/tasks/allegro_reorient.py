"""The Allegro hand's in-hand reorientation (``allegro_reorient``): a frozen
copy of the port's task environment on the plain reference physics."""

from __future__ import annotations

import math

import torch

from port_bench.reference.model import Data
from port_bench.reference.task import BaseTask, State


class Task(BaseTask):
    """Spin the ball about z: 16 position servos, targets offset from the
    keyframe pose."""

    scene_file = "wonik_allegro__scene_left.npz"

    def __init__(self, config: dict, device, dtype):
        super().__init__(config, device, dtype)
        self.obj = self.cm.body_id("object") - 1
        self.init_q = self.tensor(self.cm.keyframe_qpos("in_hand_reorient"))

    def reset_info(self) -> dict:
        return {
            "ang_vel_tar": self.tensor([[0.0, 0.0, 0.5]]),
            "pos_tar": self.tensor([[0.0, 0.0, 0.13]]),
            "step": torch.zeros(1, dtype=torch.int32, device=self.device),
        }

    def act2joint(self, act: torch.Tensor) -> torch.Tensor:
        act_normalized = (act * self.action_scale + 1.0) / 2.0
        joint_targets = (
            self.joint_range[:, 0]
            + self.init_q[7:]
            + act_normalized * (self.joint_range[:, 1] - self.joint_range[:, 0])
        )
        return torch.clamp(joint_targets, self.physical_joint_range[:, 0], self.physical_joint_range[:, 1])

    def ctrl(self, state: State, action: torch.Tensor) -> torch.Tensor:
        return self.act2joint(action)

    def reward(self, state: State, d: Data, ctrl: torch.Tensor) -> torch.Tensor:
        """The reward of the step from ``state`` to the physics products ``d``."""
        # the pi/180 factor on the angular velocity is part of the task
        ball_ang_vel = d.xd_ang[:, self.obj] * math.pi / 180.0
        ball_pos = d.x_pos[:, self.obj]
        reward_ang_vel = -((ball_ang_vel - state.info["ang_vel_tar"]) ** 2).sum(-1)
        reward_pos = -((ball_pos - state.info["pos_tar"]) ** 2).sum(-1)
        reward_joint = -((d.qpos[:, 7:] - self.init_q[7:]) ** 2).sum(-1)
        return reward_ang_vel * 1.0 + reward_pos * 5.0 + reward_joint * 0.1
