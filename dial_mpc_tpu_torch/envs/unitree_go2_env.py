"""Unitree Go2 quadruped: velocity-tracking walk with gait shaping, staged
contact-target jumping on the same flat scene, and climbing onto a crate.

The reward stack runs inside the batched rollout hot loop, so every term is
elementwise work on the already-computed physics products (site_xpos, x/xd
views), on (B, ...) tensors, with no host round trips.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Union

import numpy as np
import torch

from dial_mpc_tpu_torch.config.base_env_config import BaseEnvConfig
from dial_mpc_tpu_torch.envs import register_env
from dial_mpc_tpu_torch.envs.base_env import BaseEnv, State
from dial_mpc_tpu_torch.physics import maths
from dial_mpc_tpu_torch.physics.compiled_model import load_scene
from dial_mpc_tpu_torch.utils.function_utils import get_foot_step, global_to_body_velocity


@dataclass
class UnitreeGo2EnvConfig(BaseEnvConfig):
    kp: Union[float, torch.Tensor] = 30.0
    kd: Union[float, torch.Tensor] = 0.0
    default_vx: float = 1.0
    default_vy: float = 0.0
    default_vyaw: float = 0.0
    ramp_up_time: float = 2.0
    gait: str = "trot"


# gait tables: per-leg phase offsets, and (duty_ratio, cadence, amplitude)
GAIT_PHASES = {
    "stand": (0.0, 0.0, 0.0, 0.0),
    "walk": (0.0, 0.5, 0.75, 0.25),
    "trot": (0.0, 0.5, 0.5, 0.0),
    "canter": (0.0, 0.33, 0.33, 0.66),
    "gallop": (0.0, 0.05, 0.4, 0.35),
}
GAIT_PARAMS = {
    "stand": (1.0, 1.0, 0.0),
    "walk": (0.75, 1.0, 0.08),
    "trot": (0.45, 2, 0.08),
    "canter": (0.4, 4, 0.06),
    "gallop": (0.3, 3.5, 0.10),
}


class UnitreeGo2Env(BaseEnv):
    """Velocity-tracking walk with gait shaping."""

    def __init__(self, config: UnitreeGo2EnvConfig, device="cuda", dtype=torch.float32,
                 engine="fused"):
        super().__init__(config, device=device, dtype=dtype, engine=engine)

        self._foot_radius = 0.0175
        self._gait = config.gait
        self._torso_idx = self.mj_model.body_id("base")
        home = self.mj_model.keyframe_qpos("home")
        self._init_q = self._tensor(home)
        self._default_pose = home[7:]

        # task-space joint limits, tighter than the physical ones
        self.joint_range = self._tensor(
            [
                [-0.5, 0.5],
                [0.4, 1.4],
                [-2.3, -0.85],
                [-0.5, 0.5],
                [0.4, 1.4],
                [-2.3, -0.85],
                [-0.5, 0.5],
                [0.4, 1.4],
                [-2.3, -1.3],
                [-0.5, 0.5],
                [0.4, 1.4],
                [-2.3, -1.3],
            ]
        )

        self._feet_site_id = [
            self.mj_model.site_id(f) for f in ("FL_foot", "FR_foot", "RL_foot", "RR_foot")
        ]
        self._gait_phases = self._tensor(GAIT_PHASES[self._gait])
        self._head_offset = self._tensor([0.285, 0.0, 0.0])
        self._up = self._tensor([0.0, 0.0, 1.0])

    def make_system(self, config: UnitreeGo2EnvConfig):
        mj_model = load_scene("unitree_go2", "mjx_scene_force.xml")
        mj_model.opt.timestep = config.timestep
        return mj_model

    def reset(self, generator: torch.Generator = None) -> State:
        """The B = 1 start state. ``generator`` draws the velocity commands
        when ``randomize_tasks`` is set (it must live on the env's device)."""
        self._generator = generator
        pipeline_state = self.pipeline_init(
            self._init_q[None], torch.zeros(1, self._nv, device=self.device, dtype=self.dtype)
        )
        z = lambda *shape: torch.zeros(1, *shape, device=self.device, dtype=self.dtype)
        state_info = {
            "pos_tar": self._tensor([[0.282, 0.0, 0.3]]),
            "vel_tar": z(3),
            "ang_vel_tar": z(3),
            "yaw_tar": z(),
            "step": torch.zeros(1, dtype=torch.int32, device=self.device),
            "z_feet": z(4),
            "z_feet_tar": z(4),
            "randomize_target": self._config.randomize_tasks,
            "last_contact": torch.zeros(1, 4, dtype=torch.bool, device=self.device),
            "feet_air_time": z(4),
        }
        obs = self._get_obs(pipeline_state, state_info)
        return State(pipeline_state, obs, z(), z(), {}, state_info)

    def step(self, state: State, action: torch.Tensor, pipeline_next=None) -> State:
        # action -> physics ctrl
        if self._config.leg_control == "position":
            ctrl = self.act2joint(action)
        else:
            ctrl = self.act2tau(action, state.pipeline_state)
        pipeline_state = self.advance(state, ctrl, pipeline_next)
        x_pos = pipeline_state.x_pos
        x_rot = pipeline_state.x_rot

        obs = self._get_obs(pipeline_state, state.info)

        # command update: ramp toward the (possibly re-randomized) target
        step = state.info["step"]
        stepf = step.to(self.dtype)[:, None]
        B = step.shape[0]
        vel_tar = self._tensor([self._config.default_vx, self._config.default_vy, 0.0]).expand(B, 3)
        ang_vel_tar = self._tensor([0.0, 0.0, self._config.default_vyaw]).expand(B, 3)
        if state.info["randomize_target"]:
            resample = (step % 500 == 0)[:, None]
            new_vel, new_ang = self.sample_command()  # one draw shared by the batch
            vel_tar = torch.where(resample, new_vel, vel_tar)
            ang_vel_tar = torch.where(resample, new_ang, ang_vel_tar)
        info = dict(state.info)
        ramp_up_time = self._config.ramp_up_time
        info["vel_tar"] = torch.minimum(vel_tar * stepf * self.dt / ramp_up_time, vel_tar)
        info["ang_vel_tar"] = torch.minimum(
            ang_vel_tar * stepf * self.dt / ramp_up_time, ang_vel_tar
        )

        # ---- reward stack ----
        torso = self._torso_idx - 1
        torso_rot = x_rot[:, torso]

        # gait tracking
        z_feet = pipeline_state.site_xpos[:, self._feet_site_id, 2]
        duty_ratio, cadence, amplitude = GAIT_PARAMS[self._gait]
        z_feet_tar = get_foot_step(
            duty_ratio, cadence, amplitude, self._gait_phases, stepf[:, 0] * self.dt
        )
        reward_gaits = -(((z_feet_tar - z_feet) / 0.05) ** 2).sum(-1)

        # contact bookkeeping / air-time bonus
        foot_contact_z = z_feet - self._foot_radius
        contact = foot_contact_z < 1e-3
        contact_filt_mm = contact | state.info["last_contact"]
        first_contact = (state.info["feet_air_time"] > 0) * contact_filt_mm
        feet_air_time = state.info["feet_air_time"] + self.dt
        reward_air_time = ((feet_air_time - 0.1) * first_contact).sum(-1)

        # head-position tracking (uses the *updated* velocity command)
        pos_tar = state.info["pos_tar"] + info["vel_tar"] * self.dt * stepf
        pos = x_pos[:, torso]
        R = maths.quat_to_mat(torso_rot)
        head_pos = pos + R @ self._head_offset
        reward_pos = -((head_pos - pos_tar) ** 2).sum(-1)

        # upright
        vec = maths.rotate(self._up, x_rot[:, 0])
        reward_upright = -((vec - self._up) ** 2).sum(-1)

        # yaw tracking
        yaw_tar = state.info["yaw_tar"] + info["ang_vel_tar"][:, 2] * self.dt * stepf[:, 0]
        yaw = maths.quat_to_euler(torso_rot)[:, 2]
        d_yaw = yaw - yaw_tar
        reward_yaw = -torch.square(torch.atan2(torch.sin(d_yaw), torch.cos(d_yaw)))

        # body-frame velocity tracking (the pi/180 factor on the angular
        # velocity is part of the task definition)
        vb = global_to_body_velocity(pipeline_state.xd_vel[:, torso], torso_rot)
        ab = global_to_body_velocity(pipeline_state.xd_ang[:, torso] * math.pi / 180.0, torso_rot)
        reward_vel = -((vb[:, :2] - info["vel_tar"][:, :2]) ** 2).sum(-1)
        reward_ang_vel = -((ab[:, 2] - info["ang_vel_tar"][:, 2]) ** 2)

        # height
        reward_height = -((x_pos[:, torso, 2] - state.info["pos_tar"][:, 2]) ** 2)

        # energy
        reward_energy = -(
            torch.clamp_min(ctrl * pipeline_state.qvel[:, 6 : 6 + self._nu] / 160.0, 0.0) ** 2
        ).sum(-1)

        reward_alive = 1.0 - state.done

        reward = (
            reward_gaits * 0.1
            + reward_air_time * 0.0
            + reward_pos * 0.0
            + reward_upright * 0.5
            + reward_yaw * 0.3
            + reward_vel * 1.0
            + reward_ang_vel * 1.0
            + reward_height * 1.0
            + reward_energy * 0.00
            + reward_alive * 0.0
        )

        # termination
        joint_angles = pipeline_state.qpos[:, 7:]
        done = (maths.rotate(self._up, torso_rot) * self._up).sum(-1) < 0
        done = done | (joint_angles < self.joint_range[:, 0]).any(-1)
        done = done | (joint_angles > self.joint_range[:, 1]).any(-1)
        done = done | (x_pos[:, torso, 2] < 0.18)
        done = done.to(self.dtype)

        # bookkeeping
        info["step"] = step + 1
        info["z_feet"] = z_feet
        info["z_feet_tar"] = z_feet_tar
        info["feet_air_time"] = feet_air_time * ~contact_filt_mm
        info["last_contact"] = contact

        return state.replace(
            pipeline_state=pipeline_state, obs=obs, reward=reward, done=done, info=info
        )

    def _get_obs(self, pipeline_state, state_info) -> torch.Tensor:
        torso = self._torso_idx - 1
        torso_rot = pipeline_state.x_rot[:, torso]
        vb = global_to_body_velocity(pipeline_state.xd_vel[:, torso], torso_rot)
        ab = global_to_body_velocity(pipeline_state.xd_ang[:, torso] * math.pi / 180.0, torso_rot)
        return torch.cat(
            [
                state_info["vel_tar"],
                state_info["ang_vel_tar"],
                pipeline_state.ctrl,
                pipeline_state.qpos,
                vb,
                ab,
                pipeline_state.qvel[:, 6:],
            ],
            dim=-1,
        )

    def sample_command(self):
        """One uniform velocity command: (1, 3) linear and (1, 3) angular."""
        u = torch.rand(1, 3, generator=self._generator, device=self.device, dtype=self.dtype)
        zero = torch.zeros_like(u[:, 0])
        lin = torch.stack([u[:, 0] * 3.0 - 1.5, u[:, 1] * 1.0 - 0.5, zero], dim=-1)
        ang = torch.stack([zero, zero, u[:, 2] * 3.0 - 1.5], dim=-1)
        return lin, ang


register_env("unitree_go2_walk", UnitreeGo2Env, UnitreeGo2EnvConfig)


@dataclass
class UnitreeGo2SeqJumpEnvConfig(UnitreeGo2EnvConfig):
    jump_dt: float = 1.0
    contact_targets: torch.Tensor = None
    contact_target_radius: torch.Tensor = None
    pose_target_sequence: torch.Tensor = None
    yaw_target_sequence: torch.Tensor = None


def generate_jumping_sequence(com_pos: torch.Tensor, com_heading: torch.Tensor, foot_place_radius):
    """Per-stage foot contact targets around each CoM pose.

    com_pos (S, 3) and com_heading (S,), in radians. Returns the targets
    (S, 4, 3), their radii (S, 4), com_pos and com_heading. Foot offsets are
    ordered FR FL RR RL, the order of the feet-vs-floor contact slots.
    """
    n_steps = com_pos.shape[0]
    assert n_steps == com_heading.shape[0]
    contact_target_radius = torch.full(
        (n_steps, 4), foot_place_radius, dtype=com_pos.dtype, device=com_pos.device
    )
    offsets = torch.tensor(
        [
            [0.2, -0.135, 0.0],  # FR
            [0.2, 0.135, 0.0],  # FL
            [-0.2, -0.135, 0.0],  # RR
            [-0.2, 0.135, 0.0],  # RL
        ],
        dtype=com_pos.dtype, device=com_pos.device,
    )
    # the heading is in radians and euler_to_quat takes degrees, hence the factor
    zero = torch.zeros_like(com_heading)
    euler = torch.stack([zero, zero, com_heading * 180 / math.pi], dim=-1)
    R = maths.quat_to_mat(maths.euler_to_quat(euler))  # (S, 3, 3)
    targets = com_pos[:, None, :] + torch.einsum("fj,sij->sfi", offsets, R)
    return targets, contact_target_radius, com_pos, com_heading


class UnitreeGo2SeqJumpEnv(UnitreeGo2Env):
    """Staged contact-target jumping: a sequence of CoM poses, one per
    ``jump_dt`` seconds, each with four foot target circles.

    The reference environment pins reward and info to float32 whatever the
    physics type; here they are in the environment's dtype, which is float32
    in production.
    """

    def __init__(self, config: UnitreeGo2SeqJumpEnvConfig, device="cuda", dtype=torch.float32,
                 engine="fused"):
        super().__init__(config, device=device, dtype=dtype, engine=engine)
        if config.contact_targets is None or config.contact_target_radius is None:
            (
                self._contact_targets,
                self._contact_target_radius,
                self._pose_target_sequence,
                self._yaw_target_sequence,
            ) = generate_jumping_sequence(
                self._tensor(config.pose_target_sequence),
                self._tensor(config.yaw_target_sequence),
                0.1,
            )
        else:
            self._contact_targets = self._tensor(config.contact_targets)
            self._contact_target_radius = self._tensor(config.contact_target_radius)
            self._pose_target_sequence = self._tensor(config.pose_target_sequence)
            self._yaw_target_sequence = self._tensor(config.yaw_target_sequence)
        # wider front-hip envelope for jumping
        self.joint_range = self._tensor(
            [
                [-0.5, 0.5],
                [0.4, 2.0],
                [-2.3, -1.3],
                [-0.5, 0.5],
                [0.4, 2.0],
                [-2.3, -1.3],
                [-0.5, 0.5],
                [0.4, 1.4],
                [-2.3, -1.3],
                [-0.5, 0.5],
                [0.4, 1.4],
                [-2.3, -1.3],
            ]
        )

    def reset(self, generator: torch.Generator = None) -> State:
        """The B = 1 start state. ``generator`` draws the jump course when
        ``randomize_tasks`` is set (it must live on the env's device)."""
        self._generator = generator
        pipeline_state = self.pipeline_init(
            self._init_q[None], torch.zeros(1, self._nv, device=self.device, dtype=self.dtype)
        )
        z = lambda *shape: torch.zeros(1, *shape, device=self.device, dtype=self.dtype)
        if self._config.randomize_tasks:
            course = self.sample_command()
        else:
            course = (
                self._contact_targets, self._contact_target_radius,
                self._pose_target_sequence, self._yaw_target_sequence,
            )
        state_info = {
            "pos_tar": self._tensor([[0.0, 0.0, 0.27]]),
            "vel_tar": z(3),
            "ang_vel_tar": z(3),
            "yaw_tar": z(),
            "step": torch.zeros(1, dtype=torch.int32, device=self.device),
            "z_feet": z(4),
            "z_feet_tar": z(4),
            "randomize_target": self._config.randomize_tasks,
            "last_contact": torch.zeros(1, 4, dtype=torch.bool, device=self.device),
            "feet_air_time": z(4),
            "last_ctrl": z(12),
            "contact_stage": torch.zeros(1, dtype=torch.int32, device=self.device),
            # the course, carried per sample: (1, S, 4, 3), (1, S, 4), (1, S, 3), (1, S)
            "contact_targets": course[0][None],
            "contact_target_radius": course[1][None],
            "pose_target_sequence": course[2][None],
            "yaw_target_sequence": course[3][None],
        }
        obs = self._get_obs(pipeline_state, state_info)
        return State(pipeline_state, obs, z(), z(), {}, state_info)

    @staticmethod
    def _at_stage(sequence: torch.Tensor, stage: torch.Tensor) -> torch.Tensor:
        """sequence (B, S, ...) at each sample's own stage (B,) -> (B, ...):
        a gather, so that a step reads nothing back."""
        idx = stage.long().reshape(-1, 1, *([1] * (sequence.dim() - 2)))
        return sequence.gather(1, idx.expand(-1, 1, *sequence.shape[2:]))[:, 0]

    def step(self, state: State, action: torch.Tensor, pipeline_next=None) -> State:
        if self._config.leg_control == "position":
            ctrl = self.act2joint(action)
        elif self._config.leg_control == "torque":
            ctrl = self.act2tau(action, state.pipeline_state)
        else:
            raise ValueError("Invalid leg control type.")
        pipeline_state = self.advance(state, ctrl, pipeline_next)
        x_pos, x_rot = pipeline_state.x_pos, pipeline_state.x_rot
        torso = self._torso_idx - 1
        stage = state.info["contact_stage"]
        stepf = state.info["step"].to(self.dtype)

        obs = self._get_obs(pipeline_state, state.info)

        # ---- reward stack ----
        z_feet = pipeline_state.site_xpos[:, self._feet_site_id, 2]
        duty_ratio, cadence, amplitude = GAIT_PARAMS[self._gait]
        z_feet_tar = get_foot_step(
            duty_ratio, cadence, amplitude, self._gait_phases, stepf * self.dt
        )
        reward_gaits = -(((z_feet_tar - z_feet) / 0.05) ** 2).sum(-1)

        pos_tar = self._at_stage(state.info["pose_target_sequence"], stage)
        reward_pos = -((x_pos[:, torso] - pos_tar) ** 2).sum(-1)

        # the reference rotates by x_rot[0], not x_rot[torso]; the base is
        # body 1 of this scene, so the two are the same row
        vec = maths.rotate(self._up, x_rot[:, 0])
        reward_upright = -((vec - self._up) ** 2).sum(-1)

        yaw_tar = self._at_stage(state.info["yaw_target_sequence"], stage)
        yaw = maths.quat_to_euler(x_rot[:, torso])[:, 2]
        reward_yaw = -torch.square(yaw - yaw_tar)  # not wrapped to (-pi, pi], as in the reference

        # staged contact-target reward: a foot inside its circle of the
        # active stage scores by how deep it touches; a ground contact
        # outside every stage's circle is penalised. Contact slots 0-3 are
        # the four feet-vs-floor pairs (static pair table). The reference
        # walks feet x stages in a Python loop; here it is one (B, S, 4) pass.
        contact_targets = state.info["contact_targets"]  # (B, S, 4, 3)
        contact_target_radius = state.info["contact_target_radius"]  # (B, S, 4)
        n_stage = contact_targets.shape[1]
        cdist = pipeline_state.contact.dist[:, :4]
        cpos = pipeline_state.contact.pos[:, :4]
        inside = ((cpos[:, None, :, :2] - contact_targets[..., :2]) ** 2).sum(
            -1
        ) <= contact_target_radius**2
        active = torch.arange(n_stage, device=self.device)[None, :] == stage[:, None]
        depth = torch.clamp(cdist * -1.0 + 1.0, 0.0, 1.0)
        reward_contact = (inside * active[:, :, None] * depth[:, None, :]).sum((1, 2))
        penalty_contact = ((cdist <= 0.001) & ~inside.any(1)).sum(-1)

        reward_energy = -(
            torch.clamp_min(ctrl * pipeline_state.qvel[:, 6:] / 160.0, 0.0) ** 2
        ).sum(-1)
        reward_ctrl_rate = -((ctrl - state.info["last_ctrl"]) ** 2).sum(-1)
        reward_alive = 1.0

        reward = (
            reward_gaits * 0.0
            + reward_pos * 1.0
            + reward_upright * 1.0
            + reward_yaw * 0.3
            + reward_contact * 0.1
            - penalty_contact * 0.1
            + reward_energy * 0.0
            + reward_ctrl_rate * 0.0
            + reward_alive * 10.0
        )

        # termination
        joint_angles = pipeline_state.qpos[:, 7:]
        done = (maths.rotate(self._up, x_rot[:, torso]) * self._up).sum(-1) < 0
        done = done | (joint_angles < self.joint_range[:, 0]).any(-1)
        done = done | (joint_angles > self.joint_range[:, 1]).any(-1)
        done = done | (x_pos[:, torso, 2] < 0.1)
        done = done.to(self.dtype)

        info = dict(state.info)
        info["step"] = state.info["step"] + 1
        info["z_feet"] = z_feet
        info["z_feet_tar"] = z_feet_tar
        info["contact_stage"] = torch.clamp_max(
            torch.floor(info["step"].to(self.dtype) * self.dt / self._config.jump_dt),
            n_stage - 1,
        ).to(torch.int32)
        info["last_ctrl"] = ctrl

        return state.replace(
            pipeline_state=pipeline_state, obs=obs, reward=reward, done=done, info=info
        )

    def _get_obs(self, pipeline_state, state_info) -> torch.Tensor:
        torso = self._torso_idx - 1
        x_rot = pipeline_state.x_rot
        vb = global_to_body_velocity(pipeline_state.xd_vel[:, torso], x_rot[:, torso])
        # the pi/180 factor on the angular velocity is part of the task definition
        ab = global_to_body_velocity(
            pipeline_state.xd_ang[:, torso] * math.pi / 180.0, x_rot[:, torso]
        )
        rpy = maths.quat_to_euler(pipeline_state.qpos[:, 3:7])
        stage = state_info["contact_stage"]
        pose_target = self._at_stage(state_info["pose_target_sequence"], stage)
        yaw_target = self._at_stage(state_info["yaw_target_sequence"], stage)
        diff_position = pipeline_state.x_pos[:, torso] - pose_target
        diff_yaw = rpy[:, 2] - yaw_target
        diff_yaw = torch.atan2(torch.sin(diff_yaw), torch.cos(diff_yaw))[:, None]
        return torch.cat(
            [
                state_info["vel_tar"],
                state_info["ang_vel_tar"],
                state_info["last_ctrl"],
                diff_position,
                rpy[:, :2],
                diff_yaw,
                pipeline_state.qpos[:, 7:],
                vb,
                ab,
                pipeline_state.qvel[:, 6:],
            ],
            dim=-1,
        )

    def sample_command(self):
        """A random jump course of ten hops from the start pose: each hop moves
        the CoM by up to 0.65 m in x and y and turns it by up to 0.5 rad."""
        n_steps = 10
        u = torch.rand(n_steps, 3, generator=self._generator, device=self.device, dtype=self.dtype)
        com_pos = self._tensor([[0.0, 0.0, 0.27]]).repeat(n_steps + 1, 1)
        com_pos[1:, :2] += torch.cumsum(u[:, :2] * 1.3 - 0.65, dim=0)
        com_yaw = torch.cat([u.new_zeros(1), torch.cumsum(u[:, 2] * 1.0 - 0.5, dim=0)])
        return generate_jumping_sequence(com_pos, com_yaw, 0.1)

    def update_viewer(self, viewer):
        """Draw the contact-target circles as flat cylinders into a MuJoCo
        viewer's user scene (the deploy sim server calls it once). ``mujoco``
        is imported here: only a process with a viewer has it."""
        import mujoco

        targets = self._contact_targets.detach().cpu().double().numpy()
        radius = self._contact_target_radius.detach().cpu().double().numpy()
        cnt = viewer.user_scn.ngeom
        for i in range(targets.shape[0]):
            for j in range(4):
                mujoco.mjv_initGeom(
                    viewer.user_scn.geoms[cnt],
                    type=mujoco.mjtGeom.mjGEOM_CYLINDER,
                    size=np.array([float(radius[i, j]), 0.01, 0.0]),
                    rgba=np.array([0.0, 1.0, 0.0, 0.5]),
                    pos=targets[i, j],
                    mat=np.eye(3).flatten(),
                )
                cnt += 1
        viewer.user_scn.ngeom = cnt


register_env("unitree_go2_seq_jump", UnitreeGo2SeqJumpEnv, UnitreeGo2SeqJumpEnvConfig)


@dataclass
class UnitreeGo2CrateEnvConfig(UnitreeGo2EnvConfig):
    pass


class UnitreeGo2CrateEnv(UnitreeGo2Env):
    """Crate climbing: the head goes to a point above the crate, and each
    foot that touches the crate's top is rewarded."""

    def __init__(self, config: UnitreeGo2CrateEnvConfig, device="cuda", dtype=torch.float32,
                 engine="fused"):
        super().__init__(config, device=device, dtype=dtype, engine=engine)
        self.joint_range = self._tensor(
            [
                [-0.25, 0.25],
                [-1.0, 1.4],
                [-2.7, -1.0],
                [-0.25, 0.25],
                [-1.0, 1.4],
                [-2.7, -1.0],
                [-0.25, 0.25],
                [0.0, 1.8],
                [-2.7, -1.0],
                [-0.25, 0.25],
                [0.0, 1.8],
                [-2.7, -1.0],
            ]
        )
        # the foot-vs-crate contact slots, FR FL RR RL, from the static pair table
        crate = self.mj_model.geom_id("static_box")
        feet = [self.mj_model.geom_id(n) for n in ("FR", "FL", "RR", "RL")]
        slots = {}
        for (g1, g2, t1, t2, condim, conadr, conmax) in self.sys.pair_table:
            if crate in (g1, g2):
                other = g2 if g1 == crate else g1
                if other in feet:
                    slots[other] = conadr
        self._crate_contact_slots = [slots[g] for g in feet]

    def make_system(self, config: UnitreeGo2CrateEnvConfig):
        mj_model = load_scene("unitree_go2", "mjx_scene_force_crate.xml")
        mj_model.opt.timestep = config.timestep
        return mj_model

    def reset(self, generator: torch.Generator = None) -> State:
        state = super().reset(generator)
        info = dict(state.info)
        z = lambda *shape: torch.zeros(1, *shape, device=self.device, dtype=self.dtype)
        info["pos_tar"] = self._tensor([[1.45, 0.0, 0.87]])
        info["vel_tar"] = z(3)
        info["ang_vel_tar"] = z(3)
        info["yaw_tar"] = z()
        return state.replace(info=info)

    def step(self, state: State, action: torch.Tensor, pipeline_next=None) -> State:
        if self._config.leg_control == "position":
            ctrl = self.act2joint(action)
        else:
            ctrl = self.act2tau(action, state.pipeline_state)
        pipeline_state = self.advance(state, ctrl, pipeline_next)
        x_pos, x_rot = pipeline_state.x_pos, pipeline_state.x_rot
        torso = self._torso_idx - 1
        torso_rot = x_rot[:, torso]
        stepf = state.info["step"].to(self.dtype)[:, None]

        obs = self._get_obs(pipeline_state, state.info)

        # ---- reward stack ----
        # The gait, velocity, height, energy, pitch and roll terms are weighted
        # 0 in this task. They are computed all the same, as the reference
        # does: a velocity large enough overflows their squares where the
        # weighted terms stay finite, and 0 x inf must make the reward NaN
        # here as it does there (the planner then drops the rollout). The
        # reference's contact penalty, a count also weighted 0, is always
        # finite and is left out.
        z_feet = pipeline_state.site_xpos[:, self._feet_site_id, 2]
        duty_ratio, cadence, amplitude = GAIT_PARAMS[self._gait]
        z_feet_tar = get_foot_step(
            duty_ratio, cadence, amplitude, self._gait_phases, stepf[:, 0] * self.dt
        )
        reward_gaits = -(((z_feet_tar - z_feet) / 0.05) ** 2).sum(-1)
        reward_vel = -((pipeline_state.xd_vel[:, torso] - state.info["vel_tar"]) ** 2).sum(-1)
        reward_height = -((x_pos[:, torso, 2] - state.info["pos_tar"][:, 2]) ** 2)
        reward_energy = -(torch.clamp(ctrl * pipeline_state.qvel[:, 6 : 6 + self._nu] / 160.0, min=0.0) ** 2).sum(-1)

        pos_tar = state.info["pos_tar"] + state.info["vel_tar"] * self.dt * stepf
        head_pos = x_pos[:, torso] + maths.quat_to_mat(torso_rot) @ self._head_offset
        reward_pos = -((head_pos - pos_tar) ** 2).sum(-1)

        vec = maths.rotate(self._up, x_rot[:, 0])
        reward_upright = -((vec - self._up) ** 2).sum(-1)

        rpy = maths.quat_to_euler(torso_rot)
        reward_yaw = -torch.square(rpy[:, 2] - state.info["yaw_tar"])  # not wrapped
        reward_pitch = -torch.square(rpy[:, 1] - (-0.7854))
        reward_roll = -torch.square(rpy[:, 0])

        # feet on the crate's top: the contact point (the pair's midpoint)
        # inside a thin box around the top face
        cpos = pipeline_state.contact.pos[:, self._crate_contact_slots]  # (B, 4, 3)
        on_top = (
            (cpos[..., 0] > 1.0) & (cpos[..., 0] < 1.6)
            & (cpos[..., 1] > -0.45) & (cpos[..., 1] < 0.45)
            & (cpos[..., 2] > 0.59) & (cpos[..., 2] < 0.61)
        )
        reward_contact = on_top.sum(-1).to(self.dtype)

        reward = (
            reward_gaits * 0.0
            + reward_pos * 1.0
            + reward_upright * 0.01
            + reward_yaw * 0.3
            + reward_vel * 0.0
            + reward_height * 0.0
            + reward_energy * 0.0
            + reward_pitch * 0.0
            + reward_roll * 0.0
            + reward_contact * 0.02
        )

        info = dict(state.info)
        info["step"] = state.info["step"] + 1
        info["z_feet"] = z_feet
        info["z_feet_tar"] = z_feet_tar

        return state.replace(
            pipeline_state=pipeline_state, obs=obs, reward=reward, done=torch.zeros_like(reward),
            info=info,
        )


register_env("unitree_go2_crate_climb", UnitreeGo2CrateEnv, UnitreeGo2CrateEnvConfig)
