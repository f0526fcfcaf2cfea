"""Unitree H1 humanoid: the 19-actuator jog, crate pushing, and the
11-actuator legs-and-torso model with foot-level shaping.

Contact slots are looked up from the static pair table by body and geom
name (the table's order is fixed by ``physics.model.put_model``), so the
rewards read ``contact.dist`` and ``contact.pos`` at known columns. Every
term is elementwise work on (B, ...) tensors of the batched rollout.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Union

import torch

from dial_mpc_tpu_torch.config.base_env_config import BaseEnvConfig
from dial_mpc_tpu_torch.envs import register_env
from dial_mpc_tpu_torch.envs.base_env import BaseEnv, State
from dial_mpc_tpu_torch.physics import maths
from dial_mpc_tpu_torch.physics.compiled_model import load_scene
from dial_mpc_tpu_torch.utils.function_utils import get_foot_step, global_to_body_velocity

# per-joint PD gains: legs (hip yaw, roll, pitch, knee, ankle) x 2, torso, arms
_H1_KP = (200.0, 200.0, 200.0, 200.0, 60.0,
          200.0, 200.0, 200.0, 200.0, 60.0,
          200.0,
          60.0, 60.0, 60.0, 60.0,
          60.0, 60.0, 60.0, 60.0)
_H1_KD = (5.0, 5.0, 5.0, 5.0, 1.5,
          5.0, 5.0, 5.0, 5.0, 1.5,
          5.0,
          1.5, 1.5, 1.5, 1.5,
          1.5, 1.5, 1.5, 1.5)

# per-foot phase offsets, and (duty_ratio, cadence, amplitude)
H1_GAIT_PHASES = {
    "stand": (0.0, 0.0),
    "slow_walk": (0.0, 0.5),
    "walk": (0.0, 0.5),
    "jog": (0.0, 0.5),
}
H1_WALK_GAIT_PARAMS = {
    "stand": (1.0, 1.0, 0.0),
    "slow_walk": (0.6, 0.8, 0.15),
    "walk": (0.5, 1.0, 0.15),
    "jog": (0.3, 2.0, 0.2),
}
H1_LOCO_GAIT_PARAMS = {
    "stand": (1.0, 1.0, 0.0),
    "slow_walk": (0.6, 0.8, 0.15),
    "walk": (0.5, 1.5, 0.10),
    "jog": (0.3, 2.0, 0.2),
}


@dataclass
class UnitreeH1WalkEnvConfig(BaseEnvConfig):
    kp: Union[float, torch.Tensor] = field(default_factory=lambda: torch.tensor(_H1_KP))
    kd: Union[float, torch.Tensor] = field(default_factory=lambda: torch.tensor(_H1_KD))
    default_vx: float = 1.0
    default_vy: float = 0.0
    default_vyaw: float = 0.0
    ramp_up_time: float = 2.0
    gait: str = "jog"


def plane_slots_for_body(env: BaseEnv, body_name: str) -> list:
    """Contact slots of the (floor, any geom of body_name) pairs, in order."""
    floor = env.mj_model.geom_id("floor")
    body = env.mj_model.body_id(body_name)
    slots = []
    for (g1, g2, t1, t2, condim, conadr, conmax) in env.sys.pair_table:
        if g1 == floor and env.sys.geom_bodyid_static[g2] == body:
            slots.extend(range(conadr, conadr + conmax))
    return slots


class UnitreeH1WalkEnv(BaseEnv):
    """19-actuator humanoid jog: gait tracking on the feet's contact
    distances, velocity, yaw and height tracking, an energy penalty."""

    scene = "mjx_scene_h1_walk.xml"
    gait_params = H1_WALK_GAIT_PARAMS

    def __init__(self, config: UnitreeH1WalkEnvConfig, device="cuda", dtype=torch.float32,
                 engine="fused"):
        super().__init__(config, device=device, dtype=dtype, engine=engine)
        mj = self.mj_model
        self._pelvis_idx = mj.body_id("pelvis")
        self._torso_idx = mj.body_id("torso_link")
        self._left_foot_idx = mj.site_id("left_foot")
        self._right_foot_idx = mj.site_id("right_foot")
        self._feet_site_id = [self._left_foot_idx, self._right_foot_idx]
        self._gait = config.gait
        self._gait_phases = self._tensor(H1_GAIT_PHASES[self._gait])
        home = mj.keyframe_qpos("home")
        self._init_q = self._tensor(home)
        self._default_pose = home[7:]
        # task-space joint envelope
        self.joint_range = self._tensor(
            [
                [-0.3, 0.3], [-0.3, 0.3], [-1.0, 1.0], [0.0, 1.74], [-0.6, 0.4],
                [-0.3, 0.3], [-0.3, 0.3], [-1.0, 1.0], [0.0, 1.74], [-0.6, 0.4],
                [-0.5, 0.5],
                [-0.78, 0.78], [-0.3, 0.3], [-0.3, 0.3], [-0.3, 0.3],
                [-0.78, 0.78], [-0.3, 0.3], [-0.3, 0.3], [-0.3, 0.3],
            ]
        )
        # the feet's collision capsules against the floor
        self._left_foot_slots = plane_slots_for_body(self, "left_ankle_link")
        self._right_foot_slots = plane_slots_for_body(self, "right_ankle_link")
        self._up = self._tensor([0.0, 0.0, 1.0])

    def make_system(self, config: UnitreeH1WalkEnvConfig):
        mj_model = load_scene("unitree_h1", self.scene)
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
            "pos_tar": self._tensor([[0.0, 0.0, 1.3]]),
            "vel_tar": z(3),
            "ang_vel_tar": z(3),
            "yaw_tar": z(),
            "step": torch.zeros(1, dtype=torch.int32, device=self.device),
            "z_feet": z(2),
            "z_feet_tar": z(2),
            "randomize_target": self._config.randomize_tasks,
            "last_contact": torch.zeros(1, 2, dtype=torch.bool, device=self.device),
            "feet_air_time": z(2),
        }
        obs = self._get_obs(pipeline_state, state_info)
        return State(pipeline_state, obs, z(), z(), {}, state_info)

    def _z_feet_from_contacts(self, pipeline_state) -> torch.Tensor:
        """(B, 2): each foot's least contact distance to the floor."""
        dist = pipeline_state.contact.dist
        return torch.stack(
            [dist[:, self._left_foot_slots].amin(-1), dist[:, self._right_foot_slots].amin(-1)], dim=-1
        )

    def _reward_extra(self, pipeline_state, ctrl) -> dict:
        return {}

    def step(self, state: State, action: torch.Tensor, pipeline_next=None) -> State:
        if self._config.leg_control == "position":
            ctrl = self.act2joint(action)
        else:
            ctrl = self.act2tau(action, state.pipeline_state)
        pipeline_state = self.advance(state, ctrl, pipeline_next)
        x_pos, x_rot = pipeline_state.x_pos, pipeline_state.x_rot
        torso = self._torso_idx - 1
        torso_rot = x_rot[:, torso]

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
        # The air-time bonus, the position term and the alive term are
        # weighted 0 in every H1 task. They are computed all the same, as the
        # reference does: a position far out enough overflows the position
        # term's square where the weighted terms stay finite, and 0 x inf must
        # make the reward NaN here as it does there (the planner then drops
        # the rollout).
        # gait tracking on the foot capsules' contact distances
        duty_ratio, cadence, amplitude = self.gait_params[self._gait]
        z_feet_tar = get_foot_step(
            duty_ratio, cadence, amplitude, self._gait_phases, stepf[:, 0] * self.dt
        )
        z_feet = self._z_feet_from_contacts(pipeline_state)
        reward_gaits = -((z_feet_tar - z_feet) ** 2).sum(-1)

        # contact bookkeeping on the foot sites
        contact = pipeline_state.site_xpos[:, self._feet_site_id, 2] < 1e-3
        contact_filt_mm = contact | state.info["last_contact"]
        first_contact = (state.info["feet_air_time"] > 0) & contact_filt_mm
        feet_air_time = state.info["feet_air_time"] + self.dt
        reward_air_time = ((feet_air_time - 0.1) * first_contact).sum(-1)
        pos_tar = state.info["pos_tar"] + info["vel_tar"] * self.dt * stepf
        reward_pos = -((x_pos[:, torso] - pos_tar) ** 2).sum(-1)
        reward_alive = 1.0 - state.done

        vec = maths.rotate(self._up, x_rot[:, 0])
        reward_upright = -((vec - self._up) ** 2).sum(-1)

        yaw_tar = state.info["yaw_tar"] + info["ang_vel_tar"][:, 2] * self.dt * stepf[:, 0]
        yaw = maths.quat_to_euler(torso_rot)[:, 2]
        d_yaw = yaw - yaw_tar
        reward_yaw = -torch.square(torch.atan2(torch.sin(d_yaw), torch.cos(d_yaw)))

        # body-frame velocity tracking (the pi/180 factor on the angular
        # velocity is part of the task definition)
        vb = global_to_body_velocity(pipeline_state.xd_vel[:, torso], torso_rot)
        ab = global_to_body_velocity(pipeline_state.xd_ang[:, torso] * math.pi / 180.0, torso_rot)
        reward_vel = -((vb[:, :2] - info["vel_tar"][:, :2]) ** 2).sum(-1)
        reward_ang_vel = self._reward_ang_vel(ab, info)

        reward_height = -((x_pos[:, torso, 2] - state.info["pos_tar"][:, 2]) ** 2)
        reward_energy = self._reward_energy(pipeline_state, ctrl)
        extra = self._reward_extra(pipeline_state, ctrl)

        reward = self._combine_reward(
            reward_gaits=reward_gaits,
            reward_upright=reward_upright,
            reward_yaw=reward_yaw,
            reward_vel=reward_vel,
            reward_ang_vel=reward_ang_vel,
            reward_height=reward_height,
            reward_energy=reward_energy,
            **extra,
        ) + (reward_air_time * 0.0 + reward_pos * 0.0 + reward_alive * 0.0)

        # termination
        joint_angles = pipeline_state.qpos[:, 7 : 7 + self.joint_range.shape[0]]
        done = (maths.rotate(self._up, torso_rot) * self._up).sum(-1) < 0
        done = done | (joint_angles < self.joint_range[:, 0]).any(-1)
        done = done | (joint_angles > self.joint_range[:, 1]).any(-1)
        done = done | (x_pos[:, torso, 2] < 0.18)
        done = done.to(self.dtype)

        info["step"] = step + 1
        info["z_feet"] = z_feet
        info["z_feet_tar"] = z_feet_tar
        info["feet_air_time"] = feet_air_time * ~contact_filt_mm
        info["last_contact"] = contact

        return state.replace(
            pipeline_state=pipeline_state, obs=obs, reward=reward, done=done, info=info
        )

    def _reward_ang_vel(self, ab, info) -> torch.Tensor:
        return -((ab[:, 2] - info["ang_vel_tar"][:, 2]) ** 2)

    def _reward_energy(self, pipeline_state, ctrl) -> torch.Tensor:
        return -((ctrl / self.joint_torque_range[:, 1]) ** 2).sum(-1)

    def _combine_reward(self, **r) -> torch.Tensor:
        return (
            r["reward_gaits"] * 5.0
            + r["reward_upright"] * 0.5
            + r["reward_yaw"] * 0.1
            + r["reward_vel"] * 1.0
            + r["reward_ang_vel"] * 1.0
            + r["reward_height"] * 0.5
            + r["reward_energy"] * 0.01
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


@dataclass
class UnitreeH1PushCrateEnvConfig(UnitreeH1WalkEnvConfig):
    pass


class UnitreeH1PushCrateEnv(UnitreeH1WalkEnv):
    """Crate pushing: hands on the crate below 1.1 m are rewarded, legs and
    torso on the crate penalised. The crate slides on a joint of its own."""

    scene = "mjx_scene_h1_push_crate.xml"

    def __init__(self, config: UnitreeH1PushCrateEnvConfig, device="cuda", dtype=torch.float32,
                 engine="fused"):
        super().__init__(config, device=device, dtype=dtype, engine=engine)
        # the crate's slide joint is no robot joint
        self.physical_joint_range = self.physical_joint_range[:-1]
        mj = self.mj_model
        crate = mj.geom_id("static_box")
        floor = mj.geom_id("floor")
        hands = {mj.body_id(n) for n in ("left_elbow_link", "right_elbow_link")}
        wanted, unwanted = [], []
        for (g1, g2, t1, t2, condim, conadr, conmax) in self.sys.pair_table:
            if crate not in (g1, g2):
                continue
            other = g2 if g1 == crate else g1
            if other == floor:  # crate on the floor: always touching, no signal
                continue
            dst = wanted if self.sys.geom_bodyid_static[other] in hands else unwanted
            dst.extend(range(conadr, conadr + conmax))
        self._wanted_contacts = wanted
        self._unwanted_contacts = unwanted

    def reset(self, generator: torch.Generator = None) -> State:
        state = super().reset(generator)
        info = dict(state.info)
        info["pos_tar"] = self._tensor([[0.0, 0.0, 1.2]])
        return state.replace(info=info)

    def _reward_extra(self, pipeline_state, ctrl) -> dict:
        con = pipeline_state.contact
        w, u = self._wanted_contacts, self._unwanted_contacts
        good = ((con.dist[:, w] < 1e-3) & (con.pos[:, w, 2] < 1.1)).sum(-1)
        bad = (con.dist[:, u] < 1e-3).sum(-1)
        return {"reward_contact": (good - bad).to(self.dtype)}

    def _combine_reward(self, **r) -> torch.Tensor:
        return (
            r["reward_gaits"] * 5.0
            + r["reward_upright"] * 0.01
            + r["reward_yaw"] * 0.1
            + r["reward_vel"] * 1.0
            + r["reward_ang_vel"] * 1.0
            + r["reward_height"] * 0.5
            + r["reward_energy"] * 0.01
            + r["reward_contact"] * 0.05
        )


@dataclass
class UnitreeH1LocoEnvConfig(BaseEnvConfig):
    kp: Union[float, torch.Tensor] = field(default_factory=lambda: torch.tensor(_H1_KP[:11]))
    kd: Union[float, torch.Tensor] = field(default_factory=lambda: torch.tensor(_H1_KD[:11]))
    default_vx: float = 1.0
    default_vy: float = 0.0
    default_vyaw: float = 0.0
    ramp_up_time: float = 2.0
    gait: str = "jog"


class UnitreeH1LocoEnv(UnitreeH1WalkEnv):
    """11-actuator legs-and-torso model: full angular-velocity tracking,
    power penalty and foot-level shaping."""

    scene = "mjx_scene_h1_loco.xml"
    gait_params = H1_LOCO_GAIT_PARAMS

    def __init__(self, config: UnitreeH1LocoEnvConfig, device="cuda", dtype=torch.float32,
                 engine="fused"):
        super().__init__(config, device=device, dtype=dtype, engine=engine)
        self.joint_range = self._tensor(
            [
                [-0.2, 0.2], [-0.2, 0.2], [-0.6, 0.6], [0.0, 1.5], [-0.6, 0.4],
                [-0.2, 0.2], [-0.2, 0.2], [-0.6, 0.6], [0.0, 1.5], [-0.6, 0.4],
                [-0.5, 0.5],
            ]
        )

    def _reward_ang_vel(self, ab, info) -> torch.Tensor:
        return -((ab - info["ang_vel_tar"]) ** 2).sum(-1)

    def _reward_energy(self, pipeline_state, ctrl) -> torch.Tensor:
        n = self.joint_range.shape[0]
        power = ctrl / self.joint_torque_range[:, 1] * pipeline_state.qvel[:, 6 : 6 + n] / 160.0
        return -(power**2).sum(-1)

    def _reward_extra(self, pipeline_state, ctrl) -> dict:
        # each foot site's z axis against the world's
        left = pipeline_state.site_xmat[:, self._left_foot_idx, :, 2]
        right = pipeline_state.site_xmat[:, self._right_foot_idx, :, 2]
        return {
            "reward_foot_level": -((left - self._up) ** 2 + (right - self._up) ** 2).sum(-1)
        }

    def _combine_reward(self, **r) -> torch.Tensor:
        return (
            r["reward_gaits"] * 10.0
            + r["reward_upright"] * 0.5
            + r["reward_yaw"] * 0.5
            + r["reward_vel"] * 1.0
            + r["reward_ang_vel"] * 1.0
            + r["reward_height"] * 0.5
            + r["reward_foot_level"] * 0.02
            + r["reward_energy"] * 0.01
        )


register_env("unitree_h1_walk", UnitreeH1WalkEnv, UnitreeH1WalkEnvConfig)
register_env("unitree_h1_push_crate", UnitreeH1PushCrateEnv, UnitreeH1PushCrateEnvConfig)
register_env("unitree_h1_loco", UnitreeH1LocoEnv, UnitreeH1LocoEnvConfig)
