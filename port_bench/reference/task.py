"""What every task of the reference shares: the scene, the physics step
under one control and the PD torque mapping, on the plain reference physics
of this package. Each task (a frozen copy of one of the port's task
environments: reset, action mapping, reward stack) is a module of its own,
``tasks/<env_name>.py``, with a class ``Task`` built on :class:`BaseTask`.

A state is a :class:`State` of B samples; what the planner reads of it is
``data`` (the lean physics products), ``reward`` and ``info``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .forward import forward
from .forward import step as physics_step
from .model import Data, Model, put_model
from .scene import load_scene


@dataclasses.dataclass(frozen=True)
class State:
    data: Data  # qpos, qvel and the products of the last step's kinematics
    reward: torch.Tensor  # (B,)
    info: Dict[str, torch.Tensor]

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)


class BaseTask:
    """The scene, the physics step under one control, the PD torque
    mapping. ``config`` is the configuration's flat dict."""

    scene_file = ""

    def __init__(self, config: dict, device, dtype):
        self.device, self.dtype = torch.device(device), dtype
        self.dt = float(config["dt"])
        timestep = float(config["timestep"])
        self.n_frames = int(round(self.dt / timestep))
        self.action_scale = float(config.get("action_scale", 1.0))
        self.leg_control = config.get("leg_control", "torque")
        cm = load_scene(self.scene_file)
        cm.opt.timestep = timestep
        self.cm = cm
        self.sys: Model = put_model(cm, device=self.device, dtype=dtype)
        self.nu, self.nv, self.nq = cm.nu, cm.nv, cm.nq
        self.physical_joint_range = self.tensor(cm.jnt_range[1:])
        self.joint_range = self.physical_joint_range
        ctrl_range = np.array(cm.actuator_ctrlrange, dtype=np.float64)
        ctrl_range[np.asarray(cm.actuator_ctrllimited) == 0] = [-np.inf, np.inf]
        self.joint_torque_range = self.tensor(ctrl_range)
        self._graphs = {}

    def tensor(self, x) -> torch.Tensor:
        return torch.tensor(np.asarray(x, dtype=np.float64), device=self.device, dtype=self.dtype)

    def pipeline_init(self, q: torch.Tensor, qd: torch.Tensor) -> Data:
        B = q.shape[0]
        d = Data(qpos=q, qvel=qd, ctrl=q.new_zeros(B, self.nu), time=q.new_zeros(B))
        return forward(self.sys, d)

    def pipeline_step(self, d: Data, ctrl: torch.Tensor) -> Data:
        """n_frames physics steps under one control. qpos and qvel are after
        the last step; the kinematic products are the last step's, before
        its integration (as the port's step returns them).

        On a CUDA device a batch of more than one sample replays the same
        operations as a CUDA graph captured once for its batch size: the
        arithmetic is the same, the host no longer launches each of the
        thousands of small operations of a step."""
        B = d.qpos.shape[0]
        if self.device.type == "cuda" and B > 1:
            if B not in self._graphs:
                self._graphs[B] = GraphedStep(self, B)
            if self._graphs[B].graph is not None:
                return self._graphs[B](d.qpos, d.qvel, ctrl)
        return self.eager_step(d.qpos, d.qvel, ctrl)

    def eager_step(self, qpos, qvel, ctrl) -> Data:
        d = Data(qpos=qpos, qvel=qvel, ctrl=ctrl.to(qpos.dtype), time=qpos.new_zeros(qpos.shape[0]))
        for _ in range(self.n_frames):
            d = physics_step(self.sys, d)
        return d

    def act2tau(self, act: torch.Tensor, d: Data) -> torch.Tensor:
        joint_target = self.act2joint(act)
        n = joint_target.shape[-1]
        q = d.qpos[:, 7 : 7 + n]
        qd = d.qvel[:, 6 : 6 + n]
        tau = self.kp * (joint_target - q) - self.kd * qd
        return torch.clamp(tau, self.joint_torque_range[:, 0], self.joint_torque_range[:, 1])

    def act2joint(self, act: torch.Tensor) -> torch.Tensor:
        act_normalized = (act * self.action_scale + 1.0) / 2.0
        joint_targets = self.joint_range[:, 0] + act_normalized * (
            self.joint_range[:, 1] - self.joint_range[:, 0]
        )
        return torch.clamp(joint_targets, self.physical_joint_range[:, 0], self.physical_joint_range[:, 1])

    def step(self, state: State, action: torch.Tensor) -> State:
        """One env step: the control of the action, n_frames physics steps,
        the reward; the state's step counter advances."""
        ctrl = self.ctrl(state, action)
        d = self.pipeline_step(state.data, ctrl)
        info = dict(state.info)
        info["step"] = state.info["step"] + 1
        return State(d, self.reward(state, d, ctrl), info)

    def state_at(self, qpos: torch.Tensor, qvel: torch.Tensor, reward: torch.Tensor, step: int) -> State:
        """The B = 1 state at (qpos, qvel) after ``step`` control steps: what
        a step reads of a state (the kinematic products are not recomputed)."""
        d = Data(qpos=qpos, qvel=qvel, ctrl=qpos.new_zeros(1, self.nu), time=qpos.new_zeros(1))
        info = dict(self.reset_info())
        info["step"] = torch.full((1,), step, dtype=torch.int32, device=self.device)
        return State(d, reward, info)

    def reset(self) -> State:
        """The B = 1 start state at the task's keyframe, at rest."""
        qd = torch.zeros(1, self.nv, device=self.device, dtype=self.dtype)
        return State(self.pipeline_init(self.init_q[None], qd), qd.new_zeros(1), self.reset_info())


class GraphedStep:
    """``Task.eager_step`` at one batch size, captured as a CUDA graph.

    The capture runs after two eager warm-up steps (which also make every
    constant tensor the step uses), on static input buffers; a call copies
    its inputs in, replays, and returns copies of the products a task reads.
    Where the capture fails, ``graph`` is None and the caller steps eagerly.
    """

    def __init__(self, task: "BaseTask", batch: int):
        import sys

        kw = dict(device=task.device, dtype=task.dtype)
        self.qpos = task.sys.qpos0.expand(batch, task.nq).clone()
        self.qvel = torch.zeros(batch, task.nv, **kw)
        self.ctrl = torch.zeros(batch, task.nu, **kw)
        self.graph = None
        try:
            side = torch.cuda.Stream(device=task.device)
            side.wait_stream(torch.cuda.current_stream(task.device))
            with torch.cuda.stream(side):
                for _ in range(2):
                    task.eager_step(self.qpos, self.qvel, self.ctrl)
            torch.cuda.current_stream(task.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self.out = task.eager_step(self.qpos, self.qvel, self.ctrl)
            self.graph = graph
        except RuntimeError as e:
            print(f"reference: no CUDA graph at batch {batch}, stepping eagerly: {e}", file=sys.stderr)

    def __call__(self, qpos, qvel, ctrl) -> Data:
        self.qpos.copy_(qpos)
        self.qvel.copy_(qvel)
        self.ctrl.copy_(ctrl)
        self.graph.replay()
        o = self.out
        c = o.contact
        contact = None if c is None else dataclasses.replace(c, dist=c.dist.clone(), pos=c.pos.clone())
        return Data(
            qpos=o.qpos.clone(), qvel=o.qvel.clone(), ctrl=o.ctrl.clone(), time=o.time.clone(),
            site_xpos=o.site_xpos.clone(), x_pos=o.x_pos.clone(), x_rot=o.x_rot.clone(),
            xd_vel=o.xd_vel.clone(), xd_ang=o.xd_ang.clone(), qacc=o.qacc.clone(), contact=contact,
        )
