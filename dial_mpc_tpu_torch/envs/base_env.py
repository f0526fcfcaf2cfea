"""Environment base: State + BaseEnv on the batched physics engine.

``reset/step/act2joint/act2tau/_get_obs``, ``n_frames = dt/timestep``
substepping, joint/torque ranges from the model, PD torque mapping. Every
tensor of a State carries a leading batch axis B; the planner's own state is
B = 1 and is expanded to ``Nsample + 1`` for rollouts with
:func:`expand_state`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from dial_mpc_tpu_torch.config.base_env_config import BaseEnvConfig
from dial_mpc_tpu_torch.physics import engine_cuda
from dial_mpc_tpu_torch.physics import model as mlib
from dial_mpc_tpu_torch.physics.forward import forward
from dial_mpc_tpu_torch.physics.forward import step as physics_step
from dial_mpc_tpu_torch.utils.io_utils import get_model_path

ENGINES = ("fused", "unfused")


@dataclasses.dataclass(frozen=True, eq=False)
class State:
    """Environment state for a batch of B samples."""

    pipeline_state: mlib.Data
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    metrics: Dict[str, torch.Tensor]
    info: Dict[str, Any]

    def replace(self, **kwargs) -> "State":
        return dataclasses.replace(self, **kwargs)


def map_data(fn, d: mlib.Data, *others: mlib.Data) -> mlib.Data:
    """Apply fn to every batched tensor of a Data (and of others, zipped).

    The contact table's per-slot parameters have no batch axis and are kept.
    """
    kw = {}
    for f in dataclasses.fields(d):
        v = getattr(d, f.name)
        if isinstance(v, torch.Tensor):
            kw[f.name] = fn(v, *(getattr(o, f.name) for o in others))
    if d.contact is not None:
        ckw = {}
        for name in ("dist", "pos", "frame"):
            v = getattr(d.contact, name)
            if v is not None:
                ckw[name] = fn(v, *(getattr(o.contact, name) for o in others))
        kw["contact"] = dataclasses.replace(d.contact, **ckw)
    return dataclasses.replace(d, **kw)


def expand_state(state: State, n: int) -> State:
    """Broadcast a B = 1 State to n samples (views, no copy)."""

    def ex(t):
        return t.expand(n, *t.shape[1:])

    return State(
        pipeline_state=map_data(ex, state.pipeline_state),
        obs=ex(state.obs),
        reward=ex(state.reward),
        done=ex(state.done),
        metrics={k: ex(v) for k, v in state.metrics.items()},
        info={k: ex(v) if isinstance(v, torch.Tensor) else v for k, v in state.info.items()},
    )


def require_device(device) -> torch.device:
    """The device as given, or an error: nothing here falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was asked for but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return device


class BaseEnv:
    """Physics-backed task environment.

    Subclasses implement ``make_system`` (load + configure the compiled
    scene), ``reset`` and ``step``. The heavy physics state advance is
    ``pipeline_step``: n_frames substeps of the engine under one control.

    ``engine`` chooses how a substep runs on the card: ``"fused"`` is one
    launch of the whole-step kernel for all n_frames substeps; ``"unfused"``
    runs the physics stage by stage in plain PyTorch with the solve stage on
    the standalone Newton-solve kernel. On the CPU both are plain PyTorch.
    """

    def __init__(self, config: BaseEnvConfig, device="cuda", dtype=torch.float32, engine="fused"):
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}; known: {ENGINES}")
        self.engine = engine
        assert (
            abs(config.dt / config.timestep - round(config.dt / config.timestep)) < 1e-9
        ), "dt must be an integer multiple of timestep"
        self.device = require_device(device)
        self.dtype = dtype
        self._config = config
        self._n_frames = int(round(config.dt / config.timestep))
        mj_model = self.make_system(config)
        self.mj_model = mj_model
        self.sys = mlib.put_model(mj_model, device=self.device, dtype=dtype)

        # joint limit definitions (the free joint's row is skipped)
        self.physical_joint_range = self._tensor(mj_model.jnt_range[1:])
        self.joint_range = self.physical_joint_range
        # unlimited actuators clip to +/-inf (Go2's motors declare no ctrlrange)
        ctrl_range = np.array(mj_model.actuator_ctrlrange, dtype=np.float64)
        ctrl_range[np.asarray(mj_model.actuator_ctrllimited) == 0] = [-np.inf, np.inf]
        self.joint_torque_range = self._tensor(ctrl_range)

        self._nv = mj_model.nv
        self._nq = mj_model.nq
        self._nu = mj_model.nu
        # PD gains: a scalar stays a Python number, per-joint gains become one
        # tensor on the env's device
        self._kp, self._kd = self._gain(config.kp), self._gain(config.kd)

    def _gain(self, g):
        return g if isinstance(g, (int, float)) else self._tensor(g)

    def _tensor(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=self.dtype)
        return torch.tensor(np.asarray(x, dtype=np.float64), device=self.device, dtype=self.dtype)

    # -- model loading ------------------------------------------------------

    def make_system(self, config: BaseEnvConfig):
        raise NotImplementedError

    # -- sizes --------------------------------------------------------------

    @property
    def action_size(self) -> int:
        return self._nu

    @property
    def dt(self) -> float:
        return self._config.dt

    # -- physics pipeline ---------------------------------------------------

    def pipeline_init(self, q: torch.Tensor, qd: torch.Tensor) -> mlib.Data:
        """Lean Data at (q, qd) of shape (B, nq), (B, nv)."""
        d = mlib.make_data(self.sys, q.shape[0])
        d = d.replace(qpos=q.to(d.qpos.dtype), qvel=qd.to(d.qvel.dtype))
        return engine_cuda.trim_data(self.sys, forward(self.sys, d))

    def pipeline_step(self, d: mlib.Data, ctrl: torch.Tensor) -> mlib.Data:
        """Advance n_frames simulator steps under one control (B, nu).

        Fused: one call of the step kernel's wrapper for all n_frames
        substeps (on the card one kernel launch, on the CPU the plain
        version). Unfused: n_frames times ``forward.step``, whose solve stage
        is the solver kernel's wrapper. Both return the same lean Data.
        """
        ctrl = ctrl.to(d.qpos.dtype)
        if self.engine == "unfused":
            d = d.replace(ctrl=ctrl)
            for _ in range(self._n_frames):
                d = engine_cuda.trim_data(self.sys, physics_step(self.sys, d))
            return d
        outs = engine_cuda.step_core(self.sys, d.qpos, d.qvel, ctrl, n_steps=self._n_frames)
        return engine_cuda.lean_data(
            self.sys, d, outs, ctrl, self._n_frames * self.sys.opt.timestep
        )

    def advance(self, state, ctrl, pipeline_next=None):
        """Next pipeline state: live physics, or playback of a precomputed
        Data (test/replay injection; the applied ctrl is recorded either way)."""
        if pipeline_next is not None:
            return pipeline_next.replace(ctrl=ctrl.to(pipeline_next.qpos.dtype))
        return self.pipeline_step(state.pipeline_state, ctrl)

    # -- action mappings ----------------------------------------------------

    def act2joint(self, act: torch.Tensor) -> torch.Tensor:
        act_normalized = (act * self._config.action_scale + 1.0) / 2.0
        joint_targets = self.joint_range[:, 0] + act_normalized * (
            self.joint_range[:, 1] - self.joint_range[:, 0]
        )
        return torch.clamp(
            joint_targets, self.physical_joint_range[:, 0], self.physical_joint_range[:, 1]
        )

    def act2tau(self, act: torch.Tensor, pipeline_state: mlib.Data) -> torch.Tensor:
        joint_target = self.act2joint(act)
        n = joint_target.shape[-1]
        q = pipeline_state.qpos[:, 7 : 7 + n]
        qd = pipeline_state.qvel[:, 6 : 6 + n]
        q_err = joint_target - q
        tau = self._kp * q_err - self._kd * qd
        return torch.clamp(tau, self.joint_torque_range[:, 0], self.joint_torque_range[:, 1])

    # -- env API ------------------------------------------------------------

    def reset(self, generator: torch.Generator = None) -> State:
        raise NotImplementedError

    def step(self, state: State, action: torch.Tensor) -> State:
        raise NotImplementedError

    # -- rendering (host side, CPU MuJoCo: where ``mujoco`` is installed) ------

    def viewer_model(self):
        """The ``mujoco.MjModel`` of the env's scene, compiled from its MJCF
        (the compiled snapshot ``mj_model`` holds no meshes or colours)."""
        import mujoco

        if self.mj_model.source is None:
            raise ValueError("the env's model was not loaded from a shipped scene (load_scene)")
        model = mujoco.MjModel.from_xml_path(get_model_path(*self.mj_model.source))
        model.opt.timestep = self.mj_model.opt.timestep
        return model

    def render(self, trajectory, camera=None, width=240, height=320):
        """Rasterize a trajectory of States (or pipeline Datas) to a list of
        RGB uint8 arrays with CPU MuJoCo. Needs a GL backend (MUJOCO_GL=egl or
        osmesa where there is no display); ``render_html`` needs none."""
        import mujoco

        model = self.viewer_model()
        renderer = mujoco.Renderer(model, height=height, width=width)
        data = mujoco.MjData(model)
        out = []
        try:
            for st in trajectory:
                ps = getattr(st, "pipeline_state", st)
                data.qpos[:] = _one_row(ps.qpos, model.nq)
                data.qvel[:] = _one_row(ps.qvel, model.nv)
                mujoco.mj_forward(model, data)
                if camera is None:
                    renderer.update_scene(data)
                else:
                    renderer.update_scene(data, camera=camera)
                out.append(renderer.render())
        finally:
            renderer.close()
        return out

    def render_html(self, trajectory, path, fps=None, decimate=1):
        """Self-contained WebGL HTML viewer of a trajectory of States (or
        pipeline Datas, or raw qpos rows), written to ``path``; returns it.
        Works headless; meshes are drawn decimated."""
        from dial_mpc_tpu_torch.viz.html_viewer import render_trajectory

        model = self.viewer_model()
        qpos = [_one_row(getattr(getattr(st, "pipeline_state", st), "qpos", st), model.nq) for st in trajectory]
        return render_trajectory(
            model, np.stack(qpos), path, fps=(1.0 / self.dt if fps is None else fps), decimate=decimate
        )


def _one_row(x, n: int) -> np.ndarray:
    """One state's (n,) vector from a tensor or array of n values (a batch of
    one included)."""
    a = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if a.size != n:
        raise ValueError(f"expected one state of {n} values, got shape {a.shape}")
    return a.reshape(n).astype(np.float64)
