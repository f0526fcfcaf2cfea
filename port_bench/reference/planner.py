"""The planner's arithmetic of one control step, in plain PyTorch: DIAL-MPC's
annealed MPPI over spline nodes, a frozen copy of the port's ``MBDPI``.

A control step advances the state under the plan's first node, shifts the
plan by one control step and runs ``n_diffuse`` levels, each of which
samples ``Nsample`` node trajectories around the plan (the standard-normal
draw ``eps`` is an input), rolls them out with the mean plan as the last
row, and replaces the plan by the softmax-weighted mean of the samples.
"""

from __future__ import annotations

import numpy as np
import torch

from .spline import interp_matrix
from .task import BaseTask as Task, State


class Planner:
    def __init__(self, config: dict, task: Task, n_sample: int, dtype=None):
        """``dtype`` is the planner's arithmetic (the task's by default)."""
        self.task = task
        self.n_sample = n_sample
        self.Hsample, self.Hnode = int(config["Hsample"]), int(config["Hnode"])
        self.temp_sample = float(config["temp_sample"])
        self.traj_diffuse_factor = float(config["traj_diffuse_factor"])
        kw = dict(device=task.device, dtype=task.dtype if dtype is None else dtype)
        self.kw = kw
        sigma_scale = float(config.get("sigma_scale", 1.0))
        self.sigma_control = torch.tensor(
            float(config["horizon_diffuse_factor"]) ** np.arange(self.Hnode + 1)[::-1] * sigma_scale, **kw
        )
        ctrl_dt = 0.02  # the planner's fixed control step, as the shipped configs keep dt
        step_us = np.linspace(0, ctrl_dt * self.Hsample, self.Hsample + 1)
        step_nodes = np.linspace(0, ctrl_dt * self.Hsample, self.Hnode + 1)
        self.n2u = torch.tensor(interp_matrix(step_nodes, step_us), **kw)
        self.u2n = torch.tensor(interp_matrix(step_us, step_nodes), **kw)

    def shift(self, Y: torch.Tensor) -> torch.Tensor:
        u = torch.roll(self.n2u @ Y, -1, dims=0)
        u[-1] = 0.0
        return self.u2n @ u

    def diffuse_factors(self, n_diffuse: int) -> torch.Tensor:
        decay = self.traj_diffuse_factor ** torch.arange(n_diffuse, **self.kw)
        return self.sigma_control * decay[:, None]

    def sample_nodes(self, Ybar: torch.Tensor, noise_scale: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        Y0s = eps * noise_scale[None, :, None] + Ybar
        Y0s[:, 0] = Ybar[0]  # the first node is already being executed
        Y0s = torch.cat([Y0s, Ybar[None]], dim=0)  # the mean plan is the last row
        return torch.clamp(Y0s, -1.0, 1.0)

    def rollout(self, state: State, Y0s: torch.Tensor):
        """Rewards (N+1, Hsample+1) and body positions (N+1, Hsample+1, nbody-1, 3)."""
        us = self.n2u @ Y0s.to(self.n2u.dtype)
        n = Y0s.shape[0]
        st = State(
            data=_expand(state.data, n), reward=state.reward.expand(n),
            info={k: v.expand(n, *v.shape[1:]) for k, v in state.info.items()},
        )
        rews, xs = [], []
        for t in range(us.shape[1]):
            st = self.task.step(st, us[:, t])
            rews.append(st.reward)
            xs.append(st.data.x_pos)
        return torch.stack(rews, dim=1), torch.stack(xs, dim=1)

    def weights(self, rews: torch.Tensor) -> torch.Tensor:
        """The update's softmax weights of the mean rewards (N+1,): a
        non-finite reward gets weight 0; if all are, the mean plan's row
        takes all the weight (the plan stays)."""
        finite = torch.isfinite(rews)
        zero = torch.zeros((), **self.kw)
        center = torch.where(torch.isfinite(rews[-1]), rews[-1], zero)
        n_finite = finite.sum()
        mean = torch.where(finite, rews, zero).sum() / n_finite
        std = torch.sqrt(torch.where(finite, (rews - mean) ** 2, zero).sum() / n_finite)
        std = torch.where(torch.isfinite(std) & (std > 0), std, torch.ones_like(std))
        logp0 = torch.where(finite, (rews - center) / std / self.temp_sample, torch.full_like(rews, -torch.inf))
        weights = torch.softmax(logp0, dim=0)
        keep_plan = torch.zeros_like(weights)
        keep_plan[-1] = 1.0
        return torch.where(finite.any(), weights, keep_plan)

    def update(self, rews: torch.Tensor, Y0s: torch.Tensor, xss: torch.Tensor):
        """The softmax-weighted update: the new plan, the weighted body
        positions (rollouts of non-finite reward count 0) and the count of
        rollouts given no weight."""
        weights = self.weights(rews)
        finite = torch.isfinite(rews)
        xss = torch.where(finite[:, None, None, None], xss, torch.zeros_like(xss))
        Ybar = torch.einsum("n,nij->ij", weights, Y0s)
        xbar = torch.einsum("n,nijk->ijk", weights, xss)
        return Ybar, xbar, int((~finite).sum())

    def advance(self, state: State, Y: torch.Tensor) -> State:
        """The executed step under the plan's first node; a state that comes
        out non-finite is kept as it was."""
        new = self.task.step(state, Y[:1])
        ok = bool(torch.isfinite(new.data.qpos).all() & torch.isfinite(new.data.qvel).all())
        return new if ok else state.replace(info=new.info)


def _expand(d, n):
    import dataclasses

    kw = {}
    for f in dataclasses.fields(d):
        v = getattr(d, f.name)
        if isinstance(v, torch.Tensor):
            kw[f.name] = v.expand(n, *v.shape[1:])
    if d.contact is not None:
        ckw = {name: getattr(d.contact, name).expand(n, *getattr(d.contact, name).shape[1:])
               for name in ("dist", "pos", "frame") if getattr(d.contact, name) is not None}
        kw["contact"] = dataclasses.replace(d.contact, **ckw)
    return dataclasses.replace(d, **kw)
