"""DIAL-MPC planner core: annealed MPPI over spline-node trajectories.

- The node<->control spline transforms are precomputed linear maps
  (utils/spline.py), so sampling + interpolation + weighting are batched
  matrix products instead of per-sample banded solves.
- ``control_step(state, Y, n_diffuse)`` runs env advance + plan shift + the
  full Ndiffuse annealing loop without a host round trip: nothing in it
  reads a tensor back, so the host only enqueues work.
- The planner's own state is a batch of one; rollouts expand it to
  ``Nsample + 1`` samples (the last row is the current mean plan).

Noise comes from a ``torch.Generator`` on the planner's device. It cannot
reproduce another framework's stream, so ``sample_nodes`` also accepts the
standard-normal draw itself (``eps``) for tests that replay a reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from dial_mpc_tpu_torch.core.dial_config import DialConfig
from dial_mpc_tpu_torch.envs.base_env import expand_state, map_data
from dial_mpc_tpu_torch.utils.spline import FixedSpline


def rollout_us(step_env, state, us: torch.Tensor):
    """Roll dense control sequences (N, H, nu) through the environment.

    Returns rewards (N, H) and the stacked body positions (N, H, nbody-1, 3).
    """
    rews, xs = [], []
    for t in range(us.shape[1]):
        state = step_env(state, us[:, t])
        rews.append(state.reward)
        xs.append(state.pipeline_state.x_pos)
    return torch.stack(rews, dim=1), torch.stack(xs, dim=1)


class MBDPI:
    """Model-Based Diffusion Planner with annealed MPPI updates."""

    def __init__(self, args: DialConfig, env, generator: Optional[torch.Generator] = None):
        self.args = args
        self.env = env
        self.nu = env.action_size
        self.device = env.device
        self.dtype = env.dtype
        self.generator = generator

        if args.update_method != "mppi":
            raise ValueError(f"unknown update_method {args.update_method!r}")

        kw = dict(device=self.device, dtype=self.dtype)
        # per-node noise schedule
        self.sigma_control = torch.tensor(
            args.horizon_diffuse_factor ** np.arange(args.Hnode + 1)[::-1] * args.sigma_scale, **kw
        )

        # spline time grids; ctrl_dt is the fixed 0.02 of the shipped
        # configs (they keep dt: 0.02 in sync)
        self.ctrl_dt = 0.02
        self.step_us = np.linspace(0, self.ctrl_dt * args.Hsample, args.Hsample + 1)
        self.step_nodes = np.linspace(0, self.ctrl_dt * args.Hsample, args.Hnode + 1)
        self.node_dt = self.ctrl_dt * args.Hsample / args.Hnode

        # precomputed spline transforms (node->dense and dense->node)
        self.n2u = FixedSpline(self.step_nodes, self.step_us, **kw)
        self.u2n = FixedSpline(self.step_us, self.step_nodes, **kw)

    # -- spline transforms (batched linear maps) ----------------------------

    def node2u(self, nodes: torch.Tensor) -> torch.Tensor:
        """(..., Hnode+1, nu) -> (..., Hsample+1, nu)."""
        return self.n2u.apply(nodes)

    def u2node(self, us: torch.Tensor) -> torch.Tensor:
        """(..., Hsample+1, nu) -> (..., Hnode+1, nu)."""
        return self.u2n.apply(us)

    # -- one annealing level ------------------------------------------------

    def sample_nodes(
        self, Ybar_i: torch.Tensor, noise_scale: torch.Tensor, eps: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """The level's noised node trajectories, (Nsample+1, Hnode+1, nu).

        ``eps`` is the standard-normal draw of shape (Nsample, Hnode+1, nu);
        when it is None it is drawn from the planner's generator.
        """
        shape = (self.args.Nsample, self.args.Hnode + 1, self.nu)
        if eps is None:
            eps = torch.randn(shape, generator=self.generator, device=self.device, dtype=self.dtype)
        elif tuple(eps.shape) != shape:
            raise ValueError(f"eps must have shape {shape}, got {tuple(eps.shape)}")
        Y0s = eps * noise_scale[None, :, None] + Ybar_i
        # first node is pinned: it is already being executed
        # (Y0s is this call's own tensor, so the assignment aliases nothing)
        Y0s[:, 0] = Ybar_i[0]
        # evaluate the current mean alongside the samples
        Y0s = torch.cat([Y0s, Ybar_i[None]], dim=0)
        return torch.clamp(Y0s, -1.0, 1.0)

    def reverse_once(
        self, state, Ybar_i: torch.Tensor, noise_scale: torch.Tensor,
        eps: Optional[torch.Tensor] = None,
    ):
        """Sample -> rollout -> softmax-weighted update. state is B = 1."""
        Y0s = self.sample_nodes(Ybar_i, noise_scale, eps)
        us = self.node2u(Y0s)  # (Nsample+1, Hsample+1, nu): one matmul

        rewss, xss = rollout_us(self.env.step, expand_state(state, Y0s.shape[0]), us)
        rew_Ybar_i = rewss[-1].mean()
        rews = rewss.mean(dim=-1)
        # A rare exploding rollout (e.g. violent contact states) must not
        # poison the softmax: non-finite rewards get zero weight (identical
        # arithmetic when all are finite). Softmax is shift-invariant, so
        # centering on rew_Ybar is a no-op mathematically; the CENTER itself
        # is guarded so a non-finite MEAN rollout cannot poison the finite
        # samples' weights.
        finite = torch.isfinite(rews)
        zero = torch.zeros_like(rew_Ybar_i)
        center = torch.where(torch.isfinite(rew_Ybar_i), rew_Ybar_i, zero)
        # population std (ddof 0) over the finite rewards
        n_finite = finite.sum()
        mean = torch.where(finite, rews, zero).sum() / n_finite
        std = torch.sqrt(torch.where(finite, (rews - mean) ** 2, zero).sum() / n_finite)
        std = torch.where(torch.isfinite(std) & (std > 0), std, torch.ones_like(std))
        logp0 = torch.where(
            finite, (rews - center) / std / self.args.temp_sample, torch.full_like(rews, -torch.inf)
        )

        weights = torch.softmax(logp0, dim=0)
        # degradation: if EVERY rollout (mean included) exploded, keep the
        # current plan: weights collapse to the mean row, whose Y0s entry
        # is the (finite, clipped) Ybar itself
        keep_plan = torch.zeros_like(weights)
        keep_plan[-1] = 1.0
        weights = torch.where(finite.any(), weights, keep_plan)
        # zero-weight samples must contribute exactly zero (0 * nan = nan)
        xss = torch.where(finite[:, None, None, None], xss, torch.zeros_like(xss))
        Ybar = torch.einsum("n,nij->ij", weights, Y0s)
        # xbar (weighted body-position rollout) feeds the prediction telemetry
        xbar = torch.einsum("n,nijk->ijk", weights, xss)

        # n_dropped: the rollouts the guard gave zero weight
        info = {"rews": rews, "xbar": xbar, "new_noise_scale": noise_scale, "n_dropped": (~finite).sum()}
        return Ybar, info

    # -- plan warm-start shift ---------------------------------------------

    def shift(self, Y: torch.Tensor) -> torch.Tensor:
        """Advance the plan one control step."""
        u = torch.roll(self.node2u(Y), -1, dims=0)  # roll returns a new tensor
        u[-1] = 0.0
        return self.u2node(u)

    def shift_Y_from_u(self, u: torch.Tensor, n_step: int) -> torch.Tensor:
        u = torch.roll(u, -n_step, dims=0)
        u[-n_step:] = 0.0
        return self.u2node(u)

    # -- annealing schedule -------------------------------------------------

    def diffuse_factors(self, n_diffuse: int) -> torch.Tensor:
        """(n_diffuse, Hnode+1) noise scales."""
        decay = self.args.traj_diffuse_factor ** torch.arange(
            n_diffuse, device=self.device, dtype=self.dtype
        )
        return self.sigma_control * decay[:, None]

    # -- control step ---------------------------------------------------------

    def control_step(
        self, state, Y: torch.Tensor, n_diffuse: int, eps: Optional[torch.Tensor] = None
    ) -> Tuple[object, torch.Tensor, dict]:
        """One receding-horizon step.

        env.step with the executing control, plan shift, then n_diffuse
        annealing levels. ``eps`` optionally gives every level's draw,
        (n_diffuse, Nsample, Hnode+1, nu). Returns (state', Y', info) where
        info stacks the levels' entries along a leading axis.
        """
        # failure degradation: if the physics advance diverges, freeze the
        # state instead of poisoning every subsequent solve; the annealing
        # levels then plan from the last finite state
        new_state = self.env.step(state, Y[:1])
        new_ps, old_ps = new_state.pipeline_state, state.pipeline_state
        ok = torch.isfinite(new_ps.qpos).all() & torch.isfinite(new_ps.qvel).all()
        state = new_state.replace(
            pipeline_state=map_data(lambda n, o: torch.where(ok, n, o), new_ps, old_ps),
            reward=torch.where(ok, new_state.reward, state.reward),
        )
        Y = self.shift(Y)

        infos = []
        factors = self.diffuse_factors(n_diffuse)
        for i in range(n_diffuse):
            Y, info = self.reverse_once(state, Y, factors[i], None if eps is None else eps[i])
            infos.append(info)
        info = {k: torch.stack([inf[k] for inf in infos]) for k in infos[0]}
        return state, Y, info
