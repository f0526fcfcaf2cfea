"""Sample-axis sharded DIAL-MPC planner over a process group.

The sample axis is split over a 1-D mesh of ranks (one process per device,
``parallel/distributed.py``):

- each rank rolls out ``Nsample / world`` noised trajectories, plus the
  current mean plan (replicated) as the last row of its local batch;
- the MPPI reduction (mean/std normalisation, the log-sum-exp-stable
  softmax, the weighted averages of the node plans and body positions) is
  exact over the global sample set through ``all_reduce`` (SUM and MAX)
  collectives: no rank holds the whole batch;
- every rank's generator is seeded alike and draws the level's FULL
  ``(Nsample, Hnode+1, nu)`` block, then takes its own rows, so the draw is
  the same on any number of ranks (and is the draw ``MBDPI`` makes from the
  same generator).

The arithmetic of the reduction is the JAX package's sharded one (a one-pass
variance over the finite samples and the mean row, the mean row's weight
split evenly over the ranks), not ``MBDPI``'s softmax; the two agree to the
rounding of their sums. ``info["rews"]`` is the global ``(Nsample,)`` vector
of the samples' rewards: the mean row's reward is not in it (``MBDPI``'s has
it last). ``info["n_dropped"]`` counts what ``MBDPI``'s counts, the mean row
included.

A level reads nothing back to the host: on NCCL the collectives stay on the
device; gloo copies a CUDA tensor through the host inside the collective.
Every rank ends a level with the same plan, bit for bit, since each computes
it from the same reduced values.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from dial_mpc_tpu_torch.core.dial_config import DialConfig
from dial_mpc_tpu_torch.core.dial_core import MBDPI, rollout_us
from dial_mpc_tpu_torch.envs.base_env import expand_state


@dataclass(frozen=True)
class SampleMesh:
    """The 1-D mesh the sample axis is split over: a process group, this
    process's rank in it, and its size."""

    group: object
    rank: int
    size: int


def global_sample_mesh() -> SampleMesh:
    """The 1-D sample mesh over every rank of the started process group."""
    if not dist.is_initialized():
        raise RuntimeError("the sample mesh needs a process group: call parallel.init_distributed first")
    return SampleMesh(dist.group.WORLD, dist.get_rank(), dist.get_world_size())


class ShardedMBDPI(MBDPI):
    """``MBDPI`` with the sample axis split over a mesh; the same surface.

    Only ``reverse_once`` differs; ``control_step`` (env advance with the
    divergence freeze, shift, levels) runs replicated on every rank.
    ``collectives`` counts the collectives this planner issued.
    """

    def __init__(
        self, args: DialConfig, env, mesh: SampleMesh, generator: Optional[torch.Generator] = None
    ):
        if args.Nsample % mesh.size:
            raise ValueError(f"the mesh size {mesh.size} must divide Nsample={args.Nsample}")
        super().__init__(args, env, generator)
        self.mesh = mesh
        self.local_samples = args.Nsample // mesh.size
        self.collectives = 0

    def _all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        dist.all_reduce(t, op=op, group=self.mesh.group)
        self.collectives += 1
        return t

    def reverse_once(
        self, state, Ybar_i: torch.Tensor, noise_scale: torch.Tensor,
        eps: Optional[torch.Tensor] = None,
    ):
        """One annealing level over the mesh. state is B = 1 and replicated;
        ``eps`` is the level's full (Nsample, Hnode+1, nu) draw."""
        args, n_loc = self.args, self.local_samples
        lo = self.mesh.rank * n_loc
        # the full block (first node pinned, then clipped; the clipped mean
        # last), of which this rank rolls out its rows and the mean row
        Y0s_all = self.sample_nodes(Ybar_i, noise_scale, eps)
        Y0s_aug = torch.cat([Y0s_all[lo : lo + n_loc], Y0s_all[-1:]])
        us = self.node2u(Y0s_aug)
        rewss, xss = rollout_us(self.env.step, expand_state(state, n_loc + 1), us)

        rews_all = rewss.mean(dim=-1)  # (local+1,)
        rews, rew_bar = rews_all[:-1], rews_all[-1]
        zero = torch.zeros_like(rew_bar)

        # one SUM: the finite count, the sums of the finite rewards and of
        # their squares, and the global reward vector (this rank's slice
        # filled, zero elsewhere)
        finite = torch.isfinite(rews)
        rews_f = torch.where(finite, rews, zero)
        packed = torch.zeros(3 + args.Nsample, dtype=rews.dtype, device=rews.device)
        packed[0] = finite.sum()
        packed[1] = rews_f.sum()
        packed[2] = (rews_f**2).sum()
        packed[3 + lo : 3 + lo + n_loc] = rews
        self._all_reduce(packed)
        # the mean row once, finite or not
        n_tot = packed[0] + 1.0
        s1 = packed[1] + rew_bar
        s2 = packed[2] + rew_bar**2
        mean = s1 / n_tot
        std = torch.sqrt(torch.clamp_min(s2 / n_tot - mean**2, 0.0))

        # softmax is shift-invariant: center on the mean row's reward when it
        # is finite, 0 otherwise (a non-finite mean must not poison the
        # finite samples' weights: it just gets -inf itself)
        bar_finite = torch.isfinite(rew_bar)
        center = torch.where(bar_finite, rew_bar, zero)
        std = torch.where(torch.isfinite(std) & (std > 0), std, torch.ones_like(std))
        neg_inf = torch.full_like(rews, -torch.inf)
        logp = torch.where(finite, (rews - center) / std / args.temp_sample, neg_inf)
        logp_bar = torch.where(bar_finite, zero, neg_inf[0])

        # log-sum-exp-stable softmax over the global set
        gmax = self._all_reduce(logp.max()[None], dist.ReduceOp.MAX)[0]
        gmax = torch.maximum(gmax, logp_bar)
        gmax = torch.where(torch.isfinite(gmax), gmax, zero)
        e = torch.exp(logp - gmax)
        e_bar = torch.exp(logp_bar - gmax)
        denom = self._all_reduce(e.sum()[None])[0] + e_bar
        # degradation: if EVERY rollout (mean included) exploded, keep the
        # current plan (all weight on the replicated mean row)
        all_bad = denom == 0.0
        safe = torch.clamp_min(denom, 1e-30)
        w = torch.where(all_bad, zero, e / safe)
        w_bar = torch.where(all_bad, torch.ones_like(zero), e_bar / safe)

        # weighted sums through one SUM. The replicated mean row is the last
        # row on every rank; its weight w_bar / world makes the sum add it
        # once. Zero-weight (non-finite) samples are zeroed so that 0 * nan
        # never leaks; the mean row is always taken.
        w_aug = torch.cat([torch.where(finite, w, zero), (w_bar / self.mesh.size)[None]])
        keep = torch.cat([finite, torch.ones_like(finite[:1])])
        Y_loc = torch.einsum("n,nij->ij", w_aug, torch.where(keep[:, None, None], Y0s_aug, 0.0))
        x_loc = torch.einsum("n,nijk->ijk", w_aug, torch.where(keep[:, None, None, None], xss, 0.0))
        plan = self._all_reduce(torch.cat([Y_loc.reshape(-1), x_loc.reshape(-1)]))
        Ybar = plan[: Y_loc.numel()].reshape(Y_loc.shape)
        xbar = plan[Y_loc.numel() :].reshape(x_loc.shape)

        # the rollouts the guard gave zero weight, the mean row included
        n_dropped = (args.Nsample - packed[0]).round().long() + (~bar_finite).long()
        info = {
            "rews": packed[3:],
            "xbar": xbar,
            "new_noise_scale": noise_scale,
            "n_dropped": n_dropped,
        }
        return Ybar, info
