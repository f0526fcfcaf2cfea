"""How ``correct`` is decided: the plain reference recomputes what the timed
path produced, stage by stage from the program's own inputs to each stage,
and each number compared is held to its limit (``limits/<workload>.json``;
a number without a limit there is printed, not compared).

For every control step of the window the harness keeps the executed step's
input state, plan and product (B = 1, small). For a sample of the window's
steps it keeps besides every call the step made of the env's physics step
(``pipeline_step``: the state and control it was given, the products it
returned), the rewards and body positions of every level, and the plan;
they leave the device after the step. The reference
(``port_bench/reference``) recomputes:

- ``advance_q50``: the executed step of every window step (the robot's own
  state, B = 1) from the program's input state, with the reference's own
  control from the plan's first node, in float64: the widest gap of qpos,
  and of qvel times dt, to the program's product; the median over the
  window's steps (``advance_max`` is printed). A step whose advance the
  program froze (its state did not advance in time) or whose state blew up
  is a failed step and is not judged here;
- ``physics_q50``, ``physics_q90``: each rollout physics call of a checked
  step (B = N + 1) from the program's input state, in float64: per sample
  the same gap; the median and the 90th percentile over every sample of
  the step's rollout calls (a sample whose state blew up on both sides
  agrees; on one side only, its gap is infinite; a step with no sample
  sound on both sides reads infinite). One env step at a time, so the gaps
  stay at rounding where rollouts of a violent state, chained over 21 env
  steps, part ways (``physics_max`` is printed). The median catches a step
  that is wrong everywhere, the 90th percentile one that is wrong for a
  tenth of the samples or more;
- ``rews``: every rollout's horizon-mean reward of every level, the
  reference's reward of each step taken from the program's physics
  products: the widest relative gap (to the reference's magnitude plus the
  distance between its quartiles); a rollout blown up (non-finite, or past
  EXPLODED) on both sides agrees, on one side only it fails;
- ``plan`` and ``xbar``: the plan after the levels and each level's weighted
  body positions, from the softmax-weighted update taken with the program's
  rewards and body positions, in float32, the configuration's precision
  (the update's guard drops a reward that overflows there): the widest gap.

The reference follows the program's own state from step to step (the state
before the step, each physics call's input, the rewards the update takes);
the start of the loop, the reset, is compared on its own (``reset``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from port_bench.reference.model import Contact, Data
from port_bench.reference.planner import Planner
from port_bench.reference.task import State
from port_bench.reference.tasks import make_task

EXPLODED = 1e30  # a reward beyond this is a rollout that blew up, as float32's overflow is


FIELDS = ("qpos", "qvel", "ctrl", "time", "site_xpos", "x_pos", "x_rot", "xd_vel", "xd_ang", "qacc")


@dataclasses.dataclass
class Products:
    """What a task's reward reads of a physics call's products, on the host."""

    qpos: torch.Tensor
    qvel: torch.Tensor
    ctrl: torch.Tensor
    time: torch.Tensor
    site_xpos: torch.Tensor
    x_pos: torch.Tensor
    x_rot: torch.Tensor
    xd_vel: torch.Tensor
    xd_ang: torch.Tensor
    qacc: torch.Tensor
    contact_dist: torch.Tensor
    contact_pos: torch.Tensor

    @classmethod
    def of(cls, d) -> "Products":
        """The products of a physics call (the program's or the reference's
        data), copied to the host."""
        host = lambda x: x.detach().to("cpu", copy=True)
        return cls(**{k: host(getattr(d, k)) for k in FIELDS},
                   contact_dist=host(d.contact.dist), contact_pos=host(d.contact.pos))


@dataclasses.dataclass
class Executed:
    """The executed step of each judged window step, stacked on the host:
    its episode step, input state and plan, and the program's product."""

    t: list
    qpos_in: torch.Tensor  # (steps, nq)
    qvel_in: torch.Tensor
    Y_in: torch.Tensor  # (steps, Hnode + 1, nu)
    qpos_out: torch.Tensor
    qvel_out: torch.Tensor


@dataclasses.dataclass
class StepRecord:
    """What the timed path took and produced in one control step, on the
    host. ``calls`` holds each physics call as (qpos, qvel, ctrl,
    Products) in call order: the executed step, then each level's
    Hsample + 1 rollout steps."""

    t: int  # control steps of the episode before this one: the state's step counter
    draw: int  # the step's index in the run, which keys its draws
    n_diffuse: int
    Y_in: torch.Tensor
    Y_out: torch.Tensor
    rews: torch.Tensor  # (levels, N + 1)
    xbar: torch.Tensor  # (levels, Hsample + 1, bodies, 3)
    calls: list

    @classmethod
    def of(cls, t, draw, n_diffuse, Y_in, Y_out, info, calls) -> "StepRecord":
        """A control step's record, copied to the host."""
        host = lambda x: x.detach().to("cpu", copy=True)
        return cls(t=t, draw=draw, n_diffuse=n_diffuse, Y_in=host(Y_in), Y_out=host(Y_out),
                   rews=host(info["rews"]), xbar=host(info["xbar"]),
                   calls=[(host(q), host(v), host(c), Products.of(o)) for q, v, c, o in calls])


def _f(x, dtype, device):
    return x.detach().to(device=device, dtype=dtype)


class _Place:
    """Where a planner's arithmetic runs, for a planner that rolls nothing out."""

    def __init__(self, device, dtype):
        self.device, self.dtype = device, dtype


def _max(a: float, b: float) -> float:
    """The larger, where a reading that is not a number counts as infinite."""
    a = float("inf") if a != a else a
    b = float("inf") if b != b else b
    return max(a, b)


class Judge:
    """The reference for one cell: its task at ``dtype`` on ``device``, and
    the planner's update at float32. ``n_sample`` is the traffic's samples a
    level."""

    def __init__(self, config: dict, n_sample: int, device, dtype=torch.float64):
        self.device, self.dtype = torch.device(device), dtype
        self.task = make_task(config, self.device, dtype)
        self.planner = Planner(config, self.task, n_sample)
        self.update = Planner(config, _Place(self.device, torch.float32), n_sample)

    def reset_gap(self, qpos: torch.Tensor, qvel: torch.Tensor, x_pos: torch.Tensor) -> float:
        """The widest gap of a reset state (qpos, qvel, body positions)."""
        r = self.task.reset().data
        return max(
            float((_f(qpos, self.dtype, self.device) - r.qpos).abs().max()),
            float((_f(qvel, self.dtype, self.device) - r.qvel).abs().max()),
            float((_f(x_pos, self.dtype, self.device) - r.x_pos).abs().max()),
        )

    def _data(self, out: Products) -> Data:
        """A physics call's products as the reference's Data (the fields the
        rewards read)."""
        dt, dev, m = self.dtype, self.device, self.task.sys
        contact = Contact(
            dist=_f(out.contact_dist, dt, dev), pos=_f(out.contact_pos, dt, dev), frame=None, geom=m.con_geom,
            includemargin=m.con_includemargin, friction=m.con_friction, solref=m.con_solref,
            solimp=m.con_solimp, dim=m.con_dim,
        )
        return Data(
            qpos=_f(out.qpos, dt, dev), qvel=_f(out.qvel, dt, dev), ctrl=_f(out.ctrl, dt, dev),
            time=_f(out.time, dt, dev), site_xpos=_f(out.site_xpos, dt, dev), x_pos=_f(out.x_pos, dt, dev),
            x_rot=_f(out.x_rot, dt, dev), xd_vel=_f(out.xd_vel, dt, dev), xd_ang=_f(out.xd_ang, dt, dev),
            qacc=_f(out.qacc, dt, dev), contact=contact,
        )

    def _state(self, qpos, qvel, step) -> State:
        """The states physics calls started from, at the episode's ``step``
        (one for all rows, or a list of one a row)."""
        st = self.task.state_at(_f(qpos[:1], self.dtype, self.device), _f(qvel[:1], self.dtype, self.device),
                                torch.zeros(1, dtype=self.dtype, device=self.device), 0)
        n = qpos.shape[0]
        data = Data(qpos=_f(qpos, self.dtype, self.device), qvel=_f(qvel, self.dtype, self.device),
                    ctrl=st.data.ctrl.expand(n, -1), time=st.data.time.expand(n))
        info = {k: v.expand(n, *v.shape[1:]) for k, v in st.info.items()}
        steps = step if isinstance(step, list) else [step] * n
        info["step"] = torch.tensor(steps, dtype=torch.int32, device=self.device)
        return State(data, st.reward.expand(n), info)

    def _walk(self, rec: StepRecord, eps: torch.Tensor, own: bool):
        """The step's stages from the record's inputs. With ``own`` False the
        rewards, plan and body positions take the program's physics products
        and rewards (the judge); with ``own`` True the reference's own (the
        control in the program's place). Returns per-call physics (program
        input, reference products), per-level reference rewards, plan, xbar."""
        task, pl, up = self.task, self.planner, self.update
        f32, dev = torch.float32, self.device
        calls = iter(rec.calls)
        Y = _f(rec.Y_in, f32, dev)
        qpos, qvel, _, out = next(calls)
        st = self._state(qpos, qvel, rec.t)
        ctrl = task.ctrl(st, _f(Y[:1], self.dtype, dev))
        physics = [(qpos, qvel, out, task.pipeline_step(st.data, ctrl))]
        Y = up.shift(Y)
        factors = up.diffuse_factors(rec.n_diffuse)
        rews, xbars = [], []
        for i in range(rec.n_diffuse):
            Y0s = up.sample_nodes(Y, factors[i], _f(eps[i], f32, dev))
            us = pl.n2u @ Y0s.to(self.dtype)
            r_steps, xs = [], []
            for t in range(us.shape[1]):
                qpos, qvel, _, out = next(calls)
                st = self._state(qpos, qvel, rec.t + 1 + t)
                ctrl = task.ctrl(st, us[:, t])
                d_ref = task.pipeline_step(st.data, ctrl)
                physics.append((qpos, qvel, out, d_ref))
                d = d_ref if own else self._data(out)
                r_steps.append(task.reward(st, d, ctrl))
                xs.append(d.x_pos)
            r = torch.stack(r_steps, dim=1).mean(-1)
            r_take = r if own else _f(rec.rews[i], self.dtype, dev)
            w = up.weights(r_take.to(f32))
            Y = torch.einsum("n,nij->ij", w, Y0s)
            # as the update does: the rollouts of non-finite reward count 0
            xss = torch.stack(xs, dim=1)
            taken = torch.isfinite(r_take)[:, None, None, None]
            xbars.append(torch.einsum("n,nijk->ijk", w.to(self.dtype), torch.where(taken, xss, torch.zeros_like(xss))))
            rews.append(r)
        return physics, torch.stack(rews), Y, torch.stack(xbars)

    def outputs(self, rec: StepRecord, eps: torch.Tensor) -> StepRecord:
        """The reference's own control step from the record's inputs, all of
        it at the judge's dtype: each physics call from the program's input
        state with the reference's own control, its rewards, its plan and
        body positions. This is what the control puts in the program's place."""
        physics, rews, Y, xbar = self._walk(rec, eps, own=True)
        calls = [(q, v, c, Products.of(d)) for (q, v, _, d), (_, _, c, _) in zip(physics, rec.calls)]
        return dataclasses.replace(rec, calls=calls, rews=rews, Y_out=Y, xbar=xbar)

    def executed_outputs(self, ex: Executed) -> Executed:
        """The reference's own executed steps from the program's inputs, at
        the judge's dtype: what the control puts in the program's place."""
        d = self._advance(ex)
        return dataclasses.replace(ex, qpos_out=d.qpos.cpu(), qvel_out=d.qvel.cpu())

    def _advance(self, ex: Executed) -> Data:
        """Every executed step of ``ex`` from its input state under the
        plan's first node, as one batch: the physics of a sample reads
        nothing of the others."""
        st = self._state(ex.qpos_in, ex.qvel_in, ex.t)
        ctrl = self.task.ctrl(st, _f(ex.Y_in[:, 0], self.dtype, self.device))
        return self.task.eager_step(st.data.qpos, st.data.qvel, ctrl)

    def advance_readings(self, ex: Executed) -> dict:
        """``advance_q50`` and ``advance_max`` over the judged window steps."""
        if not ex.t:
            return {"advance_q50": float("nan"), "advance_max": float("nan")}
        dt, dev = self.dtype, self.device
        d = self._advance(ex)
        gaps = _gaps(_f(ex.qpos_out, dt, dev), _f(ex.qvel_out, dt, dev), d.qpos, d.qvel, self.task.dt)
        q50 = torch.quantile(gaps, 0.5, interpolation="higher")
        return {"advance_q50": float(q50), "advance_max": float(gaps.max())}

    def readings(self, rec: StepRecord, eps: torch.Tensor) -> dict:
        """The numbers compared for one checked step."""
        dt, dev, h = self.dtype, self.device, self.task.dt
        physics, rews_ref, Y, xbar = self._walk(rec, eps, own=False)
        gaps, judged = [], 0
        for _, _, out, d in physics[1:]:
            qpos, qvel = _f(out.qpos, dt, dev), _f(out.qvel, dt, dev)
            gaps.append(_gaps(qpos, qvel, d.qpos, d.qvel, h))
            judged += int((~_blown(qpos, qvel) & ~_blown(d.qpos, d.qvel)).sum())
        gaps = torch.cat(gaps)
        q = torch.quantile(gaps, torch.tensor([0.5, 0.9], dtype=dt, device=dev), interpolation="higher")
        if judged == 0:  # every sample blew up on both sides: the step judges nothing, and fails
            q = torch.full_like(q, float("inf"))
        rews = 0.0
        for i in range(rec.n_diffuse):
            rews = _max(rews, float(_reward_gaps(_f(rec.rews[i], dt, dev), rews_ref[i]).max()))
        return {
            "physics_q50": float(q[0]), "physics_q90": float(q[1]), "physics_max": float(gaps.max()),
            "rews": rews,
            "plan": float((_f(rec.Y_out, torch.float32, dev) - Y).abs().max()),
            "xbar": float(_agreeing_gap(_f(rec.xbar, dt, dev), xbar).max()),
        }


def _agreeing_gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b|, where values that are not finite on both sides agree and on
    one side only are infinitely apart."""
    gap = (a - b).abs()
    gap = torch.where(torch.isfinite(a) & torch.isfinite(b), gap, torch.full_like(gap, float("inf")))
    return torch.where(~torch.isfinite(a) & ~torch.isfinite(b), torch.zeros_like(gap), gap)


def _gaps(qpos, qvel, ref_qpos, ref_qvel, dt: float) -> torch.Tensor:
    """Per sample, the widest gap of qpos, and of qvel times dt; a sample
    blown up on both sides agrees (0), on one side only is infinitely apart."""
    g = torch.maximum((qpos - ref_qpos).abs().amax(-1), (qvel - ref_qvel).abs().amax(-1) * dt)
    blown_p, blown_r = _blown(qpos, qvel), _blown(ref_qpos, ref_qvel)
    g = torch.where(blown_p | blown_r, torch.zeros_like(g), g)
    return torch.where(blown_p != blown_r, torch.full_like(g, float("inf")), g)


def _blown(qpos: torch.Tensor, qvel: torch.Tensor) -> torch.Tensor:
    """The samples whose state blew up: a value not finite, or past EXPLODED."""
    x = torch.cat([qpos, qvel], dim=-1)
    return ~(torch.isfinite(x) & (x.abs() < EXPLODED)).all(-1)


def _reward_gaps(r_prog: torch.Tensor, r_ref: torch.Tensor) -> torch.Tensor:
    """Each rollout's relative reward gap: to the reference's magnitude plus
    the distance between the quartiles of its sane rewards. A rollout that
    blew up on both sides (non-finite, or beyond EXPLODED) agrees; on one
    side only, its gap is infinite."""
    sane_p = torch.isfinite(r_prog) & (r_prog.abs() < EXPLODED)
    sane_r = torch.isfinite(r_ref) & (r_ref.abs() < EXPLODED)
    spread = torch.ones((), dtype=r_ref.dtype, device=r_ref.device)
    if int(sane_r.sum()) >= 2:
        qs = torch.quantile(r_ref[sane_r], torch.tensor([0.25, 0.75], dtype=r_ref.dtype, device=r_ref.device))
        spread = (qs[1] - qs[0]).clamp_min(1e-12)
    scale = torch.where(sane_r, r_ref.abs(), torch.zeros_like(r_ref)) + spread
    gap = torch.where(sane_p & sane_r, (r_prog - r_ref).abs() / scale, torch.zeros_like(r_ref))
    return torch.where(sane_p != sane_r, torch.full_like(gap, float("inf")), gap)


def worst(readings: list) -> dict:
    """The widest reading of each number over the checked steps; one that is
    not a number counts as infinite."""
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = _max(out.get(k, 0.0), v)
    return out


def verdict(readings: dict, limits: dict) -> tuple:
    """(correct, [(name, reading, limit)]) over the numbers that have a
    limit; a reading that is not a finite number fails."""
    rows = []
    ok = True
    for name, lim in limits.items():
        v = readings.get(name, np.nan)
        limit = float(lim["limit"])
        ok = ok and bool(np.isfinite(v) and v <= limit)
        rows.append((name, v, limit))
    return ok, rows
