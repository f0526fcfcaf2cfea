"""Gait generation and frame-transform helpers (batch-first)."""

from __future__ import annotations

import math

import torch

from dial_mpc_tpu_torch.physics import maths


def global_to_body_velocity(v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """World-frame velocity -> body frame (rotate by q^-1)."""
    return maths.inv_rotate(v, q)


def get_foot_step(duty_ratio, cadence, amplitude, phases: torch.Tensor, time: torch.Tensor):
    """Target foot heights: clipped-cosine swing profile per leg.

    duty_ratio is the fraction of the cycle on the ground, cadence in Hz,
    amplitude the swing apex height (Python floats); phases (nleg,) are the
    per-leg phase offsets in [0, 1); time is (B,). Returns (B, nleg).
    """
    t = (time * 2 * math.pi * cadence + math.pi)[:, None]
    footphase = 2 * math.pi * phases
    angle = torch.remainder(t + math.pi - footphase, 2 * math.pi) - math.pi
    if duty_ratio < 1:
        angle = angle * 0.5 / (1 - duty_ratio)
        value = torch.cos(torch.clamp(angle, -math.pi / 2, math.pi / 2))
    else:
        value = torch.zeros_like(angle)
    value = torch.where(value.abs() >= 1e-6, value.abs(), torch.zeros_like(value))
    return amplitude * value
