"""Small-matrix linear algebra for batches of SPD systems (n <= ~30).

The factorization is written out column by column with the pivot clamp the
physics relies on (a pivot below 1e-12 is raised to it instead of failing),
so a batch with one degenerate sample still returns finite factors for the
others. Every step is one tensor op over the batch.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of SPD A (..., n, n) with clamped pivots."""
    n = A.shape[-1]
    L = torch.zeros_like(A)
    for j in range(n):
        Lj = L[..., j, :j]
        s = A[..., j, j] - (Lj * Lj).sum(-1)
        d = torch.sqrt(s.clamp_min(_EPS))
        L[..., j, j] = d
        if j + 1 < n:
            col = A[..., j + 1 :, j] - (L[..., j + 1 :, :j] * Lj[..., None, :]).sum(-1)
            L[..., j + 1 :, j] = col / d[..., None]
    return L


def solve_lower(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L y = b with L lower-triangular (..., n, n), b (..., n)."""
    n = L.shape[-1]
    y = torch.zeros_like(b)
    for i in range(n):
        s = b[..., i] - (L[..., i, :i] * y[..., :i]).sum(-1)
        y[..., i] = s / L[..., i, i]
    return y


def solve_upper_t(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L^T x = b with L lower-triangular (..., n, n), b (..., n)."""
    n = L.shape[-1]
    x = torch.zeros_like(b)
    for i in range(n - 1, -1, -1):
        s = b[..., i] - (L[..., i + 1 :, i] * x[..., i + 1 :]).sum(-1)
        x[..., i] = s / L[..., i, i]
    return x


def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given the lower Cholesky factor of A."""
    return solve_upper_t(L, solve_lower(L, b))


def solve_pd(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve SPD A x = b via the clamped factorization."""
    return cho_solve(cholesky(A), b)
