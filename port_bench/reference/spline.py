"""Fixed-knot quadratic interpolating splines as precomputed linear maps.

The public, verifiable target is
``scipy.interpolate.InterpolatedUnivariateSpline(x, y, k=2)``.

Spline *fitting* and *evaluation at fixed queries* are both linear in the
data values, so for the fixed time grids used throughout DIAL-MPC the whole
transform collapses to one precomputed matrix:

    u = node2u_mat @ nodes        # (Hsample+1, Hnode+1) @ (Hnode+1, nu)

Batched over thousands of samples this is a single matrix product.

Construction matches FITPACK's interpolating quadratic spline: clamped
knot vector with interior knots at data midpoints
(t = [x0 x0 x0, (x1+x2)/2 ... , xn xn xn]), coefficients from the
collocation solve. Out-of-range queries extrapolate the end polynomial
pieces (scipy ext=0 behavior).
"""

from __future__ import annotations

import numpy as np

DEGREE = 2  # quadratic splines throughout


def fitpack_knots(x: np.ndarray, k: int = DEGREE) -> np.ndarray:
    """Clamped interpolation knot vector (FITPACK layout for even k)."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    if n < k + 1:
        raise ValueError(f"need at least {k + 1} data points for degree {k}")
    if k != 2:
        raise NotImplementedError("only quadratic (k=2) splines are used")
    interior = (x[1:-2] + x[2:-1]) / 2.0 if n > 3 else np.zeros(0)
    return np.concatenate([np.repeat(x[0], k + 1), interior, np.repeat(x[-1], k + 1)])


def _deboor_np(t: np.ndarray, c: np.ndarray, q: float, p: int = DEGREE) -> float:
    """Scalar de Boor evaluation with end-piece polynomial extrapolation."""
    m = int(np.clip(np.searchsorted(t, q, side="right") - 1, p, len(t) - p - 2))
    d = [c[j + m - p] for j in range(p + 1)]
    for r in range(1, p + 1):
        for j in range(p, r - 1, -1):
            denom = t[j + 1 + m - r] - t[j + m - p]
            alpha = (q - t[j + m - p]) / denom
            d[j] = (1.0 - alpha) * d[j - 1] + alpha * d[j]
    return d[p]


def coefficient_matrix(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(knots, K) with c = K @ y: data values -> B-spline coefficients."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    t = fitpack_knots(x)
    # collocation matrix B[i, j] = N_j(x_i), built column-wise via de Boor
    B = np.zeros((n, n))
    for j in range(n):
        e = np.zeros(n)
        e[j] = 1.0
        for i in range(n):
            B[i, j] = _deboor_np(t, e, x[i])
    return t, np.linalg.solve(B, np.eye(n))


def interp_matrix(x: np.ndarray, xq: np.ndarray) -> np.ndarray:
    """S with S @ y = spline(xq): the full fit+eval linear map."""
    x = np.asarray(x, dtype=np.float64)
    xq = np.asarray(xq, dtype=np.float64)
    n = x.shape[0]
    t, K = coefficient_matrix(x)
    S = np.zeros((xq.shape[0], n))
    for qi, q in enumerate(xq):
        for j in range(n):
            e = np.zeros(n)
            e[j] = 1.0
            S[qi, j] = _deboor_np(t, e, q)
    return S @ K
