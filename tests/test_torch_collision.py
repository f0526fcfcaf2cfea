"""The port's pair functions against the JAX package's, at float64.

Each case draws its geometry from a seed with numpy and hands the same
arrays to both sides: the JAX function runs per sample under ``jax.vmap``,
the port's batched. Besides random poses, the cases put the inputs where a
branch turns: a capsule axis about parallel to the plane normal (the frame
fallback), sphere centres inside a box (and at its centre, where the gaps
tie), boxes resting flat (corners at exactly equal depth, where the slot
order under ties must be the reference's).

Run with:  python -m pytest tests/test_torch_collision.py -q
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dial_mpc_tpu.physics import collision as jcol

from dial_mpc_tpu_torch.physics import collision as tcol

B = 64
TOL = 1e-12


def _rot(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack(
        [
            np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        -2,
    )


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _compare(got, ref, what):
    for name, g, r in zip(("dist", "pos", "frame"), got, ref):
        g, r = g.numpy(), np.asarray(r)
        assert g.shape == r.shape, (what, name, g.shape, r.shape)
        np.testing.assert_allclose(g, r, atol=TOL, rtol=0, err_msg=f"{what}: {name}")


def _t(*arrays):
    return [torch.tensor(np.asarray(a, np.float64)) for a in arrays]


# ---------------------------------------------------------------------------
# plane-capsule and its frame
# ---------------------------------------------------------------------------

def _capsule_axes(rng, pn, kind):
    if kind == "random":
        return _unit(rng, B)
    if kind == "parallel":  # exactly along the normal, or against it
        return pn * np.where(rng.uniform(size=(B, 1)) < 0.5, 1.0, -1.0)
    # near-parallel: the projected axis on either side of the 1e-10 cut
    eps = 10.0 ** rng.uniform(-13, -8, (B, 1))
    a = pn + eps * _unit(rng, B)
    return a / np.linalg.norm(a, axis=1, keepdims=True)


@pytest.mark.parametrize("kind", ["random", "parallel", "near_parallel"])
def test_plane_capsule_matches_jax(kind):
    rng = np.random.default_rng({"random": 1, "parallel": 2, "near_parallel": 3}[kind])
    pp, pn = rng.normal(size=(B, 3)), _unit(rng, B)
    c, axis = rng.normal(size=(B, 3)), _capsule_axes(rng, pn, kind)
    r, hl = 0.05, 0.2
    got = tcol._plane_capsule(*_t(pp, pn, c, axis), r, hl)
    ref = jax.vmap(lambda a, b, x, y: jcol._plane_capsule(a, b, x, y, r, hl))(
        *[jnp.asarray(v) for v in (pp, pn, c, axis)]
    )
    _compare(got, ref, f"plane-capsule {kind}")
    if kind == "parallel":  # the fallback frame is orthonormal
        frames = got[2].numpy()
        assert np.isfinite(frames).all()
        np.testing.assert_allclose(np.einsum("bsij,bskj->bsik", frames, frames), np.broadcast_to(np.eye(3), frames.shape), atol=1e-9)


def test_axis_frame_matches_jax_and_make_frame_matches_jax():
    rng = np.random.default_rng(4)
    n = _unit(rng, B)
    axis = np.concatenate([_unit(rng, B // 2), n[B // 2:]])
    got = tcol.axis_frame(*_t(n, axis))
    ref = jax.vmap(jcol.axis_frame)(jnp.asarray(n), jnp.asarray(axis))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)
    np.testing.assert_allclose(
        tcol.make_frame(torch.tensor(n)).numpy(), np.asarray(jax.vmap(jcol.make_frame)(jnp.asarray(n))), atol=TOL
    )


# ---------------------------------------------------------------------------
# box pairs
# ---------------------------------------------------------------------------

def _box(rng, n, flat=False):
    """Centres, frames and one size of n boxes; flat boxes are axis-aligned
    (or turned a quarter about z), so that faces lie level."""
    c = rng.normal(size=(n, 3))
    if flat:
        quarter = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
        mats = np.where((rng.uniform(size=(n, 1, 1)) < 0.5), np.eye(3), quarter)
    else:
        mats = _rot(rng, n)
    return c, mats, np.array([0.3, 0.2, 0.15])


@pytest.mark.parametrize("flat", [False, True], ids=["random", "resting_flat"])
def test_plane_box_matches_jax(flat):
    rng = np.random.default_rng(5 + flat)
    bc, bmat, size = _box(rng, B, flat)
    if flat:  # a level floor: the four bottom corners tie
        pp, pn = np.zeros((B, 3)), np.tile([0.0, 0.0, 1.0], (B, 1))
    else:
        pp, pn = rng.normal(size=(B, 3)), _unit(rng, B)
    got = tcol._plane_box(*_t(pp, pn, bc, bmat, size))
    ref = jax.vmap(lambda a, b, x, y: jcol._plane_box(a, b, x, y, jnp.asarray(size)))(
        *[jnp.asarray(v) for v in (pp, pn, bc, bmat)]
    )
    _compare(got, ref, "plane-box")
    if flat:
        d = got[0].numpy()
        assert (d == d[:, :1]).all(), "a box resting flat has four corners at one depth"


def _sphere_centres(rng, bc, bmat, size, where):
    if where == "outside":
        return bc + rng.normal(size=bc.shape) * 0.6
    if where == "centre":  # the box's centre: every gap ties
        return bc.copy()
    local = rng.uniform(-1, 1, bc.shape) * size * 0.9  # inside, off centre
    if where == "inside_on_axis":  # a zero local coordinate: the face sign is +
        local[:, 0] = 0.0
        local[:, 1] = 0.0
    return bc + np.einsum("bij,bj->bi", bmat, local)


@pytest.mark.parametrize("where", ["outside", "inside", "inside_on_axis", "centre"])
def test_sphere_box_matches_jax(where):
    rng = np.random.default_rng(["outside", "inside", "inside_on_axis", "centre"].index(where) + 12)
    bc, bmat, size = _box(rng, B)
    if where == "centre":
        size = np.array([0.2, 0.2, 0.2])
    c1 = _sphere_centres(rng, bc, bmat, size, where)
    r = 0.05
    got = tcol._sphere_box(*_t(c1), r, *_t(bc, bmat, size))
    ref = jax.vmap(lambda x, b, m: jcol._sphere_box(x, r, b, m, jnp.asarray(size)))(
        jnp.asarray(c1), jnp.asarray(bc), jnp.asarray(bmat)
    )
    _compare(got, ref, f"sphere-box {where}")
    d = got[0].numpy()
    assert (d < 0).all() if where != "outside" else (d > 0).any()


def test_capsule_box_matches_jax():
    rng = np.random.default_rng(9)
    bc, bmat, size = _box(rng, B)
    c1 = bc + rng.normal(size=(B, 3)) * 0.3
    a1 = _unit(rng, B)
    r, hl = 0.04, 0.25
    got = tcol._capsule_box(*_t(c1, a1), r, hl, *_t(bc, bmat, size))
    ref = jax.vmap(lambda x, a, b, m: jcol._capsule_box(x, a, r, hl, b, m, jnp.asarray(size)))(
        *[jnp.asarray(v) for v in (c1, a1, bc, bmat)]
    )
    _compare(got, ref, "capsule-box")
    assert (got[0].numpy() < 0).any() and (got[0].numpy() > 0).any()


@pytest.mark.parametrize("kind", ["random", "stacked_flat"])
def test_box_box_matches_jax(kind):
    """16 corner candidates, the deepest 8. Stacked flat boxes put corners at
    equal depths (ties) and corners exactly on a face."""
    rng = np.random.default_rng(10 if kind == "random" else 11)
    s1, s2 = np.array([0.3, 0.2, 0.15]), np.array([0.25, 0.35, 0.1])
    if kind == "random":
        c1, m1, _ = _box(rng, B)
        m2 = _rot(rng, B)
        c2 = c1 + rng.normal(size=(B, 3)) * 0.3
    else:
        c1 = rng.normal(size=(B, 3))
        m1 = m2 = np.tile(np.eye(3), (B, 1, 1))
        c2 = c1 + np.stack([rng.uniform(-0.1, 0.1, B), rng.uniform(-0.1, 0.1, B),
                            np.full(B, 0.25) - rng.uniform(0, 0.02, B)], 1)
    got = tcol._box_box(*_t(c1, m1, s1, c2, m2, s2))
    ref = jax.vmap(lambda a, b, x, y: jcol._box_box(a, b, jnp.asarray(s1), x, y, jnp.asarray(s2)))(
        *[jnp.asarray(v) for v in (c1, m1, c2, m2)]
    )
    _compare(got, ref, f"box-box {kind}")
    if kind == "stacked_flat":
        d = got[0].numpy()
        assert (np.diff(d, axis=1) == 0).any(), "the stacked case must hold equal depths"


# ---------------------------------------------------------------------------
# sphere and capsule pairs (the Allegro hand: ball on fingertips, fingertips
# on each other)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["random", "coincident"])
def test_sphere_sphere_matches_jax(kind):
    """Random centres, and centres that coincide (the normal's 1e-15 guard)."""
    rng = np.random.default_rng({"random": 20, "coincident": 21}[kind])
    c1 = rng.normal(scale=0.05, size=(B, 3))
    c2 = c1.copy() if kind == "coincident" else c1 + rng.normal(scale=0.05, size=(B, 3))
    r1, r2 = 0.025, 0.012
    got = tcol._sphere_sphere(*_t(c1), r1, *_t(c2), r2)
    ref = jax.vmap(lambda a, b: jcol._sphere_sphere(a, r1, b, r2))(jnp.asarray(c1), jnp.asarray(c2))
    _compare(got, ref, f"sphere-sphere {kind}")


@pytest.mark.parametrize("kind", ["random", "beyond_ends", "on_axis"])
def test_sphere_capsule_matches_jax(kind):
    """Sphere centres anywhere, beyond either end of the capsule's segment
    (the clamp), and on its axis line."""
    rng = np.random.default_rng({"random": 22, "beyond_ends": 23, "on_axis": 24}[kind])
    c2, axis = rng.normal(scale=0.05, size=(B, 3)), _unit(rng, B)
    hl = 0.02
    if kind == "random":
        c1 = c2 + rng.normal(scale=0.04, size=(B, 3))
    else:
        t = rng.uniform(0.021, 0.06, (B, 1)) * np.where(rng.uniform(size=(B, 1)) < 0.5, 1.0, -1.0)
        if kind == "on_axis":
            t = rng.uniform(-0.019, 0.019, (B, 1))
        side = 0.0 if kind == "on_axis" else rng.normal(scale=0.01, size=(B, 3))
        c1 = c2 + axis * t + side
    r1, r2 = 0.025, 0.012
    got = tcol._sphere_capsule(*_t(c1), r1, *_t(c2, axis), r2, hl)
    ref = jax.vmap(lambda a, b, x: jcol._sphere_capsule(a, r1, b, x, r2, hl))(
        *[jnp.asarray(v) for v in (c1, c2, axis)]
    )
    _compare(got, ref, f"sphere-capsule {kind}")


@pytest.mark.parametrize("kind", ["random", "crossing", "parallel", "near_parallel", "antiparallel"])
def test_capsule_capsule_matches_jax(kind):
    """Random pairs, crossing segments (both clamps inactive), and parallel
    axes, exactly (1 - (a1.a2)^2 = 0, the branch that starts from s = 0),
    within rounding of it, and reversed."""
    rng = np.random.default_rng({"random": 25, "crossing": 26, "parallel": 27, "near_parallel": 28,
                                 "antiparallel": 29}[kind])
    c1, a1 = rng.normal(scale=0.03, size=(B, 3)), _unit(rng, B)
    hl1, hl2, r1, r2 = 0.02, 0.015, 0.012, 0.01
    if kind == "random":
        a2, c2 = _unit(rng, B), c1 + rng.normal(scale=0.03, size=(B, 3))
    elif kind == "crossing":
        a2 = _unit(rng, B)
        n = np.cross(a1, a2)
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        s, t = rng.uniform(-0.015, 0.015, (B, 1)), rng.uniform(-0.01, 0.01, (B, 1))
        c2 = c1 + a1 * s - a2 * t + n * rng.uniform(-0.03, 0.03, (B, 1))
    else:
        a2 = a1 * (-1.0 if kind == "antiparallel" else 1.0)
        if kind == "near_parallel":
            a2 = a2 + 10.0 ** rng.uniform(-9, -6, (B, 1)) * _unit(rng, B)
            a2 /= np.linalg.norm(a2, axis=1, keepdims=True)
        c2 = c1 + a1 * rng.uniform(-0.05, 0.05, (B, 1)) + rng.normal(scale=0.02, size=(B, 3))
    got = tcol._capsule_capsule(*_t(c1, a1), r1, hl1, *_t(c2, a2), r2, hl2)
    ref = jax.vmap(lambda a, b, x, y: jcol._capsule_capsule(a, b, r1, hl1, x, y, r2, hl2))(
        *[jnp.asarray(v) for v in (c1, a1, c2, a2)]
    )
    _compare(got, ref, f"capsule-capsule {kind}")
    if kind in ("parallel", "antiparallel"):
        b = np.abs((a1 * a2).sum(-1))
        assert (1.0 - b * b <= 1e-12).all(), "the parallel branch must be taken"
