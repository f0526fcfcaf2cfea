"""The operations and bytes of one physics launch, counted from the scene.

A frozen copy of the port's ``physics/engine_cuda.py`` counts (``step_flops``,
its ``static_layout`` and the rows of ``out_specs``), computed here on the
reference's model of the scene so that the yardstick of the physics
roofline does not move with the program. ``launch_cost`` gives a launch's
floating-point operations (per sample and physics step, times both) and
bytes (each input and output row of each sample once, at the launch's
float width).
"""

from __future__ import annotations

import numpy as np

from port_bench.reference.constraint import elliptic_groups
from port_bench.reference.model import BOX, CAPSULE, PLANE, SPHERE, Model

FREE, BALL, SLIDE, HINGE = 0, 1, 2, 3

PAIR_KINDS = {
    (PLANE, SPHERE): 0,
    (PLANE, CAPSULE): 1,
    (PLANE, BOX): 2,
    (SPHERE, BOX): 3,
    (CAPSULE, BOX): 4,
    (BOX, BOX): 5,
    (SPHERE, SPHERE): 6,
    (SPHERE, CAPSULE): 7,
    (CAPSULE, CAPSULE): 8,
}


def out_specs(m: Model):
    """(name, row count) of the 11 outputs; counts are clamped to >= 1."""
    nbody1 = m.nbody - 1
    return [
        ("qpos", m.nq),
        ("qvel", m.nv),
        ("site_xpos", max(m.nsite * 3, 1)),
        ("site_xmat", max(m.nsite * 9, 1)),
        ("x_pos", nbody1 * 3),
        ("x_rot", nbody1 * 4),
        ("xd_vel", nbody1 * 3),
        ("xd_ang", nbody1 * 3),
        ("cdist", max(m.ncon, 1)),
        ("cpos", max(m.ncon, 1) * 3),
        ("qacc", m.nv),
    ]


def _fill_closed_pattern(mask: np.ndarray) -> np.ndarray:
    """Pattern of the Cholesky factor of P mask P^T, P reversing the order.

    Children-first elimination of a tree-structured pattern has no fill-in;
    whatever fill the constraint rows add is found symbolically here.
    """
    n = mask.shape[0]
    pat = mask[::-1, ::-1].astype(bool).copy()
    for j in range(n):
        below = [i for i in range(j + 1, n) if pat[i, j]]
        for a in range(len(below)):
            for b in range(a + 1, len(below)):
                pat[below[b], below[a]] = True
                pat[below[a], below[b]] = True
    return pat


def contact_rows(m: Model) -> list:
    """(slot, direction, reversed) of each contact row, in the plain version's
    order. Directions: 0 the normal, 1-2 the tangents, 3-5 the rotations
    about the frame's axes (condim 6). Elliptic cones give a slot of condim c
    c rows, the normal first; pyramidal cones give two facets n +/- mu_k d_k a
    direction (the + facet first): 4 rows at condim 3, 10 at condim 6."""
    rows = []
    for (g1, g2, t1, t2, condim, conadr, conmax) in m.pair_table:
        for slot in range(conadr, conadr + conmax):
            if m.opt.cone == 1:
                rows += [(slot, k, 0) for k in range(condim)]
            else:
                rows += [(slot, k, neg) for k in range(1, condim) for neg in (0, 1)]
    return rows


def static_layout(m: Model) -> dict:
    """Index tables and sparsity patterns of the kernel, as numpy arrays."""
    nv = m.nv
    chain = m.body_chain_mask.cpu().numpy() > 0
    anc = m.dof_ancestor_mask.cpu().numpy() > 0
    m_mask = anc | anc.T | np.eye(nv, dtype=bool)

    fric_dof = [i for i in range(nv) if m.dof_frictionloss_static[i] > 0]
    limit_jnt = []
    if not m.opt.disable_limit:
        limit_jnt = [
            j for j in range(m.njnt) if m.jnt_limited[j] and m.jnt_type[j] in (SLIDE, HINGE)
        ]
    cgeoms = sorted({g for p in m.pair_table for g in p[:2]})
    cg_index = {g: k for k, g in enumerate(cgeoms)}
    con_body1, con_body2, con_rot = [], [], []  # per contact slot
    for (g1, g2, t1, t2, condim, conadr, conmax) in m.pair_table:
        con_body1 += [m.geom_bodyid_static[g1]] * conmax
        con_body2 += [m.geom_bodyid_static[g2]] * conmax
        # the rotational Jacobians of the condim-6 slots, numbered in slot order
        for _ in range(conmax):
            con_rot.append(sum(r >= 0 for r in con_rot) if condim == 6 else -1)
    crows = contact_rows(m)

    # rows in the plain version's order: friction loss, limits, contacts
    sup = []
    for i in fric_dof:
        row = np.zeros(nv, dtype=bool)
        row[i] = True
        sup.append(row)
    for j in limit_jnt:
        row = np.zeros(nv, dtype=bool)
        row[m.jnt_dofadr[j]] = True
        sup.append(row)
    for slot, _, _ in crows:  # all rows of a slot share its support
        sup.append(chain[con_body1[slot]] | chain[con_body2[slot]])
    j_sup = np.array(sup, dtype=bool).reshape(len(sup), nv)
    h_mask = m_mask.copy()
    for row in j_sup:
        h_mask |= np.outer(row, row)

    return dict(
        fric_dof=np.array(fric_dof, dtype=np.int64),
        limit_jnt=np.array(limit_jnt, dtype=np.int64),
        cgeoms=cgeoms,
        pair_g1=np.array([cg_index[p[0]] for p in m.pair_table], dtype=np.int64),
        pair_g2=np.array([cg_index[p[1]] for p in m.pair_table], dtype=np.int64),
        pair_conadr=np.array([p[5] for p in m.pair_table], dtype=np.int64),
        pair_kind=np.array([PAIR_KINDS[p[2:4]] for p in m.pair_table], dtype=np.int64),
        con_body1=np.array(con_body1, dtype=np.int64),
        con_body2=np.array(con_body2, dtype=np.int64),
        con_rot=np.array(con_rot, dtype=np.int64),
        # contact rows packed slot << 4 | direction << 1 | reversed
        crow=np.array([(sl << 4) | (k << 1) | neg for sl, k, neg in crows], dtype=np.int64),
        groups=elliptic_groups(m),
        chain_mask=chain, m_mask=m_mask, h_mask=h_mask,
        m_pat=_fill_closed_pattern(m_mask), h_pat=_fill_closed_pattern(h_mask),
        j_sup=j_sup,
    )


def step_flops(m: Model) -> int:
    """Floating-point operations of one step of one sample, counted from the
    model's static structure the way the kernel walks it (an add, a multiply,
    a divide, a square root or a sine each count one). The Newton schedule is
    static, so the count does not depend on the data."""
    lay = static_layout(m)
    nv, nb, nefc = m.nv, m.nbody, lay["j_sup"].shape[0]
    cross, dot3, dot6, qmul, qrot, q2m = 9, 5, 11, 28, 30, 27
    n_free = sum(1 for t in m.jnt_type if t == FREE)
    n_slide = sum(1 for t in m.jnt_type if t == SLIDE)
    n_hinge = m.njnt - n_free - n_slide
    f = 0
    # kinematics, inertial frames, subtree CoM
    f += (nb - 1) * (qrot + 3 + qmul + 12) + n_free * 12 + n_hinge * (3 * qrot + qmul + 14)
    f += n_slide * (2 * qrot + 8)
    f += nb * (qrot + 3 + 3) + (nb - 1) * 3 + nb * 3
    # spatial inertias and dof subspaces
    f += nb * (3 + qmul + q2m + 9 * (5 + 2 + 6 + 2))
    f += n_free * (q2m + 3 + 3 * cross) + n_hinge * (3 + cross)
    # com velocities, RNE
    f += nv * (cross * 3 + 3 + 12) + (nb - 1) * (6 * 11 * 2 + 3 * cross + 6 + 6 + 6)
    f += nv * (12 + dot6)
    # CRB: composite inertias, F = I cdof, masked M entries
    f += (nb - 1) * 36 + nv * 6 * dot6 + int(np.tril(lay["m_mask"]).sum()) * dot6 + nv
    # passive + actuation
    f += 2 * nv + 4 * m.nu

    def chol(pat):
        c = 0
        for j in range(nv):
            c += 2 * int(pat[j, :j].sum()) + 3
            for i in range(j + 1, nv):
                if pat[i, j]:
                    c += 2 * int((pat[i, :j] & pat[j, :j]).sum()) + 1
        return c + 2 * (2 * int(np.tril(pat, -1).sum()) + nv)

    f += chol(lay["m_pat"])
    # collision: each geom's position, and as much of its frame as the pair
    # reads (a plane's normal or a capsule's axis is one column, a box reads
    # all of it, a sphere none); then the pair's own work
    frame = 2 * cross + 8
    col = qmul + 13
    full = qmul + q2m
    sb_dist = 3 * dot3 + 3 + 6 + 9 + 6 + dot3 + 1 + 1  # a point's distance to a box
    sb_rest = 4 + 6  # the normal and the contact point
    sphere_box = sb_dist + sb_rest + frame
    corner = 18 + 3
    sphere_sphere = 3 + dot3 + 1 + 3 + 2 + 8  # the normal, the distance, the point
    seg = 3 + dot3 + 1 + 6  # the closest point of a segment to a point
    seg_seg = 3 + 3 * dot3 + 2 + 4 + 6 + 2 + 2 + 12  # the clamped solve, both points
    per_kind = {  # kind: (first geom's frame, second geom's frame, the pair)
        0: (col, 0, dot3 + 10 + frame),
        1: (col, col, 2 * (6 + dot3 + 10) + dot3 + 6 + 10 + cross),
        2: (col, full, dot3 + 8 * (corner + dot3 + 1) + 4 * 6 + frame),
        3: (0, full, sphere_box),
        4: (col, full, 2 * (6 + sphere_box)),
        # 16 candidate distances, then point and frame of the deepest 8
        5: (full, full, 16 * (corner + sb_dist) + 8 * (sb_rest + frame)),
        6: (0, 0, sphere_sphere + frame),
        7: (0, col, seg + sphere_sphere + frame),
        8: (col, col, seg_seg + sphere_sphere + frame),
    }
    f += len(m.pair_table) * 2 * (qrot + 3)
    f += sum(sum(per_kind[k]) for k in lay["pair_kind"].tolist())
    kbi = 40
    f += len(lay["fric_dof"]) * (kbi + 6)
    f += len(lay["limit_jnt"]) * (kbi + 10)
    # contact Jacobians: the translational difference along the frame on each
    # slot's support, and the rotational one at condim-6 slots
    r1 = len(lay["fric_dof"]) + len(lay["limit_jnt"])
    slot_sup = {}
    for (slot, _, _), row in zip(contact_rows(m), lay["j_sup"][r1:]):
        slot_sup[slot] = int(row.sum())
    f += sum(n * (2 * (cross + 3) + 3 + 3 * dot3) for n in slot_sup.values())
    f += sum(n * (3 + 3 * dot3) for s_, n in slot_sup.items() if lay["con_rot"][s_] >= 0)
    # each contact row: impedance, R, its entries and velocity, aref
    sup_c = int(lay["j_sup"][r1:].sum())
    f += m.ncon * (kbi + 12) + sup_c * 5 + len(lay["crow"]) * (kbi + 4)
    # Newton solve
    nsup = int(lay["j_sup"].sum())
    pair_ops = sum(int(r.sum()) * (int(r.sum()) + 1) // 2 for r in lay["j_sup"])
    m_nnz = int(lay["m_mask"].sum())
    per_ls = 2 * nefc + 4 + 8 * nefc + 4
    per_iter = (
        5 * nefc + 2 * nv + 2 * nsup + nv + nsup + 2 * pair_ops + chol(lay["h_pat"])
        + 2 * nsup + 2 * m_nnz + 4 * nv + max(m.opt.ls_iterations, 1) * per_ls
        + 2 * nefc + 4 * nefc + 6 * nv + 6 * nv + 2 * nefc
    )
    # elliptic groups: the three-zone terms at each cost and line-search
    # update, v = J_g' g and its rank-1 term on the Hessian entries it reaches
    groups = lay["groups"]
    if groups:
        gterms = sum(14 * dim + 20 for _, dim in groups)
        gsup = {row0: int(lay["j_sup"][row0].sum()) for row0, _ in groups}
        g_hess = sum(2 * dim * gsup[row0] + 3 * gsup[row0] * (gsup[row0] + 1) // 2 for row0, dim in groups)
        per_iter += 2 * gterms + g_hess + max(m.opt.ls_iterations, 1) * (gterms + 3 * sum(d for _, d in groups))
    f += 2 * nsup + nefc + m.opt.iterations * per_iter
    if not m.opt.disable_eulerdamp:
        # J' force, and (M + h diag(damping)) qacc = qfrc solved on M's pattern
        f += 2 * nsup + 2 * nv + chol(lay["m_pat"])
    # integration and views
    f += 2 * nv + 2 * m.nq + n_free * (qmul + 30) + (nb - 1) * (3 + cross + 3)
    f += m.nsite * (qrot + 3 + qmul + q2m)
    return int(f)


def io_rows(m: Model) -> tuple:
    """(input rows, output rows) of a sample: qpos, qvel, ctrl in; the 11
    products out."""
    return m.nq + m.nv + m.nu, sum(n for _, n in out_specs(m))


def launch_cost(m: Model, batch: int, n_steps: int, float_bytes: int = 4) -> tuple:
    """(operations, bytes) of one launch over ``batch`` samples and
    ``n_steps`` physics steps."""
    rows_in, rows_out = io_rows(m)
    return step_flops(m) * batch * n_steps, (rows_in + rows_out) * batch * float_bytes
