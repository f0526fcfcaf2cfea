"""The whole-physics-step CUDA kernel: build, wrapper and plain version.

``step_core(model, qpos, qvel, ctrl, n_steps)`` advances a batch of samples
by ``n_steps`` physics steps under constant ctrl and returns the 11 products
the task environments consume. On CUDA tensors it launches the hand-written
kernel of ``csrc/engine_step.cu`` (a warp per sample, the sample's working
set in shared memory) or raises; on CPU
tensors it runs :func:`step_core_reference`, the same function in plain
PyTorch on top of ``physics.forward.step``.

The kernel's code is C++ in ``csrc/``. What is generated here, at build
time and into the build directory, is only ``model_constants.h``: the
model's sizes, tree topology, frames, inertias, pair table, the index lists
the team's lanes walk (``team_tables``) and the solver schedule, as
initialisers of the kernel's constant tables.
One shared library is built per model key (``cuda_build.build_library``); it
exposes a plain C interface and is loaded with ``ctypes``.

The plain version runs the solve stage in plain PyTorch too
(``solver.solve_reference``), so it contains no kernel on any device.
"""

from __future__ import annotations

import ctypes
import weakref

import numpy as np
import torch

from dial_mpc_tpu_torch.physics import cuda_build
from dial_mpc_tpu_torch.physics.constraint import elliptic_groups
from dial_mpc_tpu_torch.physics.forward import step as physics_step
from dial_mpc_tpu_torch.physics.model import (
    BOX,
    CAPSULE,
    PLANE,
    SPHERE,
    Contact,
    Data,
    Model,
    put_model,
)
from dial_mpc_tpu_torch.physics.solver import solve_reference

FREE, BALL, SLIDE, HINGE = 0, 1, 2, 3

# the pair kinds the kernel collides, numbered as csrc/engine_step.cu's
# PairKind; the header carries each pair's kind and the set of kinds present
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

_CSRC = cuda_build.CSRC
_INCLUDES = ("lane_math.cuh", "model_consts.cuh", "newton_solve_team.cuh")
LANES = 32  # lanes a sample (csrc/newton_solve_team.cuh); 16 is built for timing only
LIST_STRIDE = 32  # the interleaving of the lists a lane walks alone (csrc/newton_solve_team.cuh)

OUTPUT_NAMES = (
    "qpos", "qvel", "site_xpos", "site_xmat", "x_pos", "x_rot",
    "xd_vel", "xd_ang", "cdist", "cpos", "qacc",
)


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


# ---------------------------------------------------------------------------
# scope of the kernel
# ---------------------------------------------------------------------------


def check_supported(m: Model) -> None:
    """Raise NotImplementedError for a model the CUDA kernel does not cover.

    Covered: free, hinge and slide joints; the pairs of ``PAIR_KINDS`` at
    condim 3 or 6, with pyramidal or elliptic cones; friction-loss dofs; joint
    limits; the Euler integrator, with or without implicit joint damping
    (eulerdamp). Ball joints, the other integrators and the contact-disable
    flag are refused (the reference has no ball joints or other integrators
    either), and so are condim 1 and 4, which no scene of the model suite has.
    """
    if m.opt.integrator != 0:
        raise NotImplementedError("CUDA step kernel: only the Euler integrator is ported")
    if m.ncon and m.opt.disable_contact:
        raise NotImplementedError("CUDA step kernel: the contact-disable flag is not ported yet")
    for jt in m.jnt_type:
        if jt not in (FREE, HINGE, SLIDE):
            name = {BALL: "ball"}.get(jt, str(jt))
            raise NotImplementedError(f"CUDA step kernel: {name} joints are not ported yet")
    for (g1, g2, t1, t2, condim, conadr, conmax) in m.pair_table:
        if (t1, t2) not in PAIR_KINDS:
            raise NotImplementedError(
                f"CUDA step kernel: collision pair of geom types {(t1, t2)} is not ported yet"
            )
        if condim not in (3, 6):
            raise NotImplementedError(
                f"CUDA step kernel: contact dimension {condim} is not ported yet"
            )


def model_key(m: Model) -> tuple:
    """What a compiled library depends on besides the constants themselves."""
    return (
        m.pair_table, m.nq, m.nv, m.nu, m.jnt_type, m.opt.cone, m.opt.iterations,
        m.opt.ls_iterations, m.opt.disableflags, float(m.opt.timestep),
        m.dof_frictionloss_static, float(m.opt.impratio),
    )


# ---------------------------------------------------------------------------
# the generated header
# ---------------------------------------------------------------------------


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


def _csr(lists) -> tuple:
    """A list of index lists -> (start offsets, n + 1 of them; concatenation)."""
    adr = np.cumsum([0] + [len(x) for x in lists]).astype(np.int64)
    flat = np.array([v for x in lists for v in x], dtype=np.int64)
    return adr, flat


def _interleaved(lists) -> tuple:
    """Lists that one lane walks each, interleaved so that the lanes of a warp,
    on lists k, k + 1, ..., read adjacent words at every step: lists come in
    blocks of LIST_STRIDE, and list k's item q lies at start_k + LIST_STRIDE q,
    start_k = its block's base + k % LIST_STRIDE. -> (``at``: start_k |
    len_k << 16 for each list; the items, 0 in the holes)."""
    at, flat = [], []
    for b in range(0, len(lists), LIST_STRIDE):
        block = lists[b : b + LIST_STRIDE]
        base = len(flat)
        flat += [0] * (LIST_STRIDE * max(len(x) for x in block))
        for k, x in enumerate(block):
            at.append((base + k) | (len(x) << 16))
            for q, v in enumerate(x):
                flat[base + k + LIST_STRIDE * q] = v
    if len(flat) > 0xFFFF or any(len(x) > 0x7FFF for x in lists):
        raise NotImplementedError("CUDA step kernel: an interleaved list of more than 65,535 words")
    return np.array(at, dtype=np.int64), np.array(flat, dtype=np.int64)


def _factor_schedule(pat: np.ndarray, m_at) -> dict:
    """The right-looking Cholesky of a pattern in elimination order, as lists.

    The factored matrix and its factor are stored on the pattern alone: the
    diagonal entry of row k at position k, then each row's entries left of
    the diagonal at n + their place in ``back`` (``pos``). ``ent``: the
    pattern's lower entries, packed ``pos << 16 | r << 8 | c`` (r >= c), and
    ``ent_inm`` the position in M's storage of each (``m_at`` of the
    elimination-order entry), or -1 where it lies outside M's mask (fill, or
    a Hessian entry M never holds: it starts at zero). Column c: ``col`` the
    rows r > c of its entries (packed ``r | pos(r, c) << 8``), ``upd`` the
    trailing updates ``A[r][k] -= L[r][c] L[k][c]`` (r >= k > c, packed
    ``pos(r, c) | pos(k, c) << 10 | pos(r, k) << 20``). Row k: ``back`` the
    columns c < k of its entries, for the backward sweep.
    """
    n = pat.shape[0]
    ent = [(r, c) for c in range(n) for r in range(c, n) if pat[r, c]]
    if len(ent) > 1024:
        raise NotImplementedError("CUDA step kernel: a factor of more than 1024 entries")
    below = [[r for r in range(c + 1, n) if pat[r, c]] for c in range(n)]
    back = [[c for c in range(k) if pat[k, c]] for k in range(n)]
    back_adr, back = _csr(back)
    pos = {(c, c): c for c in range(n)}
    for k in range(n):
        for e in range(int(back_adr[k]), int(back_adr[k + 1])):
            pos[(k, int(back[e]))] = n + e
    col_adr, col = _csr([[r | (pos[(r, c)] << 8) for r in below[c]] for c in range(n)])
    upd = [[pos[(r, c)] | (pos[(k, c)] << 10) | (pos[(r, k)] << 20)
            for k in below[c] for r in below[c] if r >= k] for c in range(n)]
    upd_adr, upd = _csr(upd)
    return dict(
        ent=np.array([(pos[(r, c)] << 16) | (r << 8) | c for r, c in ent], dtype=np.int64),
        ent_inm=np.array([m_at(r, c) for r, c in ent], dtype=np.int64),
        col_adr=col_adr, col=col, upd_adr=upd_adr, upd=upd, back_adr=back_adr, back=back,
    )


def team_tables(m: Model) -> tuple:
    """The index lists the team kernel's lanes walk, as numpy int arrays, and
    the sizes that go with them (tree depth, longest list of each kind).

    Body levels (depth 1, 2, ... of the tree) and children; the dofs' joints
    and actuators; the masked lower entries of M and its symmetric rows; the
    supports of J by row and by column; the contact-dof pairs of the
    translational Jacobians; the factor schedules of M and of the Newton
    Hessian in elimination order, with the rows that reach each Hessian entry.
    """
    lay = static_layout(m)
    nv, nb = m.nv, m.nbody
    # matrix entries are packed r << 8 | c into a (signed) short
    if nv > 127 or lay["j_sup"].shape[0] > 255:
        raise NotImplementedError("CUDA step kernel: more than 127 dofs or 255 constraint rows")
    depth = [0] * nb
    for b in range(1, nb):
        depth[b] = depth[m.body_parentid[b]] + 1
    nlevel = max(depth) if nb > 1 else 0
    level_adr, level_body = _csr([[b for b in range(1, nb) if depth[b] == d] for d in range(1, nlevel + 1)])
    child_adr, child_body = _csr([[c for c in range(1, nb) if m.body_parentid[c] == b] for b in range(nb)])
    dof_jnt = [j for j in range(m.njnt) for _ in range(6 if m.jnt_type[j] == FREE else 1)]
    act_dof = m.actuator_dofadr.cpu().numpy()
    dact_adr, dact = _csr([[u for u in range(m.nu) if act_dof[u] == i] for i in range(nv)])

    mm, sup = lay["m_mask"], lay["j_sup"]
    # M is stored on its masked lower entries, in ment's order: both (i, j)
    # and (j, i) read the entry of (max, min)
    ment_ij = [(i, j) for i in range(nv) for j in range(i + 1) if mm[i, j]]
    m_pos = {ij: k for k, ij in enumerate(ment_ij)}

    def m_at(i, j):
        return m_pos[(max(i, j), min(i, j))] if mm[i, j] else -1

    ment = [(i << 8) | j for i, j in ment_ij]
    # M's symmetric rows, a lane's each: j | its position in M << 8
    mrow_at, mrow_col = _interleaved([[j | (m_at(i, j) << 8) for j in range(nv) if mm[i, j]] for i in range(nv)])
    # J is stored on its rows' supports in row order: entry (r, i) at its place
    # in jrow_col; a row of friction loss or of a limit has one entry, and these
    # rows come first, so such a row r is at position r
    jrow_adr, jrow_col = _csr([list(np.flatnonzero(r)) for r in sup])
    j_pos = {(r, int(jrow_col[e])): e for r in range(sup.shape[0])
             for e in range(int(jrow_adr[r]), int(jrow_adr[r + 1]))}
    n_one = len(lay["fric_dof"]) + len(lay["limit_jnt"])
    assert all(j_pos.get((r, int(jrow_col[r]))) == r for r in range(n_one))
    if len(jrow_col) > 4096:
        raise NotImplementedError("CUDA step kernel: more than 4096 entries of J")
    # the rows that can reach each dof, a lane's each: row | the position of
    # J[row][dof] << 8
    jcol_at, jcol_row = _interleaved([[r | (j_pos[(r, i)] << 8) for r in np.flatnonzero(sup[:, i])]
                                      for i in range(nv)])
    # cpair packs slot << 10 | side << 8 | dof: 6 bits of slot, 8 of dof
    if m.ncon > 64:
        raise NotImplementedError("CUDA step kernel: more than 64 contact slots")
    cpair, con_cadr = [], []
    for slot, (b1, b2) in enumerate(zip(lay["con_body1"], lay["con_body2"])):
        con_cadr.append(len(cpair))
        for i in range(nv):
            side = int(lay["chain_mask"][b1][i]) | (int(lay["chain_mask"][b2][i]) << 1)
            if side:
                cpair.append((slot << 10) | (side << 8) | i)
    # the contact Jacobians, rows of three values: Jn, Jt1, Jt2 of cpair q at
    # row q, and at a condim-6 slot the rotational ones at row q +
    # con_jrot[slot], after every cpair's row (-1: no rotational rows)
    con_jrot, n_rot = [], 0
    for slot, adr in enumerate(con_cadr):
        if lay["con_rot"][slot] < 0:
            con_jrot.append(-1)
        else:
            con_jrot.append(len(cpair) + n_rot - adr)
            n_rot += (con_cadr + [len(cpair)])[slot + 1] - adr

    mf = _factor_schedule(lay["m_pat"], lambda r, c: m_at(nv - 1 - c, nv - 1 - r))
    # the Hessian starts as M (the rows' terms are added to it), so the entries
    # outside M's mask start at zero: contacts between two moving bodies reach
    # entries between their chains that M never holds
    hf = _factor_schedule(lay["h_pat"], lambda r, c: m_at(nv - 1 - c, nv - 1 - r))
    hrows = []
    for v in hf["ent"]:
        i, j = nv - 1 - (v & 255), nv - 1 - ((v >> 8) & 255)
        hrows.append([r for r in range(sup.shape[0]) if sup[r, i] and sup[r, j]])
    # the entries reached by the most rows first, so that a pass of the lanes
    # over the list holds entries of about the same length
    order = sorted(range(len(hrows)), key=lambda e: -len(hrows[e]))
    hf["ent"], hf["ent_inm"] = hf["ent"][order], hf["ent_inm"][order]
    # a lane's each; each row: row | the positions of J[row][i] << 8 and of
    # J[row][j] << 20
    hrow_at, hrow = _interleaved([
        [r | (j_pos[(r, nv - 1 - (hf["ent"][k] & 255))] << 8)
         | (j_pos[(r, nv - 1 - ((hf["ent"][k] >> 8) & 255))] << 20) for r in hrows[e]]
        for k, e in enumerate(order)
    ])
    # the elliptic groups whose rank-1 Hessian term reaches each entry (a
    # group's rows share one support: its first row's)
    hgrp_adr, hgrp = _csr([
        [g for g, (row0, _) in enumerate(lay["groups"]) if any(row0 == r for r in hrows[e])]
        for e in order
    ])
    out = dict(
        level_adr=level_adr, level_body=level_body, child_adr=child_adr, child_body=child_body,
        dof_jnt=dof_jnt, dact_adr=dact_adr, dact=dact, ment=ment, mrow_at=mrow_at,
        mrow_col=mrow_col, jrow_adr=jrow_adr, jrow_col=jrow_col, jcol_at=jcol_at,
        jcol_row=jcol_row, cpair=cpair, con_cadr=con_cadr, con_jrot=con_jrot,
        hrow_at=hrow_at, hrow=hrow, hgrp_adr=hgrp_adr, hgrp=hgrp,
    )
    out.update({f"mf_{k}": v for k, v in mf.items()})
    out.update({f"hf_{k}": v for k, v in hf.items()})
    out = {k: np.asarray(v, dtype=np.int64) for k, v in out.items()}
    # the longest column, update list and row of each factor: a lane's passes
    longest = {f"{f}_MAX{part.upper()}": int(np.diff(out[f"{f}_{part}_adr"]).max())
               for f in ("mf", "hf") for part in ("col", "upd", "back")}
    # rows of the contact Jacobians' storage
    return out, dict(NLEVEL=nlevel, NCJAC=len(cpair) + n_rot, **longest)


def _c_init(a, integer: bool) -> str:
    """A numpy array as a nested brace initialiser (``{0}`` when empty)."""
    a = np.asarray(a)
    if a.ndim == 0:
        return str(int(a)) if integer else repr(float(a))
    if a.size == 0:
        return "{0}"
    if a.ndim == 1:
        return "{" + ", ".join(str(int(v)) if integer else repr(float(v)) for v in a) + "}"
    return "{" + ", ".join(_c_init(row, integer) for row in a) + "}"


def render_constants_header(m: Model) -> str:
    """The text of ``model_constants.h`` for this model."""
    check_supported(m)
    lay = static_layout(m)
    cg = lay["cgeoms"]

    def r(t):  # real-valued tensor -> float64 numpy
        return t.detach().cpu().double().numpy()

    sub_mass = r(m.body_mass).copy()
    for b in range(m.nbody - 1, 0, -1):
        sub_mass[m.body_parentid[b]] += sub_mass[b]

    nfric = len(lay["fric_dof"])
    nefc = nfric + len(lay["limit_jnt"]) + len(lay["crow"])
    assert lay["j_sup"].shape[0] == nefc
    groups = lay["groups"]
    ncon6 = int((lay["con_rot"] >= 0).sum())
    # the contact rows follow a table unless every slot is a condim-3 pyramid
    # (four facets a slot, computed from the row number)
    con_table = int(m.opt.cone == 1 or ncon6 > 0)
    efc_eta = np.zeros(nefc)
    if m.opt.cone == 1:
        fri = r(m.con_friction)
        for k, v in enumerate(lay["crow"].tolist()):
            if (v >> 1) & 7:
                efc_eta[nefc - len(lay["crow"]) + k] = fri[v >> 4][((v >> 1) & 7) - 1]
    kinds = sorted(set(lay["pair_kind"].tolist()))
    sizes = dict(
        NQ=m.nq, NV=m.nv, NU=m.nu, NBODY=m.nbody, NJNT=m.njnt, NSITE=m.nsite,
        NCON=m.ncon, NPAIR=len(m.pair_table), NCGEOM=len(cg),
        NFRIC=nfric, NLIMIT=len(lay["limit_jnt"]), NEFC=nefc,
        ITERATIONS=m.opt.iterations, LS_ITERATIONS=m.opt.ls_iterations,
        # bit k set: some pair is of kind k; whether any joint slides
        PAIR_KINDS=sum(1 << k for k in kinds), HAS_SLIDE=int(SLIDE in m.jnt_type),
        ELLIPTIC=int(m.opt.cone == 1), NCON6=ncon6, CON_TABLE=con_table, NGROUPS=len(groups),
        EULERDAMP=int(not m.opt.disable_eulerdamp),
    )
    ints = dict(
        body_parentid=m.body_parentid, body_rootid=m.body_rootid,
        body_jntadr=m.body_jntadr, body_jntnum=m.body_jntnum,
        body_dofadr=m.body_dofadr, body_dofnum=m.body_dofnum,
        jnt_type=m.jnt_type, jnt_qposadr=m.jnt_qposadr, jnt_dofadr=m.jnt_dofadr,
        jnt_bodyid=m.jnt_bodyid, dof_bodyid=m.dof_bodyid,
        site_bodyid=m.site_bodyid.cpu().numpy(),
        cgeom_bodyid=[m.geom_bodyid_static[g] for g in cg],
        pair_g1=lay["pair_g1"], pair_g2=lay["pair_g2"], pair_conadr=lay["pair_conadr"],
        pair_kind=lay["pair_kind"],
        con_body1=lay["con_body1"], con_body2=lay["con_body2"],
        fric_dof=lay["fric_dof"], limit_jnt=lay["limit_jnt"],
        act_qposadr=[m.jnt_qposadr[t] for t in m.actuator_trnid],
        act_affine=[int(bt == 1) for bt in m.actuator_biastype],
        act_ctrllimited=(r(m.actuator_ctrllimited) > 0).astype(np.int64),
        act_forcelimited=(r(m.actuator_forcelimited) > 0).astype(np.int64),
        crow=lay["crow"],
        group_row0=[g[0] for g in groups], group_dim=[g[1] for g in groups],
    )
    tables, team_sizes = team_tables(m)
    sizes.update(team_sizes)
    reals = dict(
        body_pos=r(m.body_pos), body_quat=r(m.body_quat), body_ipos=r(m.body_ipos),
        body_iquat=r(m.body_iquat), body_mass=r(m.body_mass),
        body_inertia=r(m.body_inertia), body_invweight0=r(m.body_invweight0),
        subtree_mass_inv=1.0 / np.maximum(sub_mass, 1e-15),
        jnt_pos=r(m.jnt_pos), jnt_axis=r(m.jnt_axis), jnt_range=r(m.jnt_range),
        jnt_solref=r(m.jnt_solref), jnt_solimp=r(m.jnt_solimp), jnt_margin=r(m.jnt_margin),
        qpos0=r(m.qpos0), dof_armature=r(m.dof_armature), dof_damping=r(m.dof_damping),
        dof_invweight0=r(m.dof_invweight0), dof_solref=r(m.dof_solref),
        dof_solimp=r(m.dof_solimp),
        # each row's friction-loss bound (0 for limit and contact rows)
        efc_frictionloss=np.concatenate(
            [r(m.dof_frictionloss)[lay["fric_dof"]], np.zeros(nefc - nfric)]
        ),
        cgeom_pos=r(m.geom_pos)[cg], cgeom_quat=r(m.geom_quat)[cg],
        cgeom_size=r(m.geom_size)[cg],
        site_pos=r(m.site_pos), site_quat=r(m.site_quat),
        act_gear=r(m.actuator_gear), act_gain=r(m.actuator_gainprm)[:, 0],
        act_bias=r(m.actuator_biasprm)[:, :3], act_ctrlrange=r(m.actuator_ctrlrange),
        act_forcerange=r(m.actuator_forcerange),
        con_friction=r(m.con_friction), con_solref=r(m.con_solref),
        con_solimp=r(m.con_solimp), con_includemargin=r(m.con_includemargin),
        gravity=r(m.opt.gravity), timestep=r(m.opt.timestep),
        tolerance=np.float64(m.opt.tolerance),
        efc_eta=efc_eta,  # each elliptic friction row's coefficient, 0 elsewhere
        impratio=r(m.opt.impratio),
    )
    lines = [
        "// Generated from the loaded model by engine_cuda.render_constants_header.",
        "// Sizes, topology, frames, inertias, pair table, sparsity patterns and",
        "// solver schedule; the kernel's code is in csrc/ and is not generated.",
        "#pragma once",
    ]
    lines += [f"#define MC_{k} {int(v)}" for k, v in sizes.items()]
    for k, v in ints.items():
        lines.append(f"#define MCI_{k} {_c_init(np.asarray(v).astype(np.int64), True)}")
    for k, v in tables.items():  # the lanes' index lists; MC_N_<name> is the length
        lines.append(f"#define MC_N_{k} {len(v)}")
        lines.append(f"#define MCI_{k} {_c_init(v, True)}")
    for k, v in reals.items():
        v = np.asarray(v, dtype=np.float64)
        if not np.isfinite(v).all():
            raise ValueError(f"model constant {k} is not finite")
        lines.append(f"#define MCI_{k} {_c_init(v, False)}")
    return "\n".join(lines) + "\n"


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


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------


class EngineLibrary:
    """A loaded shared library for one model key."""

    def __init__(self, path: str, build_seconds: float, build_log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log
        self.lib = ctypes.CDLL(path)
        for name in ("engine_step_f32", "engine_step_f64"):
            fn = getattr(self.lib, name)
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
        for name in ("engine_in_rows", "engine_out_rows", "engine_lanes",
                     "engine_team_bytes_f32", "engine_team_bytes_f64",
                     "engine_samples_per_block_f32", "engine_samples_per_block_f64",
                     "engine_teams_per_sm_f32", "engine_teams_per_sm_f64"):
            getattr(self.lib, name).restype = ctypes.c_int
        self.in_rows = self.lib.engine_in_rows()
        self.out_rows = self.lib.engine_out_rows()
        self.lanes = self.lib.engine_lanes()
        self._shapes = {}

    def fn(self, dtype: torch.dtype):
        if dtype == torch.float32:
            return self.lib.engine_step_f32
        if dtype == torch.float64:
            return self.lib.engine_step_f64
        raise TypeError(f"CUDA step kernel: dtype {dtype} is not supported (float32/float64)")

    def _tag(self, dtype: torch.dtype) -> str:
        self.fn(dtype)
        return "f32" if dtype == torch.float32 else "f64"

    def team_bytes(self, dtype: torch.dtype) -> int:
        """Shared memory of one sample's team."""
        return getattr(self.lib, f"engine_team_bytes_{self._tag(dtype)}")()

    def launch_shape(self, dtype: torch.dtype) -> tuple:
        """(samples a block, teams an SM) of the launch (needs the card)."""
        shape = self._shapes.get(dtype)
        if shape is None:
            tag = self._tag(dtype)
            spb = getattr(self.lib, f"engine_samples_per_block_{tag}")()
            if spb < 0:
                raise RuntimeError(f"CUDA step kernel: occupancy query failed with cudaError {-spb}")
            if spb == 0:
                raise RuntimeError(
                    f"CUDA step kernel: one sample's working set, {self.team_bytes(dtype)} bytes "
                    f"of shared memory in {dtype}, exceeds what a block of this card may have"
                )
            shape = self._shapes[dtype] = (spb, getattr(self.lib, f"engine_teams_per_sm_{tag}")())
        return shape

    def teams_per_sm(self, dtype: torch.dtype) -> int:
        """Samples one SM holds at once (needs the card)."""
        return self.launch_shape(dtype)[1]


_LIBS: dict = {}  # model key -> EngineLibrary
_LIB_OF_MODEL = weakref.WeakKeyDictionary()  # Model -> EngineLibrary


def exact_model(m: Model) -> Model:
    """The float64 twin of a Model, from the compiled scene it was put from.

    The header's literals must not depend on the dtype a Model was put in:
    one library serves float32 and float64, and each kernel rounds the exact
    constants once, at compile time, to the type it computes in.
    """
    if m.dtype == torch.float64 or m.mj_model is None:
        return m
    return put_model(m.mj_model, device="cpu", dtype=torch.float64)


def load_library(m: Model, lanes: int = LANES) -> EngineLibrary:
    """Build (at first use) and load the kernel library for this model.

    ``lanes`` is the team size the library is compiled for; the wrapper
    always uses ``LANES``, another size is built only to be timed beside it.
    """
    lib = _LIB_OF_MODEL.get(m) if lanes == LANES else None
    if lib is not None:
        return lib
    m_in, m = m, exact_model(m)
    key = (model_key(m), lanes)
    if key in _LIBS:
        if lanes == LANES:
            _LIB_OF_MODEL[m_in] = _LIBS[key]
        return _LIBS[key]
    built = cuda_build.build_library(
        "engine_step", "engine_step.cu", _INCLUDES,
        {"model_constants.h": render_constants_header(m)}, defines={"LANES": lanes},
    )
    lib = EngineLibrary(built.path, built.seconds, built.log)
    expect_in, expect_out = m.nq + m.nv + m.nu, sum(n for _, n in out_specs(m))
    if (lib.in_rows, lib.out_rows) != (expect_in, expect_out):
        raise RuntimeError(
            f"CUDA step kernel: library rows {(lib.in_rows, lib.out_rows)} "
            f"do not match the model's {(expect_in, expect_out)}"
        )
    _LIBS[key] = lib
    if lanes == LANES:
        _LIB_OF_MODEL[m_in] = lib
    return lib


# ---------------------------------------------------------------------------
# the wrapper and its plain version
# ---------------------------------------------------------------------------


def _check_inputs(m: Model, qpos, qvel, ctrl, n_steps: int):
    if not isinstance(n_steps, int) or n_steps < 1:
        raise ValueError(f"n_steps must be a positive int, got {n_steps!r}")
    for name, t, n in (("qpos", qpos, m.nq), ("qvel", qvel, m.nv), ("ctrl", ctrl, m.nu)):
        if t.dim() != 2 or t.shape[1] != n:
            raise ValueError(f"{name} must have shape (B, {n}), got {tuple(t.shape)}")
        if t.shape[0] != qpos.shape[0]:
            raise ValueError("qpos, qvel and ctrl must share the batch size")
        if t.device != qpos.device or t.dtype != qpos.dtype:
            raise ValueError("qpos, qvel and ctrl must share device and dtype")
    if qpos.shape[0] < 1:
        raise ValueError("empty batch")


def _split_outputs(m: Model, packed: torch.Tensor):
    """(B, rows) -> the 11 outputs as column views."""
    outs, o = [], 0
    for _, n in out_specs(m):
        outs.append(packed[:, o : o + n])
        o += n
    return tuple(outs)


def step_core(m: Model, qpos, qvel, ctrl, n_steps: int = 1):
    """n_steps physics steps under constant ctrl -> tuple of 11 (B, n) outputs.

    Outputs, in order: qpos, qvel (after the last step), site_xpos,
    site_xmat, x_pos, x_rot, xd_vel, xd_ang, cdist, cpos (at the last
    step's pre-integration kinematics) and qacc of the last step. CUDA
    tensors go to the kernel; CPU tensors go to the plain version.
    """
    _check_inputs(m, qpos, qvel, ctrl, n_steps)
    if qpos.device.type == "cpu":
        return step_core_reference(m, qpos, qvel, ctrl, n_steps)
    if qpos.device.type != "cuda":
        raise ValueError(f"CUDA step kernel: unsupported device {qpos.device}")
    if m.device != qpos.device:
        raise ValueError(f"model is on {m.device}, inputs on {qpos.device}")
    lib = load_library(m)
    fn = lib.fn(qpos.dtype)
    teams_per_sm = lib.teams_per_sm(qpos.dtype)  # raises if a working set does not fit a block
    B = qpos.shape[0]
    # sample-major: one contiguous row a sample, read and written by its team
    packed_in = torch.cat([qpos, qvel, ctrl], dim=1)
    packed_out = torch.empty((B, lib.out_rows), dtype=qpos.dtype, device=qpos.device)
    with torch.cuda.device(qpos.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(packed_in.data_ptr(), packed_out.data_ptr(), B, n_steps, stream)
    if err != 0:
        raise RuntimeError(f"CUDA step kernel: launch failed with cudaError {err}")
    step_core.launches += 1
    # the waves of teams the launch takes: the samples over what the card holds at once
    step_core.waves = -(-B // (teams_per_sm * _sm_count(qpos.device)))
    return _split_outputs(m, packed_out)


step_core.launches = 0
step_core.waves = 0  # of the last launch


_SM_COUNT: dict = {}  # device index -> streaming multiprocessors


def _sm_count(device: torch.device) -> int:
    n = _SM_COUNT.get(device.index)
    if n is None:
        n = _SM_COUNT[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return n


def step_core_reference(m: Model, qpos, qvel, ctrl, n_steps: int = 1, solve=solve_reference):
    """The plain PyTorch version of :func:`step_core` (any device).

    ``solve`` is the solve stage; the default keeps the whole chain in plain
    PyTorch. With ``solver.solve`` it is the unfused route's step, whose solve
    stage is the solver kernel on the card.
    """
    _check_inputs(m, qpos, qvel, ctrl, n_steps)
    B = qpos.shape[0]
    d = Data(qpos=qpos, qvel=qvel, ctrl=ctrl, time=qpos.new_zeros(B))
    for _ in range(n_steps):
        d = physics_step(m, d, solve)
    zero1 = qpos.new_zeros(B, 1)
    return (
        d.qpos,
        d.qvel,
        d.site_xpos.reshape(B, -1) if m.nsite else zero1,
        d.site_xmat.reshape(B, -1) if m.nsite else zero1,
        d.x_pos.reshape(B, -1),
        d.x_rot.reshape(B, -1),
        d.xd_vel.reshape(B, -1),
        d.xd_ang.reshape(B, -1),
        d.contact.dist if m.ncon else zero1,
        d.contact.pos.reshape(B, -1) if m.ncon else qpos.new_zeros(B, 3),
        d.qacc,
    )


def _lean_contact(m: Model, dist, pos) -> Contact:
    return Contact(
        dist=dist, pos=pos, frame=None, geom=m.con_geom,
        includemargin=m.con_includemargin, friction=m.con_friction,
        solref=m.con_solref, solimp=m.con_solimp, dim=m.con_dim,
    )


def lean_data(m: Model, d_prev: Data, outs, ctrl, elapsed) -> Data:
    """Assemble the lean Data carried through rollouts from core outputs."""
    (qpos, qvel, site_xpos, site_xmat, x_pos, x_rot, xd_vel, xd_ang,
     cdist, cpos, qacc) = outs
    B, nbody1 = qpos.shape[0], m.nbody - 1
    return Data(
        qpos=qpos,
        qvel=qvel,
        ctrl=ctrl,
        time=d_prev.time + elapsed,
        site_xpos=site_xpos[:, : m.nsite * 3].reshape(B, m.nsite, 3),
        site_xmat=site_xmat[:, : m.nsite * 9].reshape(B, m.nsite, 3, 3),
        x_pos=x_pos.reshape(B, nbody1, 3),
        x_rot=x_rot.reshape(B, nbody1, 4),
        xd_vel=xd_vel.reshape(B, nbody1, 3),
        xd_ang=xd_ang.reshape(B, nbody1, 3),
        qacc=qacc,
        contact=_lean_contact(m, cdist[:, : m.ncon], cpos.reshape(B, -1, 3)[:, : m.ncon]),
    )


def trim_data(m: Model, d: Data) -> Data:
    """Full Data -> the same lean structure lean_data produces."""
    contact = _lean_contact(m, d.contact.dist, d.contact.pos) if d.contact is not None else None
    return Data(
        qpos=d.qpos, qvel=d.qvel, ctrl=d.ctrl, time=d.time,
        site_xpos=d.site_xpos, site_xmat=d.site_xmat,
        x_pos=d.x_pos, x_rot=d.x_rot, xd_vel=d.xd_vel, xd_ang=d.xd_ang,
        qacc=d.qacc, contact=contact,
    )
