// Model constants of the step kernel.
//
// "model_constants.h" is generated at build time from the loaded model
// (engine_cuda.py::render_constants_header): it defines the sizes below as
// MC_* integer macros and one brace-initialiser macro per field, named
// MCI_<field>. Everything else about the kernel is written here by hand.
//
// Where the constants live follows how a team reads them. Lanes of a team
// index bodies, dofs, rows and list entries of their own, so the tables and
// the per-body reals are in global memory (read-only, L1-cached): the constant
// cache would serialise a warp whose lanes read different addresses. The few
// values every lane reads at once (timestep, tolerance, gravity) are in
// constant memory, where such a read is a broadcast.
#pragma once

#include "model_constants.h"

namespace mc {
constexpr int NQ = MC_NQ, NV = MC_NV, NU = MC_NU, NBODY = MC_NBODY, NJNT = MC_NJNT;
constexpr int NSITE = MC_NSITE, NCON = MC_NCON, NPAIR = MC_NPAIR, NCGEOM = MC_NCGEOM;
constexpr int NFRIC = MC_NFRIC, NLIMIT = MC_NLIMIT, NEFC = MC_NEFC, NLEVEL = MC_NLEVEL;
// bit k set where some pair is of PairKind k (engine_step.cu); a slide joint?
constexpr int PAIR_KINDS = MC_PAIR_KINDS;
constexpr bool HAS_SLIDE = MC_HAS_SLIDE != 0;
constexpr int ITERATIONS = MC_ITERATIONS, LS_ITERATIONS = MC_LS_ITERATIONS;
// Contacts beyond condim-3 pyramids: elliptic cones (a group of condim rows a
// slot), the slots of condim 6 (torsional and rolling rows from rotational
// Jacobians, which only those slots carry), and whether the contact rows
// follow the crow table (else four facets a slot, from the row number).
constexpr bool ELLIPTIC = MC_ELLIPTIC != 0, CON_TABLE = MC_CON_TABLE != 0;
constexpr int NCON6 = MC_NCON6, NGROUPS = MC_NGROUPS;
// implicit joint damping: (M + h diag(damping)) qacc = qfrc_smooth + J' force
constexpr bool EULERDAMP = MC_EULERDAMP != 0;
// arrays of a size that may be zero get one unused element
constexpr int at_least_1(int n) { return n > 0 ? n : 1; }
constexpr int NSITE1 = at_least_1(NSITE), NCON1 = at_least_1(NCON);
constexpr int NPAIR1 = at_least_1(NPAIR), NCGEOM1 = at_least_1(NCGEOM);
constexpr int NLIMIT1 = at_least_1(NLIMIT), NEFC1 = at_least_1(NEFC), NU1 = at_least_1(NU);
constexpr int NFRIC1 = at_least_1(NFRIC), NCROW1 = at_least_1(NEFC - NFRIC - NLIMIT);
constexpr int NGROUPS1 = at_least_1(NGROUPS);
// the working set's matrices on their static patterns (TeamTables below): M's
// masked lower entries, J's entries on its rows' supports, a factor's entries
// (the Hessian's pattern holds M's), the contact Jacobians' rows of three
constexpr int NMENT = MC_N_ment, NJ1 = at_least_1(MC_N_jrow_col);
constexpr int NFAC = MC_N_hf_ent > MC_N_mf_ent ? MC_N_hf_ent : MC_N_mf_ent;
constexpr int NCJAC1 = at_least_1(MC_NCJAC);

// output rows, in the order the wrapper splits them
constexpr int O_QPOS = 0;
constexpr int O_QVEL = O_QPOS + NQ;
constexpr int O_SITE_XPOS = O_QVEL + NV;
// a model without sites still has one row of each (engine_cuda.out_specs)
constexpr int O_SITE_XMAT = O_SITE_XPOS + (NSITE > 0 ? 3 * NSITE : 1);
constexpr int O_XPOS = O_SITE_XMAT + (NSITE > 0 ? 9 * NSITE : 1);
constexpr int O_XROT = O_XPOS + 3 * (NBODY - 1);
constexpr int O_XDVEL = O_XROT + 4 * (NBODY - 1);
constexpr int O_XDANG = O_XDVEL + 3 * (NBODY - 1);
constexpr int O_CDIST = O_XDANG + 3 * (NBODY - 1);
constexpr int O_CPOS = O_CDIST + NCON1;
constexpr int O_QACC = O_CPOS + 3 * NCON1;
constexpr int N_OUT_ROWS = O_QACC + NV;
constexpr int N_IN_ROWS = NQ + NV + NU;
}  // namespace mc

enum { JNT_FREE = 0, JNT_BALL = 1, JNT_SLIDE = 2, JNT_HINGE = 3 };

// Tree topology and index tables.
struct ModelTopo {
  int body_parentid[mc::NBODY], body_rootid[mc::NBODY];
  int body_jntadr[mc::NBODY], body_jntnum[mc::NBODY];
  int body_dofadr[mc::NBODY], body_dofnum[mc::NBODY];
  int jnt_type[mc::NJNT], jnt_qposadr[mc::NJNT], jnt_dofadr[mc::NJNT], jnt_bodyid[mc::NJNT];
  int dof_bodyid[mc::NV];
  int site_bodyid[mc::NSITE1];
  // geoms that appear in the pair table, renumbered 0..NCGEOM-1
  int cgeom_bodyid[mc::NCGEOM1];
  int pair_g1[mc::NPAIR1], pair_g2[mc::NPAIR1], pair_conadr[mc::NPAIR1], pair_kind[mc::NPAIR1];
  int con_body1[mc::NCON1], con_body2[mc::NCON1];  // per contact slot
  int fric_dof[mc::NFRIC1], limit_jnt[mc::NLIMIT1];
  int act_qposadr[mc::NU1], act_affine[mc::NU1];
  int act_ctrllimited[mc::NU1], act_forcelimited[mc::NU1];
  // contact rows (with CON_TABLE): slot << 4 | direction << 1 | reversed;
  // directions 0 normal, 1-2 tangents, 3-5 rotations (engine_cuda.contact_rows)
  int crow[mc::NCROW1];
};

// The lists a team's lanes walk (engine_cuda.team_tables). A list xs with
// offsets xs_adr holds the entries of item k at xs[xs_adr[k] .. xs_adr[k+1]).
// Lists that one lane walks alone, item after item, are interleaved instead
// (xs with xs_at), so that at each step the lanes of a warp read adjacent
// words of one line: item k's n entries lie at s, s + LIST_STRIDE, ...,
// where xs_at[k] = s | n << 16 (newton_solve_team.cuh).
// The working set's matrices are stored on their static patterns alone, and
// an item that names an entry carries its position there, so that a lane finds
// both from one load:
// - M on its masked lower entries, in ment's order (M[i][j] and M[j][i] are
//   one value);
// - J on its rows' supports in row order: entry (r, i) at its place in
//   jrow_col (the rows of friction loss and of limits, one entry each and
//   first, at position r);
// - a factor schedule's matrix and factor (FactorSchedule) at pos: the
//   diagonal entry of row k at k, then row k's entries left of the diagonal
//   at NV + their place in back (rows, so that the backward sweep's phase
//   reads adjacent words).
// The factor schedules are in elimination order (dof nv-1-e is eliminated
// e-th, children first).
template <int NENT, int NCOL, int NUPD, int NBACK, int MAXCOL_, int MAXUPD_, int MAXBACK_>
struct FactorSchedule {
  // list lengths, and the longest column, update list and row
  static constexpr int NENT_ALL = NENT, NCOL_ALL = NCOL, NUPD_ALL = NUPD, NBACK_ALL = NBACK;
  static constexpr int MAXCOL = MAXCOL_, MAXUPD = MAXUPD_, MAXBACK = MAXBACK_;
  int ent[NENT];        // the pattern's lower entries (fill included): pos << 16 | r << 8 | c
  short ent_inm[NENT];  // each entry's position in M, or -1 outside M's mask
  short col_adr[mc::NV + 1];
  int col[NCOL];  // column c: rows r below the diagonal, packed r | pos(r, c) << 8
  // column c: trailing updates A[r][k] -= L[r][c] L[k][c], packed
  // pos(r, c) | pos(k, c) << 10 | pos(r, k) << 20
  short upd_adr[mc::NV + 1];
  int upd[NUPD];
  // row k: columns left of the diagonal (the e-th at NV + e)
  short back_adr[mc::NV + 1], back[NBACK];
};
#define MC_FACTOR(p)                                                                  \
  FactorSchedule<mc::at_least_1(MC_N_##p##_ent), mc::at_least_1(MC_N_##p##_col),      \
                 mc::at_least_1(MC_N_##p##_upd), mc::at_least_1(MC_N_##p##_back),     \
                 MC_##p##_MAXCOL, MC_##p##_MAXUPD, MC_##p##_MAXBACK>
#define MC_LIST_OF(type, name) type name[mc::at_least_1(MC_N_##name)]
#define MC_LIST(name) MC_LIST_OF(short, name)
#define MC_WALK(type, name) alignas(128) MC_LIST_OF(type, name)
struct TeamTables {
  MC_LIST(level_adr);  // bodies of depth d + 1 (the world has depth 0)
  MC_LIST(level_body);
  MC_LIST(child_adr);  // children of each body, ascending
  MC_LIST(child_body);
  MC_LIST(dof_jnt);
  MC_LIST(dact_adr);  // actuators of each dof
  MC_LIST(dact);
  MC_LIST(ment);      // masked lower entries (i, j <= i) of M, dof order
  MC_LIST_OF(int, mrow_at);  // M's symmetric rows: column j | position in M << 8
  MC_WALK(int, mrow_col);
  MC_LIST(jrow_adr);  // the dofs each constraint row can reach (entry e at J[e])
  MC_LIST(jrow_col);
  MC_LIST_OF(int, jcol_at);  // the rows that can reach each dof: row | position in J << 8
  MC_WALK(int, jcol_row);
  // contact-dof pairs: slot << 10 | side << 8 | dof, side bit 0 for body 1's
  // chain, bit 1 for body 2's (16 bits: unsigned)
  MC_LIST_OF(unsigned short, cpair);
  // per contact slot: its first contact-dof pair, and where its rotational
  // Jacobians lie (condim 6; -1 elsewhere). The contact Jacobians are rows of
  // three values (Jn, Jt1, Jt2, or the three rotations): pair q's at row q,
  // its rotational ones at row q + con_jrot[slot].
  MC_LIST_OF(int, con_cadr);
  MC_LIST_OF(int, con_jrot);
  // rows that reach both dofs (i, j) of each Hessian factor entry, packed
  // row | position of J[row][i] << 8 | position of J[row][j] << 20
  MC_LIST_OF(int, hrow_at);
  MC_WALK(unsigned, hrow);
  MC_LIST(hgrp_adr);  // elliptic groups whose rank-1 term reaches each entry
  MC_LIST(hgrp);
};
#undef MC_LIST
#undef MC_WALK
#undef MC_LIST_OF

// Real-valued constants, stored once for each compute type.
template <typename T>
struct ModelReal {
  T body_pos[mc::NBODY][3], body_quat[mc::NBODY][4];
  T body_ipos[mc::NBODY][3], body_iquat[mc::NBODY][4];
  T body_mass[mc::NBODY], body_inertia[mc::NBODY][3], body_invweight0[mc::NBODY][2];
  // 1 / max(subtree mass, 1e-15)
  T subtree_mass_inv[mc::NBODY];
  T jnt_pos[mc::NJNT][3], jnt_axis[mc::NJNT][3], jnt_range[mc::NJNT][2];
  T jnt_solref[mc::NJNT][2], jnt_solimp[mc::NJNT][5], jnt_margin[mc::NJNT];
  T qpos0[mc::NQ];
  T dof_armature[mc::NV], dof_damping[mc::NV], dof_invweight0[mc::NV];
  T dof_solref[mc::NV][2], dof_solimp[mc::NV][5];
  T efc_frictionloss[mc::NEFC1];  // each row's friction-loss bound, 0 but for dof rows
  T cgeom_pos[mc::NCGEOM1][3], cgeom_quat[mc::NCGEOM1][4], cgeom_size[mc::NCGEOM1][3];
  T site_pos[mc::NSITE1][3], site_quat[mc::NSITE1][4];
  T act_gear[mc::NU1], act_gain[mc::NU1], act_bias[mc::NU1][3];
  T act_ctrlrange[mc::NU1][2], act_forcerange[mc::NU1][2];
  T con_friction[mc::NCON1][5], con_solref[mc::NCON1][2], con_solimp[mc::NCON1][5];
  T con_includemargin[mc::NCON1];
  T efc_eta[mc::NEFC1];  // each elliptic friction row's coefficient, 0 elsewhere
};

// What every lane reads at the same time.
template <typename T>
struct ModelScalars {
  T gravity[3];
  T timestep, tolerance, impratio;
};

__device__ const ModelTopo g_topo = {
    MCI_body_parentid, MCI_body_rootid, MCI_body_jntadr, MCI_body_jntnum,
    MCI_body_dofadr, MCI_body_dofnum,
    MCI_jnt_type, MCI_jnt_qposadr, MCI_jnt_dofadr, MCI_jnt_bodyid,
    MCI_dof_bodyid, MCI_site_bodyid, MCI_cgeom_bodyid,
    MCI_pair_g1, MCI_pair_g2, MCI_pair_conadr, MCI_pair_kind, MCI_con_body1, MCI_con_body2,
    MCI_fric_dof, MCI_limit_jnt,
    MCI_act_qposadr, MCI_act_affine,
    MCI_act_ctrllimited, MCI_act_forcelimited, MCI_crow};

__device__ const TeamTables g_lists = {
    MCI_level_adr, MCI_level_body, MCI_child_adr, MCI_child_body, MCI_dof_jnt,
    MCI_dact_adr, MCI_dact, MCI_ment, MCI_mrow_at, MCI_mrow_col,
    MCI_jrow_adr, MCI_jrow_col, MCI_jcol_at, MCI_jcol_row, MCI_cpair,
    MCI_con_cadr, MCI_con_jrot, MCI_hrow_at, MCI_hrow, MCI_hgrp_adr, MCI_hgrp};

__device__ const MC_FACTOR(mf) g_mfac = {
    MCI_mf_ent, MCI_mf_ent_inm, MCI_mf_col_adr, MCI_mf_col,
    MCI_mf_upd_adr, MCI_mf_upd, MCI_mf_back_adr, MCI_mf_back};
__device__ const MC_FACTOR(hf) g_hfac = {
    MCI_hf_ent, MCI_hf_ent_inm, MCI_hf_col_adr, MCI_hf_col,
    MCI_hf_upd_adr, MCI_hf_upd, MCI_hf_back_adr, MCI_hf_back};

#define MODEL_REAL_INIT                                                          \
  {MCI_body_pos, MCI_body_quat, MCI_body_ipos, MCI_body_iquat, MCI_body_mass,    \
   MCI_body_inertia, MCI_body_invweight0, MCI_subtree_mass_inv, MCI_jnt_pos,     \
   MCI_jnt_axis, MCI_jnt_range, MCI_jnt_solref, MCI_jnt_solimp, MCI_jnt_margin,  \
   MCI_qpos0, MCI_dof_armature, MCI_dof_damping, MCI_dof_invweight0,             \
   MCI_dof_solref, MCI_dof_solimp, MCI_efc_frictionloss,                         \
   MCI_cgeom_pos, MCI_cgeom_quat, MCI_cgeom_size, MCI_site_pos, MCI_site_quat,   \
   MCI_act_gear, MCI_act_gain, MCI_act_bias, MCI_act_ctrlrange,                  \
   MCI_act_forcerange, MCI_con_friction, MCI_con_solref, MCI_con_solimp,         \
   MCI_con_includemargin, MCI_efc_eta}
#define MODEL_SCALARS_INIT {MCI_gravity, MCI_timestep, MCI_tolerance, MCI_impratio}

// the double literals of the header narrow to float here: the constants are
// rounded once, at compile time, to the type the kernel computes in
__device__ const ModelReal<float> g_real_f = MODEL_REAL_INIT;
__device__ const ModelReal<double> g_real_d = MODEL_REAL_INIT;
__constant__ ModelScalars<float> g_scal_f = MODEL_SCALARS_INIT;
__constant__ ModelScalars<double> g_scal_d = MODEL_SCALARS_INIT;

template <typename T>
__device__ __forceinline__ const ModelReal<T>& model_real();
template <>
__device__ __forceinline__ const ModelReal<float>& model_real<float>() { return g_real_f; }
template <>
__device__ __forceinline__ const ModelReal<double>& model_real<double>() { return g_real_d; }
template <typename T>
__device__ __forceinline__ const ModelScalars<T>& model_scalars();
template <>
__device__ __forceinline__ const ModelScalars<float>& model_scalars<float>() { return g_scal_f; }
template <>
__device__ __forceinline__ const ModelScalars<double>& model_scalars<double>() { return g_scal_d; }
