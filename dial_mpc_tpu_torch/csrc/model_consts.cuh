// Model constants of the step kernel, in constant memory.
//
// "model_constants.h" is generated at build time from the loaded model
// (engine_cuda.py::render_constants_header): it defines the sizes below as
// MC_* integer macros and one brace-initialiser macro per field, named
// MCI_<field>. Everything else about the kernel is written here by hand.
// Every thread of a warp reads the same constant at the same time, so these
// reads are broadcasts from the constant cache.
#pragma once

#include "model_constants.h"

namespace mc {
constexpr int NQ = MC_NQ, NV = MC_NV, NU = MC_NU, NBODY = MC_NBODY, NJNT = MC_NJNT;
constexpr int NSITE = MC_NSITE, NCON = MC_NCON, NPAIR = MC_NPAIR, NCGEOM = MC_NCGEOM;
constexpr int NLIMIT = MC_NLIMIT, NEFC = MC_NEFC;
constexpr int ITERATIONS = MC_ITERATIONS, LS_ITERATIONS = MC_LS_ITERATIONS;
// arrays of a size that may be zero get one unused element
constexpr int NSITE1 = NSITE > 0 ? NSITE : 1, NCON1 = NCON > 0 ? NCON : 1;
constexpr int NPAIR1 = NPAIR > 0 ? NPAIR : 1, NCGEOM1 = NCGEOM > 0 ? NCGEOM : 1;
constexpr int NLIMIT1 = NLIMIT > 0 ? NLIMIT : 1, NEFC1 = NEFC > 0 ? NEFC : 1;
constexpr int NU1 = NU > 0 ? NU : 1;

// output rows, in the order the wrapper splits them
constexpr int O_QPOS = 0;
constexpr int O_QVEL = O_QPOS + NQ;
constexpr int O_SITE_XPOS = O_QVEL + NV;
constexpr int O_SITE_XMAT = O_SITE_XPOS + 3 * NSITE1;
constexpr int O_XPOS = O_SITE_XMAT + 9 * NSITE1;
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

// Tree topology, index tables and the static sparsity patterns.
struct ModelTopo {
  int body_parentid[mc::NBODY], body_rootid[mc::NBODY];
  int body_jntadr[mc::NBODY], body_jntnum[mc::NBODY];
  int body_dofadr[mc::NBODY], body_dofnum[mc::NBODY];
  int jnt_type[mc::NJNT], jnt_qposadr[mc::NJNT], jnt_dofadr[mc::NJNT], jnt_bodyid[mc::NJNT];
  int dof_bodyid[mc::NV];
  int site_bodyid[mc::NSITE1];
  // geoms that appear in the pair table, renumbered 0..NCGEOM-1
  int cgeom_bodyid[mc::NCGEOM1];
  int pair_g1[mc::NPAIR1], pair_g2[mc::NPAIR1], pair_conadr[mc::NPAIR1];
  int con_body1[mc::NCON1], con_body2[mc::NCON1];
  int limit_jnt[mc::NLIMIT1];
  int act_dofadr[mc::NU1], act_qposadr[mc::NU1], act_affine[mc::NU1];
  int act_ctrllimited[mc::NU1], act_forcelimited[mc::NU1];
  // chain_mask[b][i]: dof i lies on the chain from the world to body b
  unsigned char chain_mask[mc::NBODY][mc::NV];
  // m_mask: tree sparsity of the mass matrix; h_mask: of the Newton Hessian
  // (m_mask plus the outer product of every constraint row's support)
  unsigned char m_mask[mc::NV][mc::NV], h_mask[mc::NV][mc::NV];
  // the same two patterns in elimination order (children first: dof nv-1-i
  // is eliminated i-th), closed under the fill-in that order implies
  unsigned char m_pat[mc::NV][mc::NV], h_pat[mc::NV][mc::NV];
  // j_sup[r][i]: constraint row r can be non-zero at dof i
  unsigned char j_sup[mc::NEFC1][mc::NV];
};

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
  T cgeom_pos[mc::NCGEOM1][3], cgeom_quat[mc::NCGEOM1][4], cgeom_size[mc::NCGEOM1][3];
  T site_pos[mc::NSITE1][3], site_quat[mc::NSITE1][4];
  T act_gear[mc::NU1], act_gain[mc::NU1], act_bias[mc::NU1][3];
  T act_ctrlrange[mc::NU1][2], act_forcerange[mc::NU1][2];
  T con_friction[mc::NCON1][5], con_solref[mc::NCON1][2], con_solimp[mc::NCON1][5];
  T con_includemargin[mc::NCON1];
  T gravity[3];
  T timestep, tolerance;
};

__constant__ ModelTopo g_topo = {
    MCI_body_parentid, MCI_body_rootid, MCI_body_jntadr, MCI_body_jntnum,
    MCI_body_dofadr, MCI_body_dofnum,
    MCI_jnt_type, MCI_jnt_qposadr, MCI_jnt_dofadr, MCI_jnt_bodyid,
    MCI_dof_bodyid, MCI_site_bodyid, MCI_cgeom_bodyid,
    MCI_pair_g1, MCI_pair_g2, MCI_pair_conadr, MCI_con_body1, MCI_con_body2,
    MCI_limit_jnt,
    MCI_act_dofadr, MCI_act_qposadr, MCI_act_affine,
    MCI_act_ctrllimited, MCI_act_forcelimited,
    MCI_chain_mask, MCI_m_mask, MCI_h_mask, MCI_m_pat, MCI_h_pat, MCI_j_sup};

#define MODEL_REAL_INIT                                                          \
  {MCI_body_pos, MCI_body_quat, MCI_body_ipos, MCI_body_iquat, MCI_body_mass,    \
   MCI_body_inertia, MCI_body_invweight0, MCI_subtree_mass_inv, MCI_jnt_pos,     \
   MCI_jnt_axis, MCI_jnt_range, MCI_jnt_solref, MCI_jnt_solimp, MCI_jnt_margin,  \
   MCI_qpos0, MCI_dof_armature, MCI_dof_damping, MCI_dof_invweight0,             \
   MCI_cgeom_pos, MCI_cgeom_quat, MCI_cgeom_size, MCI_site_pos, MCI_site_quat,   \
   MCI_act_gear, MCI_act_gain, MCI_act_bias, MCI_act_ctrlrange,                  \
   MCI_act_forcerange, MCI_con_friction, MCI_con_solref, MCI_con_solimp,         \
   MCI_con_includemargin, MCI_gravity, MCI_timestep, MCI_tolerance}

// the double literals of the header narrow to float here: the constants are
// rounded once, at compile time, to the type the kernel computes in
__constant__ ModelReal<float> g_real_f = MODEL_REAL_INIT;
__constant__ ModelReal<double> g_real_d = MODEL_REAL_INIT;

template <typename T>
__device__ __forceinline__ const ModelReal<T>& model_real();
template <>
__device__ __forceinline__ const ModelReal<float>& model_real<float>() { return g_real_f; }
template <>
__device__ __forceinline__ const ModelReal<double>& model_real<double>() { return g_real_d; }
