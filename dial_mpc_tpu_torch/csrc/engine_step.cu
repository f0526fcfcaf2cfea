// One whole physics step per sample, one sample per thread.
//
// Replaces the JAX package's Pallas step kernel,
// dial_mpc_tpu/physics/engine_pallas.py::_build_step_kernel and
// ::_build_multistep_kernel, together with the Newton solve it calls in
// kernel, dial_mpc_tpu/physics/solver_pallas.py::newton_solve_rows and
// ::_chol_solve_lanes.
//
// Stages, per sample: kinematics -> geom/site frames -> CoM and spatial
// inertias -> com velocities -> RNE bias -> CRB mass matrix -> passive and
// actuation -> collision over the static pair table -> constraint rows ->
// sparse Newton solve with exact line search -> Euler integration with the
// quaternion update -> maximal-coordinate views taken at the pre-step
// kinematics. With n_steps > 1 the (qpos, qvel) carry stays in the thread
// and only the last substep writes outputs.
//
// What bounds it: traffic is NQ+NV+NU values in and N_OUT_ROWS values out
// per sample and launch (49 + 300 for the Go2 flat scene, about 2.9 MB at
// 2049 samples in float32), against tens of thousands of dependent
// floating-point operations per sample. At one sample per thread 2049
// samples are 65 warps for 132 SMs, so the kernel is bound by dependent
// arithmetic latency and occupancy, not by memory. This first design does
// nothing about that beyond spreading the warps over the SMs (32 threads a
// block): the per-thread working set (mass matrix, Hessian, Jacobian rows)
// lives in local memory, the sample axis is contiguous in global memory so
// loads and stores coalesce, and loops over bodies, dofs and rows are real
// loops whose static sparsity is read from constant memory.
//
// Scope: free and hinge joints, plane-sphere pairs of condim 3, pyramidal
// cones, plain Euler (eulerdamp disabled), no friction-loss dofs. The Python
// wrapper refuses any other model before it builds this file.

#include <cuda_runtime.h>

#include "lane_math.cuh"
#include "model_consts.cuh"
#include "newton_solve.cuh"

using namespace mc;

#define MJ_MINVAL 1e-15

// ---------------------------------------------------------------------------
// soft-constraint impedance and reference acceleration
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T impedance(const T* solimp, T pos) {
  const T d0 = solimp[0], dmax = solimp[1], width = solimp[2], mid = solimp[3],
          power = solimp[4];
  T x = fabs(pos) / tmax(width, T(MJ_MINVAL));
  T ya = pow(x, power) / tmax(pow(mid, power - T(1)), T(MJ_MINVAL));
  T yb = T(1) - pow(T(1) - x, power) / tmax(pow(T(1) - mid, power - T(1)), T(MJ_MINVAL));
  T y = x < mid ? ya : yb;
  T imp = tclip(d0 + y * (dmax - d0), T(1e-4), T(0.9999));
  return x > T(1) ? dmax : imp;
}

// returns the impedance; *aref = -b*vel - k*imp*pos
template <typename T>
__device__ __forceinline__ T kbi(const T* solref, const T* solimp, T timestep, T pos, T vel,
                                 T* aref) {
  T imp = impedance(solimp, pos);
  T dmax = solimp[1];
  T timeconst = tmax(solref[0], T(2) * timestep);
  T dampratio = solref[1];
  T b = T(2) / tmax(dmax * timeconst, T(MJ_MINVAL));
  T k = T(1) / tmax(dmax * dmax * timeconst * timeconst * dampratio * dampratio, T(MJ_MINVAL));
  if (solref[0] <= T(0)) k = -solref[0] / tmax(dmax * dmax, T(MJ_MINVAL));
  if (solref[1] <= T(0)) b = -solref[1] / tmax(dmax, T(MJ_MINVAL));
  *aref = -b * vel - k * imp * pos;
  return imp;
}

// mju_makeFrame rows [n; t1; t2]
template <typename T>
__device__ __forceinline__ void make_frame(T* frame, const T* n) {
  bool ref_y = fabs(n[1]) < T(0.5);
  T ref[3] = {T(0), ref_y ? T(1) : T(0), ref_y ? T(0) : T(1)};
  T c[3];
  v3_cross(c, n, ref);
  v3_copy(frame, n);
  v3_normalize(frame + 6, c);
  v3_cross(frame + 3, frame + 6, n);
}

// ---------------------------------------------------------------------------
// The in-kernel Newton solve (newton_solve.cuh) on this model's static
// sparsity: unilateral rows only, patterns read from constant memory.
// ---------------------------------------------------------------------------

struct EnginePolicy {
  static constexpr int NV = mc::NV, NEFC = mc::NEFC;
  static constexpr int ITERATIONS = mc::ITERATIONS, LS_ITERATIONS = mc::LS_ITERATIONS;
  static constexpr int NGROUPS = 0;
  static constexpr bool FRICTION_ROWS = false;
  static __device__ __forceinline__ bool j_sup(int r, int i) { return g_topo.j_sup[r][i]; }
  static __device__ __forceinline__ bool m_mask(int i, int j) { return g_topo.m_mask[i][j]; }
  static __device__ __forceinline__ bool h_mask(int i, int j) { return g_topo.h_mask[i][j]; }
  template <typename T>
  static __device__ __forceinline__ void solve_hessian(const T (*H)[NV], const T* g, T* x,
                                                       T (*L)[NV]) {
    chol_solve<T, NV, false>(H, g_topo.h_mask, g_topo.h_pat, g, x, L);
  }
};

// ---------------------------------------------------------------------------
// one physics step
// ---------------------------------------------------------------------------

// Advances (qp, qv) in place under ctrl ct. With out != nullptr it also
// writes the step's outputs for sample `tid` of `B` (row-major (rows, B)).
template <typename T>
__device__ __noinline__ void step_once(T* qp, T* qv, const T* ct, T* out, int tid, int B) {
  const ModelReal<T>& R = model_real<T>();
  const ModelTopo& tp = g_topo;

  // ---- kinematics ----
  T xpos[NBODY][3], xquat[NBODY][4], xanchor[NJNT][3], xaxis[NJNT][3];
  v3_set(xpos[0], T(0), T(0), T(0));
  xquat[0][0] = T(1); xquat[0][1] = T(0); xquat[0][2] = T(0); xquat[0][3] = T(0);
  for (int b = 1; b < NBODY; ++b) {
    const int p = tp.body_parentid[b];
    T pos[3], quat[4], tmp[3], tq[4];
    quat_rot(tmp, R.body_pos[b], xquat[p]);
    v3_add(pos, xpos[p], tmp);
    quat_mul(quat, xquat[p], R.body_quat[b]);
    for (int k = 0; k < tp.body_jntnum[b]; ++k) {
      const int j = tp.body_jntadr[b] + k;
      const int qadr = tp.jnt_qposadr[j];
      if (tp.jnt_type[j] == JNT_FREE) {
        v3_copy(pos, qp + qadr);
        quat_normalize(quat, qp + qadr + 3);
        v3_copy(xanchor[j], pos);
        v3_copy(xaxis[j], R.jnt_axis[j]);
      } else {  // hinge
        T anchor[3];
        quat_rot(tmp, R.jnt_pos[j], quat);
        v3_add(anchor, pos, tmp);
        T angle = qp[qadr] - R.qpos0[qadr];
        T s = sin(angle * T(0.5)), c = cos(angle * T(0.5));
        T qloc[4] = {c, R.jnt_axis[j][0] * s, R.jnt_axis[j][1] * s, R.jnt_axis[j][2] * s};
        quat_mul(tq, quat, qloc);
        for (int i = 0; i < 4; ++i) quat[i] = tq[i];
        quat_rot(tmp, R.jnt_pos[j], quat);
        v3_sub(pos, anchor, tmp);
        v3_copy(xanchor[j], anchor);
        quat_rot(xaxis[j], R.jnt_axis[j], quat);
      }
    }
    v3_copy(xpos[b], pos);
    quat_normalize(xquat[b], quat);
  }

  // ---- CoM quantities ----
  T xipos[NBODY][3], subtree_com[NBODY][3];
  for (int b = 0; b < NBODY; ++b) {
    T tmp[3];
    quat_rot(tmp, R.body_ipos[b], xquat[b]);
    v3_add(xipos[b], xpos[b], tmp);
    v3_scale(subtree_com[b], xipos[b], R.body_mass[b]);  // weighted sum, scaled below
  }
  for (int b = NBODY - 1; b > 0; --b) {
    const int p = tp.body_parentid[b];
    v3_add(subtree_com[p], subtree_com[p], subtree_com[b]);
  }
  for (int b = 0; b < NBODY; ++b) v3_scale(subtree_com[b], subtree_com[b], R.subtree_mass_inv[b]);

  // spatial inertia of each body about its tree root's subtree CoM
  T cinert[NBODY][36];
  for (int b = 0; b < NBODY; ++b) {
    T c[3], iq[4], Rm[9];
    v3_sub(c, xipos[b], subtree_com[tp.body_rootid[b]]);
    quat_mul(iq, xquat[b], R.body_iquat[b]);
    quat_to_mat(Rm, iq);
    const T mass = R.body_mass[b];
    const T* I3 = R.body_inertia[b];
    const T cx[3][3] = {{T(0), -c[2], c[1]}, {c[2], T(0), -c[0]}, {-c[1], c[0], T(0)}};
    T* M6 = cinert[b];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        T Iw = Rm[3 * i] * I3[0] * Rm[3 * j] + Rm[3 * i + 1] * I3[1] * Rm[3 * j + 1] +
               Rm[3 * i + 2] * I3[2] * Rm[3 * j + 2];
        M6[6 * i + j] =
            Iw + mass * (cx[i][0] * cx[j][0] + cx[i][1] * cx[j][1] + cx[i][2] * cx[j][2]);
        M6[6 * i + 3 + j] = mass * cx[i][j];
        M6[6 * (3 + i) + j] = mass * cx[j][i];
        M6[6 * (3 + i) + 3 + j] = i == j ? mass : T(0);
      }
  }

  // dof motion subspaces about subtree_com[root]
  T cdof[NV][6];
  for (int j = 0; j < NJNT; ++j) {
    const int b = tp.jnt_bodyid[j], da = tp.jnt_dofadr[j];
    const T* o = subtree_com[tp.body_rootid[b]];
    if (tp.jnt_type[j] == JNT_FREE) {
      T Rm[9], rel[3];
      quat_to_mat(Rm, xquat[b]);
      v3_sub(rel, o, xpos[b]);
      for (int i = 0; i < 3; ++i) {
        for (int x = 0; x < 6; ++x) cdof[da + i][x] = x == 3 + i ? T(1) : T(0);
        mat_col(cdof[da + 3 + i], Rm, i);
        v3_cross(cdof[da + 3 + i] + 3, cdof[da + 3 + i], rel);
      }
    } else {  // hinge
      T rel[3];
      v3_sub(rel, o, xanchor[j]);
      v3_copy(cdof[da], xaxis[j]);
      v3_cross(cdof[da] + 3, xaxis[j], rel);
    }
  }

  // ---- com velocities ----
  T cvel[NBODY][6], cdof_dot[NV][6];
  for (int x = 0; x < 6; ++x) cvel[0][x] = T(0);
  for (int b = 1; b < NBODY; ++b) {
    T v6[6];
    for (int x = 0; x < 6; ++x) v6[x] = cvel[tp.body_parentid[b]][x];
    for (int k = 0; k < tp.body_jntnum[b]; ++k) {
      const int j = tp.body_jntadr[b] + k, da = tp.jnt_dofadr[j];
      if (tp.jnt_type[j] == JNT_FREE) {
        // translation dofs accumulate before the rotation dofs' cross products
        for (int i = 0; i < 3; ++i) {
          for (int x = 0; x < 6; ++x) cdof_dot[da + i][x] = T(0);
          for (int x = 0; x < 6; ++x) v6[x] = v6[x] + cdof[da + i][x] * qv[da + i];
        }
        for (int i = 0; i < 3; ++i) motion_cross(cdof_dot[da + 3 + i], v6, cdof[da + 3 + i]);
        for (int i = 0; i < 3; ++i)
          for (int x = 0; x < 6; ++x) v6[x] = v6[x] + cdof[da + 3 + i][x] * qv[da + 3 + i];
      } else {
        motion_cross(cdof_dot[da], v6, cdof[da]);
        for (int x = 0; x < 6; ++x) v6[x] = v6[x] + cdof[da][x] * qv[da];
      }
    }
    for (int x = 0; x < 6; ++x) cvel[b][x] = v6[x];
  }

  // ---- RNE bias ----
  T cfrc[NBODY][6];
  {
    T cacc[NBODY][6];
    for (int x = 0; x < 3; ++x) { cacc[0][x] = T(0); cacc[0][3 + x] = -R.gravity[x]; }
    for (int b = 1; b < NBODY; ++b) {
      const int da = tp.body_dofadr[b];
      for (int x = 0; x < 6; ++x) cacc[b][x] = cacc[tp.body_parentid[b]][x];
      for (int i = 0; i < tp.body_dofnum[b]; ++i)
        for (int x = 0; x < 6; ++x) cacc[b][x] = cacc[b][x] + cdof_dot[da + i][x] * qv[da + i];
    }
    for (int b = 1; b < NBODY; ++b) {
      T h6[6], f6[6], fc[6];
      m6_vec(h6, cinert[b], cvel[b]);
      m6_vec(f6, cinert[b], cacc[b]);
      force_cross(fc, cvel[b], h6);
      for (int x = 0; x < 6; ++x) cfrc[b][x] = f6[x] + fc[x];
    }
  }
  for (int b = NBODY - 1; b > 1; --b) {
    const int p = tp.body_parentid[b];
    if (p > 0)
      for (int x = 0; x < 6; ++x) cfrc[p][x] = cfrc[p][x] + cfrc[b][x];
  }
  T qfrc_smooth[NV];  // holds the bias first
  for (int i = 0; i < NV; ++i) qfrc_smooth[i] = v6_dot(cdof[i], cfrc[tp.dof_bodyid[i]]);

  // ---- CRB mass matrix (cinert becomes the composite inertia) ----
  for (int b = NBODY - 1; b > 0; --b) {
    const int p = tp.body_parentid[b];
    if (p > 0)
      for (int x = 0; x < 36; ++x) cinert[p][x] = cinert[p][x] + cinert[b][x];
  }
  T M[NV][NV];
  for (int i = 0; i < NV; ++i) {
    T F[6];
    m6_vec(F, cinert[tp.dof_bodyid[i]], cdof[i]);
    for (int j = 0; j <= i; ++j) {
      T val = tp.m_mask[i][j] ? v6_dot(F, cdof[j]) : T(0);
      M[i][j] = val;
      M[j][i] = val;
    }
    M[i][i] = M[i][i] + R.dof_armature[i];
  }

  // ---- passive + actuation ----
  for (int i = 0; i < NV; ++i) qfrc_smooth[i] = -R.dof_damping[i] * qv[i] - qfrc_smooth[i];
  for (int u = 0; u < NU; ++u) {
    T c = ct[u];
    if (tp.act_ctrllimited[u]) c = tclip(c, R.act_ctrlrange[u][0], R.act_ctrlrange[u][1]);
    T force = R.act_gain[u] * c;
    const int i = tp.act_dofadr[u];
    if (tp.act_affine[u]) {
      T length = qp[tp.act_qposadr[u]] * R.act_gear[u];
      T vel = qv[i] * R.act_gear[u];
      force = force + (R.act_bias[u][0] + R.act_bias[u][1] * length + R.act_bias[u][2] * vel);
    }
    if (tp.act_forcelimited[u]) force = tclip(force, R.act_forcerange[u][0], R.act_forcerange[u][1]);
    qfrc_smooth[i] = qfrc_smooth[i] + force * R.act_gear[u];
  }

  T qacc[NV];
  T L[NV][NV], H[NV][NV];
  chol_solve<T, NV, false>(M, tp.m_mask, tp.m_pat, qfrc_smooth, qacc, L);  // qacc_smooth

  // ---- collision: plane (g1) against sphere (g2) ----
  T con_dist[NCON1], con_pos[NCON1][3], con_frame[NCON1][9];
  for (int pr = 0; pr < NPAIR; ++pr) {
    const int g1 = tp.pair_g1[pr], g2 = tp.pair_g2[pr], slot = tp.pair_conadr[pr];
    const int b1 = tp.cgeom_bodyid[g1], b2 = tp.cgeom_bodyid[g2];
    T p1[3], p2[3], tmp[3], gq[4], R1[9], pn[3], rel[3];
    quat_rot(tmp, R.cgeom_pos[g1], xquat[b1]);
    v3_add(p1, xpos[b1], tmp);
    quat_mul(gq, xquat[b1], R.cgeom_quat[g1]);
    quat_to_mat(R1, gq);
    quat_rot(tmp, R.cgeom_pos[g2], xquat[b2]);
    v3_add(p2, xpos[b2], tmp);
    mat_col(pn, R1, 2);
    const T r = R.cgeom_size[g2][0];
    v3_sub(rel, p2, p1);
    T dist = v3_dot(pn, rel) - r;
    v3_scale(tmp, pn, r + T(0.5) * dist);
    v3_sub(con_pos[slot], p2, tmp);
    con_dist[slot] = dist;
    make_frame(con_frame[slot], pn);
  }

  // ---- constraint rows: joint limits, then four pyramid facets a contact ----
  T J[NEFC1][NV], D[NEFC1], aref[NEFC1];
  const T timestep = R.timestep;
  ROW_LOOP
  for (int l = 0; l < NLIMIT; ++l) {
    const int j = tp.limit_jnt[l];
    const int dadr = tp.jnt_dofadr[j];
    T q = qp[tp.jnt_qposadr[j]];
    T dist_lo = q - R.jnt_range[j][0], dist_hi = R.jnt_range[j][1] - q;
    bool use_lo = dist_lo < dist_hi;
    T dist = use_lo ? dist_lo : dist_hi;
    T sign = use_lo ? T(1) : T(-1);
    T pos = dist - R.jnt_margin[j];
    T active = dist < R.jnt_margin[j] ? T(1) : T(0);
    T ar;
    T imp = kbi(R.jnt_solref[j], R.jnt_solimp[j], timestep, pos, sign * qv[dadr], &ar);
    T Rr = tmax((T(1) - imp) / imp * R.dof_invweight0[dadr], T(MJ_MINVAL));
    J[l][dadr] = sign * active;
    D[l] = active / Rr;
    aref[l] = ar * active;
  }
  for (int slot = 0; slot < NCON; ++slot) {
    const int b1 = tp.con_body1[slot], b2 = tp.con_body2[slot];
    const int row0 = NLIMIT + 4 * slot;
    const T* frame = con_frame[slot];
    T pos = con_dist[slot] - R.con_includemargin[slot];
    T active = con_dist[slot] < R.con_includemargin[slot] ? T(1) : T(0);
    T off1[3], off2[3];
    v3_sub(off1, con_pos[slot], subtree_com[tp.body_rootid[b1]]);
    v3_sub(off2, con_pos[slot], subtree_com[tp.body_rootid[b2]]);
    T unused;
    T imp = kbi(R.con_solref[slot], R.con_solimp[slot], timestep, pos, T(0), &unused);
    const T invw_t = R.body_invweight0[b1][0] + R.body_invweight0[b2][0];

    // translational Jacobian difference (body 2 minus body 1) along the frame
    T Jn[NV], Jt[2][NV];
    for (int i = 0; i < NV; ++i) {
      const bool in1 = tp.chain_mask[b1][i], in2 = tp.chain_mask[b2][i];
      if (!in1 && !in2) continue;
      T dj[3] = {T(0), T(0), T(0)}, cr[3], jp[3];
      if (in2) {
        v3_cross(cr, cdof[i], off2);
        v3_add(dj, cdof[i] + 3, cr);
      }
      if (in1) {
        v3_cross(cr, cdof[i], off1);
        v3_add(jp, cdof[i] + 3, cr);
        if (in2) { v3_sub(dj, dj, jp); } else { v3_set(dj, -jp[0], -jp[1], -jp[2]); }
      }
      Jn[i] = v3_dot(dj, frame);
      Jt[0][i] = v3_dot(dj, frame + 3);
      Jt[1][i] = v3_dot(dj, frame + 6);
    }
    for (int kdir = 0; kdir < 2; ++kdir) {
      const T mu = R.con_friction[slot][kdir];
      const T invw_fac = invw_t + mu * mu * invw_t;
      T Rr = tmax((T(1) - imp) / imp * invw_fac * T(2) * mu * mu, T(MJ_MINVAL));
      for (int sg = 0; sg < 2; ++sg) {
        const int r = row0 + 2 * kdir + sg;
        const T smu = sg == 0 ? mu : -mu;
        T vel = T(0);
        bool first = true;
        for (int i = 0; i < NV; ++i) {
          if (!tp.j_sup[r][i]) continue;
          T e = Jn[i] + smu * Jt[kdir][i];
          J[r][i] = e * active;
          vel = first ? e * qv[i] : vel + e * qv[i];
          first = false;
        }
        T ar;
        kbi(R.con_solref[slot], R.con_solimp[slot], timestep, pos, vel, &ar);
        D[r] = active / Rr;
        aref[r] = ar * active;
      }
    }
  }

  // ---- Newton solve ----
  if (NEFC > 0) {
    const RowData<T> rows = {D, aref, nullptr, nullptr};
    newton_solve<EnginePolicy, T>(LocalMat<T, NV>{J}, rows, LocalMat<T, NV>{M}, qacc, H, L,
                                  R.tolerance, (T*)nullptr);
  }

  // ---- outputs that belong to the pre-step state ----
  if (out != nullptr) {
    T* o = out + tid;
    for (int i = 0; i < NV; ++i) o[(size_t)(O_QACC + i) * B] = qacc[i];
    for (int s = 0; s < NSITE; ++s) {
      const int b = tp.site_bodyid[s];
      T tmp[3], sx[3], sq[4], Rs[9];
      quat_rot(tmp, R.site_pos[s], xquat[b]);
      v3_add(sx, xpos[b], tmp);
      quat_mul(sq, xquat[b], R.site_quat[s]);
      quat_to_mat(Rs, sq);
      for (int i = 0; i < 3; ++i) o[(size_t)(O_SITE_XPOS + 3 * s + i) * B] = sx[i];
      for (int i = 0; i < 9; ++i) o[(size_t)(O_SITE_XMAT + 9 * s + i) * B] = Rs[i];
    }
    if (NSITE == 0) {
      o[(size_t)O_SITE_XPOS * B] = T(0);
      o[(size_t)O_SITE_XMAT * B] = T(0);
    }
    for (int b = 1; b < NBODY; ++b) {
      T off[3], cr[3];
      v3_sub(off, xpos[b], subtree_com[tp.body_rootid[b]]);
      v3_cross(cr, cvel[b], off);
      for (int i = 0; i < 3; ++i) {
        o[(size_t)(O_XPOS + 3 * (b - 1) + i) * B] = xpos[b][i];
        o[(size_t)(O_XDVEL + 3 * (b - 1) + i) * B] = cvel[b][3 + i] + cr[i];
        o[(size_t)(O_XDANG + 3 * (b - 1) + i) * B] = cvel[b][i];
      }
      for (int i = 0; i < 4; ++i) o[(size_t)(O_XROT + 4 * (b - 1) + i) * B] = xquat[b][i];
    }
    for (int s = 0; s < NCON; ++s) {
      o[(size_t)(O_CDIST + s) * B] = con_dist[s];
      for (int i = 0; i < 3; ++i) o[(size_t)(O_CPOS + 3 * s + i) * B] = con_pos[s][i];
    }
    if (NCON == 0)
      for (int i = 0; i < 4; ++i) o[(size_t)(O_CDIST + i) * B] = T(0);
  }

  // ---- integrate (semi-implicit Euler) ----
  const T h = timestep;
  for (int i = 0; i < NV; ++i) qv[i] = qv[i] + h * qacc[i];
  for (int j = 0; j < NJNT; ++j) {
    const int qadr = tp.jnt_qposadr[j], dadr = tp.jnt_dofadr[j];
    if (tp.jnt_type[j] == JNT_FREE) {
      for (int i = 0; i < 3; ++i) qp[qadr + i] = qp[qadr + i] + h * qv[dadr + i];
      const T* omega = qv + dadr + 3;
      T angle = v3_norm(omega) * h;
      T axis[3];
      v3_scale(axis, omega, T(1) / v3_norm(omega));
      T s = sin(angle * T(0.5)), c = cos(angle * T(0.5));
      T dq[4] = {c, axis[0] * s, axis[1] * s, axis[2] * s}, qn[4];
      quat_mul(qn, qp + qadr + 3, dq);
      quat_normalize(qp + qadr + 3, qn);
    } else {
      qp[qadr] = qp[qadr] + h * qv[dadr];
    }
  }

  if (out != nullptr) {
    T* o = out + tid;
    for (int i = 0; i < NQ; ++i) o[(size_t)(O_QPOS + i) * B] = qp[i];
    for (int i = 0; i < NV; ++i) o[(size_t)(O_QVEL + i) * B] = qv[i];
  }
}

// in: (N_IN_ROWS, B) rows qpos, qvel, ctrl; out: (N_OUT_ROWS, B)
template <typename T>
__global__ void engine_step_kernel(const T* __restrict__ in, T* __restrict__ out, int B,
                                   int n_steps) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= B) return;
  T qp[NQ], qv[NV], ct[NU1];
  for (int i = 0; i < NQ; ++i) qp[i] = in[(size_t)i * B + tid];
  for (int i = 0; i < NV; ++i) qv[i] = in[(size_t)(NQ + i) * B + tid];
  for (int i = 0; i < NU; ++i) ct[i] = in[(size_t)(NQ + NV + i) * B + tid];
  for (int s = 0; s < n_steps - 1; ++s) step_once<T>(qp, qv, ct, nullptr, tid, B);
  step_once<T>(qp, qv, ct, out, tid, B);
}

constexpr int THREADS_PER_BLOCK = 32;

template <typename T>
static int launch(const void* in, void* out, int B, int n_steps, void* stream) {
  if (B <= 0 || n_steps < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (B + THREADS_PER_BLOCK - 1) / THREADS_PER_BLOCK;
  engine_step_kernel<T><<<blocks, THREADS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      (const T*)in, (T*)out, B, n_steps);
  return (int)cudaGetLastError();
}

extern "C" {
int engine_step_f32(const void* in, void* out, int B, int n_steps, void* stream) {
  return launch<float>(in, out, B, n_steps, stream);
}
int engine_step_f64(const void* in, void* out, int B, int n_steps, void* stream) {
  return launch<double>(in, out, B, n_steps, stream);
}
int engine_in_rows() { return N_IN_ROWS; }
int engine_out_rows() { return N_OUT_ROWS; }
}
