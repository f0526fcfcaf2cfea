// One whole physics step per sample, a team of lanes per sample.
//
// Replaces the JAX package's Pallas step kernel,
// dial_mpc_tpu/physics/engine_pallas.py::_build_step_kernel and
// ::_build_multistep_kernel, together with the Newton solve it calls in
// kernel, dial_mpc_tpu/physics/solver_pallas.py::newton_solve_rows and
// ::_chol_solve_lanes (here newton_solve_team.cuh).
//
// Stages, per sample: kinematics -> geom/site frames -> CoM and spatial
// inertias -> com velocities -> RNE bias -> CRB mass matrix -> passive and
// actuation -> collision over the static pair table -> constraint rows ->
// sparse Newton solve with exact line search -> (with eulerdamp) the implicit
// damping solve (M + h diag(damping)) qacc = qfrc_smooth + J' force on M's
// factor schedule -> Euler integration with the quaternion update ->
// maximal-coordinate views taken at the pre-step kinematics. With n_steps > 1
// the (qpos, qvel) carry stays in shared memory and only the last substep
// writes outputs.
//
// What bounds it: traffic is NQ+NV+NU values in and N_OUT_ROWS values out
// per sample and launch (49 + 300 for the Go2 flat scene, about 2.9 MB at
// 2049 samples in float32), against some 3e4 floating-point operations per
// sample, almost all of them in chains that depend on each other: the time is
// the latency of one sample's chain, not bytes and not the card's rate.
// The design shortens the chain and overlaps many of them:
// - a team of LANES lanes (a warp by default, newton_solve_team.cuh) works on
//   one sample, up to four teams a block (fewer where a team's working set
//   leaves room for fewer on an SM: the crate scenes in float64), so 2049
//   samples are 2049 warps, one wave on 132 SMs at the Go2 key in float32;
// - every stage is split over the team's lanes, one lane for each value it
//   owns: bodies of one tree level (the legs together), dofs, the masked
//   entries of M and of the Hessian, contact-dof pairs, constraint rows, the
//   entries of a Cholesky column; each value is summed by its lane in a fixed
//   order, so the results do not depend on timing;
// - the sample's working set (M, H, L, J, the inertias, the frames, the solve's
//   vectors) lives in dynamic shared memory, StepShared<T>, with what dies
//   early aliased by what comes later;
// - the model's tables are read from global memory (model_consts.cuh).
// The boundary is sample-major: a sample's inputs and outputs are one
// contiguous row, which its team reads and writes together.
//
// Scope: free, hinge and slide joints; the plane-{sphere,capsule,box},
// sphere-{sphere,capsule,box}, capsule-{capsule,box} and box-box pairs (the
// reference's approximate manifolds, physics/collision.py) at condim 3 or 6;
// pyramidal or elliptic cones (an elliptic slot is one group of the solve);
// joint limits and friction-loss dofs; Euler with or without eulerdamp. The
// Python wrapper refuses any other model before it builds this file. What a
// model lacks is compiled out (PAIR_KINDS, HAS_SLIDE, NFRIC, CON_TABLE,
// NCON6, NGROUPS, EULERDAMP): a scene of condim-3 pyramids without box pairs,
// slide joints, friction-loss dofs or eulerdamp carries none of their code.

#include <cuda_runtime.h>

#include "lane_math.cuh"
#include "model_consts.cuh"
#include "newton_solve_team.cuh"

using namespace mc;

#define MJ_MINVAL 1e-15

// ---------------------------------------------------------------------------
// soft-constraint impedance and reference acceleration
// ---------------------------------------------------------------------------

// the soft constraint's impedance at pos; only the branch of the power law
// that applies is evaluated (its pow calls dominate a row's chain)
template <typename T>
__device__ __forceinline__ T impedance(const T* solimp, T pos) {
  const T d0 = solimp[0], dmax = solimp[1], width = solimp[2], mid = solimp[3],
          power = solimp[4];
  const T x = fabs(pos) / tmax(width, T(MJ_MINVAL));
  if (x > T(1)) return dmax;
  T y;
  if (x < mid)
    y = pow(x, power) / tmax(pow(mid, power - T(1)), T(MJ_MINVAL));
  else
    y = T(1) - pow(T(1) - x, power) / tmax(pow(T(1) - mid, power - T(1)), T(MJ_MINVAL));
  return tclip(d0 + y * (dmax - d0), T(1e-4), T(0.9999));
}

// the reference acceleration -b*vel - k*imp*pos of a row of impedance imp
template <typename T>
__device__ __forceinline__ T ref_acc(const T* solref, const T* solimp, T timestep, T imp, T pos,
                                     T vel) {
  T dmax = solimp[1];
  T timeconst = tmax(solref[0], T(2) * timestep);
  T dampratio = solref[1];
  T b = T(2) / tmax(dmax * timeconst, T(MJ_MINVAL));
  T k = T(1) / tmax(dmax * dmax * timeconst * timeconst * dampratio * dampratio, T(MJ_MINVAL));
  if (solref[0] <= T(0)) k = -solref[0] / tmax(dmax * dmax, T(MJ_MINVAL));
  if (solref[1] <= T(0)) b = -solref[1] / tmax(dmax, T(MJ_MINVAL));
  return -b * vel - k * imp * pos;
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

// plane-capsule frame: t1 the capsule axis projected onto the plane of n,
// make_frame(n) where the axis is about parallel to n (collision.axis_frame)
template <typename T>
__device__ __forceinline__ void axis_frame(T* frame, const T* n, const T* axis) {
  T t1[3], tmp[3];
  v3_scale(tmp, n, v3_dot(axis, n));
  v3_sub(t1, axis, tmp);
  const T norm = sqrt(v3_dot(t1, t1));
  if (norm > T(1e-10)) {
    const T d = tmax(norm, T(1e-15));
    v3_copy(frame, n);
    v3_set(frame + 3, t1[0] / d, t1[1] / d, t1[2] / d);
    v3_cross(frame + 6, n, frame + 3);
  } else {
    make_frame(frame, n);
  }
}

// ---------------------------------------------------------------------------
// narrowphase: the pair functions of physics/collision.py, one lane a pair
// ---------------------------------------------------------------------------

enum PairKind {
  PK_PLANE_SPHERE = 0, PK_PLANE_CAPSULE = 1, PK_PLANE_BOX = 2,
  PK_SPHERE_BOX = 3, PK_CAPSULE_BOX = 4, PK_BOX_BOX = 5,
  PK_SPHERE_SPHERE = 6, PK_SPHERE_CAPSULE = 7, PK_CAPSULE_CAPSULE = 8
};
// whether the model has a pair of kind k; the others are compiled out
__device__ __forceinline__ constexpr bool has_pair_kind(int k) { return (PAIR_KINDS >> k) & 1; }

// the distance of the sphere (c, r) to the plane (pp, pn), and the contact
// point halfway through the overlap
template <typename T>
__device__ __forceinline__ T plane_sphere(const T* pp, const T* pn, const T* c, T r, T* pos) {
  T rel[3], tmp[3];
  v3_sub(rel, c, pp);
  const T dist = v3_dot(pn, rel) - r;
  v3_scale(tmp, pn, r + T(0.5) * dist);
  v3_sub(pos, c, tmp);
  return dist;
}

// the distance of the spheres (c1, r1) and (c2, r2), the contact point halfway
// through the overlap and the normal n from 1 to 2
template <typename T>
__device__ __forceinline__ T sphere_sphere(const T* c1, T r1, const T* c2, T r2, T* pos, T* n) {
  T dvec[3], tmp[3];
  v3_sub(dvec, c2, c1);
  const T dc = sqrt(v3_dot(dvec, dvec));
  const T dd = tmax(dc, T(1e-15));
#pragma unroll
  for (int i = 0; i < 3; ++i) n[i] = dvec[i] / dd;
  const T dist = dc - (r1 + r2);
  v3_scale(tmp, n, r1 + T(0.5) * dist);
  v3_add(pos, c1, tmp);
  return dist;
}

// corner k of a box (x fastest: bit 0 of k is the sign of x, bit 1 of y, bit 2 of z)
template <typename T>
__device__ __forceinline__ void box_corner(T* out, const T* c, const T* mat, const T* size, int k) {
  const T l[3] = {(k & 1) ? size[0] : -size[0], (k & 2) ? size[1] : -size[1],
                  (k & 4) ? size[2] : -size[2]};
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = c[i] + (l[0] * mat[3 * i] + l[1] * mat[3 * i + 1] + l[2] * mat[3 * i + 2]);
}

// The sphere (c1, r1) against a box (centre bc, row-major frame bR, half
// sizes sz): the signed distance, the contact point and the normal n from the
// sphere into the box. A centre inside the box goes to the face of the least
// gap (the first of equal gaps), and the normal turns.
template <typename T>
__device__ __forceinline__ T sphere_box(const T* c1, T r1, const T* bc, const T* bR, const T* sz,
                                        T* pos, T* n) {
  T rel[3], pl[3], cp[3];
  v3_sub(rel, c1, bc);
#pragma unroll
  for (int i = 0; i < 3; ++i) pl[i] = bR[i] * rel[0] + bR[3 + i] * rel[1] + bR[6 + i] * rel[2];
  const bool inside = fabs(pl[0]) < sz[0] && fabs(pl[1]) < sz[1] && fabs(pl[2]) < sz[2];
  if (inside) {
    const T g0 = sz[0] - fabs(pl[0]), g1 = sz[1] - fabs(pl[1]), g2 = sz[2] - fabs(pl[2]);
    const int ax = (g0 <= g1 && g0 <= g2) ? 0 : (g1 <= g2 ? 1 : 2);
    v3_copy(cp, pl);
    cp[ax] = pl[ax] < T(0) ? -sz[ax] : sz[ax];
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i) cp[i] = tclip(pl[i], -sz[i], sz[i]);
  }
  T dvec[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    dvec[i] = bc[i] + (bR[3 * i] * cp[0] + bR[3 * i + 1] * cp[1] + bR[3 * i + 2] * cp[2]) - c1[i];
  const T dc = sqrt(v3_dot(dvec, dvec));
  const T dd = tmax(dc, T(1e-15));
#pragma unroll
  for (int i = 0; i < 3; ++i) n[i] = inside ? -(dvec[i] / dd) : dvec[i] / dd;
  const T dist = inside ? -(dc + r1) : dc - r1;
  T tmp[3];
  v3_scale(tmp, n, r1 + T(0.5) * dist);
  v3_add(pos, c1, tmp);
  return dist;
}

// the index of the least of d[0 .. N) not yet in taken, the lower index
// first among equals (the order of a stable sort); marks it taken
template <int N, typename T>
__device__ __forceinline__ int take_least(const T* d, unsigned& taken) {
  int best = -1;
  T bd = T(0);
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (!((taken >> k) & 1u) && (best < 0 || d[k] < bd)) {
      best = k;
      bd = d[k];
    }
  taken |= 1u << best;
  return best;
}

// The contacts of pair pr into slots conadr ... (dist, point, frame rows).
template <typename T>
__device__ __forceinline__ void collide_pair(const ModelReal<T>& R, const ModelTopo& tp, int pr,
                                             const T (*xpos)[3], const T (*xquat)[4], T* con_dist,
                                             T (*con_pos)[3], T (*con_frame)[9]) {
  const int g1 = tp.pair_g1[pr], g2 = tp.pair_g2[pr], slot = tp.pair_conadr[pr];
  const int kind = tp.pair_kind[pr];
  const int b1 = tp.cgeom_bodyid[g1], b2 = tp.cgeom_bodyid[g2];
  T p1[3], p2[3], R1[9], R2[9], tmp[3], gq[4];
  quat_rot(tmp, R.cgeom_pos[g1], xquat[b1]);
  v3_add(p1, xpos[b1], tmp);
  quat_mul(gq, xquat[b1], R.cgeom_quat[g1]);
  quat_to_mat(R1, gq);
  quat_rot(tmp, R.cgeom_pos[g2], xquat[b2]);
  v3_add(p2, xpos[b2], tmp);
  quat_mul(gq, xquat[b2], R.cgeom_quat[g2]);
  quat_to_mat(R2, gq);
  const T* s1 = R.cgeom_size[g1];
  const T* s2 = R.cgeom_size[g2];
  T pn[3], axis[3];
  mat_col(pn, R1, 2);  // a plane's normal, or the first capsule's axis
  mat_col(axis, R2, 2);
  if (has_pair_kind(PK_PLANE_SPHERE) && kind == PK_PLANE_SPHERE) {
    con_dist[slot] = plane_sphere(p1, pn, p2, s2[0], con_pos[slot]);
    make_frame(con_frame[slot], pn);
  } else if (has_pair_kind(PK_PLANE_CAPSULE) && kind == PK_PLANE_CAPSULE) {
    T fr[9];
    axis_frame(fr, pn, axis);
#pragma unroll
    for (int e = 0; e < 2; ++e) {  // the end spheres, +axis first
      T ep[3];
      v3_scale(tmp, axis, s2[1]);
      if (e == 0) { v3_add(ep, p2, tmp); } else { v3_sub(ep, p2, tmp); }
      con_dist[slot + e] = plane_sphere(p1, pn, ep, s2[0], con_pos[slot + e]);
      for (int x = 0; x < 9; ++x) con_frame[slot + e][x] = fr[x];
    }
  } else if (has_pair_kind(PK_PLANE_BOX) && kind == PK_PLANE_BOX) {
    // the four deepest of the eight corners
    T d[8], cn[3];
    const T off = v3_dot(pn, p1);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      box_corner(cn, p2, R2, s2, k);
      d[k] = v3_dot(cn, pn) - off;
    }
    unsigned taken = 0;
    T fr[9];
    make_frame(fr, pn);
    for (int e = 0; e < 4; ++e) {
      const int k = take_least<8>(d, taken);
      T dk = T(0);
#pragma unroll
      for (int q = 0; q < 8; ++q) dk = q == k ? d[q] : dk;
      box_corner(cn, p2, R2, s2, k);
      v3_scale(tmp, pn, T(0.5) * dk);
      v3_sub(con_pos[slot + e], cn, tmp);
      con_dist[slot + e] = dk;
      for (int x = 0; x < 9; ++x) con_frame[slot + e][x] = fr[x];
    }
  } else if (has_pair_kind(PK_SPHERE_BOX) && kind == PK_SPHERE_BOX) {
    T n[3];
    con_dist[slot] = sphere_box(p1, s1[0], p2, R2, s2, con_pos[slot], n);
    make_frame(con_frame[slot], n);
  } else if (has_pair_kind(PK_CAPSULE_BOX) && kind == PK_CAPSULE_BOX) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {  // the capsule's end spheres, +axis first
      T ep[3], n[3];
      v3_scale(tmp, pn, s1[1]);
      if (e == 0) { v3_add(ep, p1, tmp); } else { v3_sub(ep, p1, tmp); }
      con_dist[slot + e] = sphere_box(ep, s1[0], p2, R2, s2, con_pos[slot + e], n);
      make_frame(con_frame[slot + e], n);
    }
  } else if (has_pair_kind(PK_SPHERE_SPHERE) && kind == PK_SPHERE_SPHERE) {
    T n[3];
    con_dist[slot] = sphere_sphere(p1, s1[0], p2, s2[0], con_pos[slot], n);
    make_frame(con_frame[slot], n);
  } else if (has_pair_kind(PK_SPHERE_CAPSULE) && kind == PK_SPHERE_CAPSULE) {
    // the sphere against the closest point of the capsule's segment
    T rel[3], cp[3], n[3];
    v3_sub(rel, p1, p2);
    const T t = tclip(v3_dot(rel, axis), -s2[1], s2[1]);
    v3_scale(tmp, axis, t);
    v3_add(cp, p2, tmp);
    con_dist[slot] = sphere_sphere(p1, s1[0], cp, s2[0], con_pos[slot], n);
    make_frame(con_frame[slot], n);
  } else if (has_pair_kind(PK_CAPSULE_CAPSULE) && kind == PK_CAPSULE_CAPSULE) {
    // closest points of the two segments (axes pn and axis), the clamped
    // solve; parallel axes (denom <= 1e-12) start from s = 0
    T r[3], q1[3], q2[3], n[3];
    v3_sub(r, p1, p2);
    const T bd = v3_dot(pn, axis), dd = v3_dot(pn, r), e = v3_dot(axis, r);
    const T denom = T(1) - bd * bd;
    T sp = denom > T(1e-12) ? (bd * e - dd) / tmax(denom, T(1e-12)) : T(0);
    sp = tclip(sp, -s1[1], s1[1]);
    const T tp2 = tclip(bd * sp + e, -s2[1], s2[1]);
    sp = tclip(bd * tp2 - dd, -s1[1], s1[1]);
    v3_scale(tmp, pn, sp);
    v3_add(q1, p1, tmp);
    v3_scale(tmp, axis, tp2);
    v3_add(q2, p2, tmp);
    con_dist[slot] = sphere_sphere(q1, s1[0], q2, s2[0], con_pos[slot], n);
    make_frame(con_frame[slot], n);
  } else if (has_pair_kind(PK_BOX_BOX) && kind == PK_BOX_BOX) {
    // each box's corners against the other (the first box's first), the
    // deepest 8 of the 16; a candidate is recomputed once it is chosen
    T d[16], cn[3], pos[3], n[3];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (k < 8) {
        box_corner(cn, p1, R1, s1, k);
        d[k] = sphere_box(cn, T(0), p2, R2, s2, pos, n);
      } else {
        box_corner(cn, p2, R2, s2, k - 8);
        d[k] = sphere_box(cn, T(0), p1, R1, s1, pos, n);
      }
    }
    unsigned taken = 0;
    for (int e = 0; e < 8; ++e) {
      const int k = take_least<16>(d, taken);
      const bool flip = k >= 8;
      box_corner(cn, flip ? p2 : p1, flip ? R2 : R1, flip ? s2 : s1, k & 7);
      con_dist[slot + e] =
          sphere_box(cn, T(0), flip ? p1 : p2, flip ? R1 : R2, flip ? s1 : s2, con_pos[slot + e], n);
      T* fr = con_frame[slot + e];
      make_frame(fr, n);
      if (flip)  // the second box's corners: normal and second tangent reversed
        for (int x = 0; x < 3; ++x) {
          fr[x] = -fr[x];
          fr[6 + x] = -fr[6 + x];
        }
    }
  }
}

// ---------------------------------------------------------------------------
// The team Newton solve (newton_solve_team.cuh) on this model's static
// sparsity: unilateral rows, friction-loss rows where the model has
// friction-loss dofs, and an elliptic group a slot where its cones are
// elliptic; lists read from global memory. With eulerdamp the solve also
// returns J' force.
// ---------------------------------------------------------------------------

struct EnginePolicy {
  static constexpr int NV = mc::NV, NEFC = mc::NEFC;
  static constexpr int ITERATIONS = mc::ITERATIONS, LS_ITERATIONS = mc::LS_ITERATIONS;
  static constexpr bool DENSE = false, FRICTION_ROWS = mc::NFRIC > 0;
  static constexpr bool CONSTRAINT_FORCE = mc::EULERDAMP;
  static constexpr int NGROUPS = mc::NGROUPS;
  // first row and dimension of elliptic group g (read at compile-time indices)
  static __host__ __device__ constexpr int group_row0(int g) {
    constexpr int a[] = MCI_group_row0;
    return a[g];
  }
  static __host__ __device__ constexpr int group_dim(int g) {
    constexpr int a[] = MCI_group_dim;
    return a[g];
  }
  template <typename T>
  static __device__ __forceinline__ T impratio() { return model_scalars<T>().impratio; }
  static __device__ __forceinline__ const short* jrow_adr() { return g_lists.jrow_adr; }
  static __device__ __forceinline__ const short* jrow_col() { return g_lists.jrow_col; }
  static __device__ __forceinline__ const short* jcol_adr() { return g_lists.jcol_adr; }
  static __device__ __forceinline__ const short* jcol_row() { return g_lists.jcol_row; }
  static __device__ __forceinline__ const short* mrow_adr() { return g_lists.mrow_adr; }
  static __device__ __forceinline__ const short* mrow_col() { return g_lists.mrow_col; }
  static __device__ __forceinline__ const short* hrow_adr() { return g_lists.hrow_adr; }
  static __device__ __forceinline__ const short* hrow() { return g_lists.hrow; }
  static __device__ __forceinline__ const short* hgrp_adr() { return g_lists.hgrp_adr; }
  static __device__ __forceinline__ const short* hgrp() { return g_lists.hgrp; }
  static __device__ __forceinline__ const auto& hfac() { return g_hfac; }
};

// ---------------------------------------------------------------------------
// The working set of one sample, in shared memory
// ---------------------------------------------------------------------------

template <typename T>
struct StepShared {
  // carried from step to step
  T qp[NQ], qv[NV], ct[NU1];
  // kept until the outputs or the solve
  T xpos[NBODY][3], xquat[NBODY][4], subtree_com[NBODY][3], cvel[NBODY][6];
  T cdof[NV][6];
  T M[NV][NV];  // entries outside the mass matrix's mask are never written or read
  T qfrc[NV], qacc[NV];
  T con_dist[NCON1], con_pos[NCON1][3];
  T J[NEFC1][NV], D[NEFC1], aref[NEFC1];  // J only on each row's support
  union {
    struct {  // the smooth dynamics: dead once M and qfrc are built
      T xanchor[NJNT][3], xaxis[NJNT][3], xipos[NBODY][3];
      T cinert[NBODY][36];  // becomes the composite inertia
      T cdof_dot[NV][6], cacc[NBODY][6], cfrc[NBODY][6];
      T F[NV][6];  // composite inertia times cdof
    } s;
    struct {  // the solves, and the contact frames before the Newton solve
      T A[NV][NV], L[NV][NV], b[NV], w[NV], y[NV];
      T force[NEFC1], quad_w[NEFC1];
      // Jn, Jt1, Jt2 of each slot on its support, then the rotational
      // Jacobians along the frame of each condim-6 slot (block NCON +
      // con_rot[slot]); once the rows are built, the elliptic groups' scratch
      T con_frame[NCON1][9], con_jac[NCON1 + NCON6][3][NV];
    } c;
  };
};
static_assert(list_scratch_size<EnginePolicy>() <= (NCON1 + NCON6) * 3 * NV,
              "the groups' scratch must fit in the contact Jacobians it aliases");

// ---------------------------------------------------------------------------
// one physics step
// ---------------------------------------------------------------------------

// Advances S.qp, S.qv under S.ct; with out != nullptr also writes the step's
// outputs to out[0 .. N_OUT_ROWS). Every phase ends with a team sync where a
// later phase reads what it wrote.
template <typename T>
__device__ __forceinline__ void step_once(const Team tm, StepShared<T>& S, T* out) {
  const ModelReal<T>& R = model_real<T>();
  const ModelScalars<T>& C = model_scalars<T>();
  const ModelTopo& tp = g_topo;
  const TeamTables& tl = g_lists;
  const int lane = tm.lane;
  auto& s = S.s;
  auto& c = S.c;

  // ---- kinematics, one tree level a phase ----
  if (lane == 0) {
    v3_set(S.xpos[0], T(0), T(0), T(0));
    S.xquat[0][0] = T(1); S.xquat[0][1] = T(0); S.xquat[0][2] = T(0); S.xquat[0][3] = T(0);
  }
  for (int lv = 0; lv < NLEVEL; ++lv) {
    const int k1 = ro(tl.level_adr[lv + 1]);
    for (int k = ro(tl.level_adr[lv]) + lane; k < k1; k += LANES) {
      const int b = ro(tl.level_body[k]);
      const int p = tp.body_parentid[b];
      T ppos[3] = {T(0), T(0), T(0)}, pquat[4] = {T(1), T(0), T(0), T(0)};
      if (p != 0) {  // the world's frame is being written in this phase
        v3_copy(ppos, S.xpos[p]);
        for (int i = 0; i < 4; ++i) pquat[i] = S.xquat[p][i];
      }
      T pos[3], quat[4], tmp[3], tq[4];
      quat_rot(tmp, R.body_pos[b], pquat);
      v3_add(pos, ppos, tmp);
      quat_mul(quat, pquat, R.body_quat[b]);
      for (int kj = 0; kj < tp.body_jntnum[b]; ++kj) {
        const int j = tp.body_jntadr[b] + kj;
        const int qadr = tp.jnt_qposadr[j];
        if (tp.jnt_type[j] == JNT_FREE) {
          v3_copy(pos, S.qp + qadr);
          quat_normalize(quat, S.qp + qadr + 3);
          v3_copy(s.xanchor[j], pos);
          v3_copy(s.xaxis[j], R.jnt_axis[j]);
        } else if (HAS_SLIDE && tp.jnt_type[j] == JNT_SLIDE) {
          // the anchor is taken before the translation (mj_kinematics)
          T axis[3];
          quat_rot(axis, R.jnt_axis[j], quat);
          quat_rot(tmp, R.jnt_pos[j], quat);
          v3_add(s.xanchor[j], pos, tmp);
          v3_copy(s.xaxis[j], axis);
          v3_scale(tmp, axis, S.qp[qadr] - R.qpos0[qadr]);
          v3_add(pos, pos, tmp);
        } else {  // hinge
          T anchor[3];
          quat_rot(tmp, R.jnt_pos[j], quat);
          v3_add(anchor, pos, tmp);
          T angle = S.qp[qadr] - R.qpos0[qadr];
          T sn = sin(angle * T(0.5)), cs = cos(angle * T(0.5));
          T qloc[4] = {cs, R.jnt_axis[j][0] * sn, R.jnt_axis[j][1] * sn, R.jnt_axis[j][2] * sn};
          quat_mul(tq, quat, qloc);
          for (int i = 0; i < 4; ++i) quat[i] = tq[i];
          quat_rot(tmp, R.jnt_pos[j], quat);
          v3_sub(pos, anchor, tmp);
          v3_copy(s.xanchor[j], anchor);
          quat_rot(s.xaxis[j], R.jnt_axis[j], quat);
        }
      }
      v3_copy(S.xpos[b], pos);
      quat_normalize(S.xquat[b], quat);
    }
    tm.sync();
  }
  if constexpr (NLEVEL == 0) tm.sync();

  // ---- CoM: mass-weighted positions, summed children into parents ----
  for (int b = lane; b < NBODY; b += LANES) {
    T tmp[3];
    quat_rot(tmp, R.body_ipos[b], S.xquat[b]);
    v3_add(s.xipos[b], S.xpos[b], tmp);
    v3_scale(S.subtree_com[b], s.xipos[b], R.body_mass[b]);
  }
  tm.sync();
  for (int lv = NLEVEL - 2; lv >= -1; --lv) {  // parents of level lv + 1; lv = -1 is the world
    const int k0 = lv < 0 ? 0 : ro(tl.level_adr[lv]), k1 = lv < 0 ? 1 : ro(tl.level_adr[lv + 1]);
    for (int k = k0 + lane; k < k1; k += LANES) {
      const int p = lv < 0 ? 0 : ro(tl.level_body[k]);
      for (int e = ro(tl.child_adr[p + 1]) - 1; e >= ro(tl.child_adr[p]); --e)
        v3_add(S.subtree_com[p], S.subtree_com[p], S.subtree_com[ro(tl.child_body[e])]);
    }
    tm.sync();
  }
  for (int b = lane; b < NBODY; b += LANES)
    v3_scale(S.subtree_com[b], S.subtree_com[b], R.subtree_mass_inv[b]);
  tm.sync();

  // ---- spatial inertias about the tree root's CoM, and dof motion subspaces ----
  for (int b = 1 + lane; b < NBODY; b += LANES) {
    T cc[3], iq[4], Rm[9];
    v3_sub(cc, s.xipos[b], S.subtree_com[tp.body_rootid[b]]);
    quat_mul(iq, S.xquat[b], R.body_iquat[b]);
    quat_to_mat(Rm, iq);
    const T mass = R.body_mass[b];
    const T* I3 = R.body_inertia[b];
    const T cx[3][3] = {{T(0), -cc[2], cc[1]}, {cc[2], T(0), -cc[0]}, {-cc[1], cc[0], T(0)}};
    T* M6 = s.cinert[b];
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
  for (int i = lane; i < NV; i += LANES) {
    const int j = ro(tl.dof_jnt[i]), b = tp.jnt_bodyid[j];
    const T* o = S.subtree_com[tp.body_rootid[b]];
    T* cd = S.cdof[i];
    if (tp.jnt_type[j] == JNT_FREE) {
      const int k = i - tp.jnt_dofadr[j];
      if (k < 3) {
        for (int x = 0; x < 6; ++x) cd[x] = x == 3 + k ? T(1) : T(0);
      } else {
        T Rm[9], rel[3];
        quat_to_mat(Rm, S.xquat[b]);
        v3_sub(rel, o, S.xpos[b]);
        mat_col(cd, Rm, k - 3);
        v3_cross(cd + 3, cd, rel);
      }
    } else if (HAS_SLIDE && tp.jnt_type[j] == JNT_SLIDE) {
      v3_set(cd, T(0), T(0), T(0));
      v3_copy(cd + 3, s.xaxis[j]);
    } else {  // hinge
      T rel[3];
      v3_sub(rel, o, s.xanchor[j]);
      v3_copy(cd, s.xaxis[j]);
      v3_cross(cd + 3, s.xaxis[j], rel);
    }
  }
  tm.sync();

  // ---- com velocities and the RNE forward pass, one tree level a phase ----
  for (int lv = 0; lv < NLEVEL; ++lv) {
    const int k1 = ro(tl.level_adr[lv + 1]);
    for (int k = ro(tl.level_adr[lv]) + lane; k < k1; k += LANES) {
      const int b = ro(tl.level_body[k]);
      const int p = tp.body_parentid[b];
      T v6[6], a6[6];
      for (int x = 0; x < 6; ++x) {
        v6[x] = p == 0 ? T(0) : S.cvel[p][x];
        a6[x] = p == 0 ? (x < 3 ? T(0) : -C.gravity[x - 3]) : s.cacc[p][x];
      }
      for (int kj = 0; kj < tp.body_jntnum[b]; ++kj) {
        const int j = tp.body_jntadr[b] + kj, da = tp.jnt_dofadr[j];
        if (tp.jnt_type[j] == JNT_FREE) {
          // translation dofs accumulate before the rotation dofs' cross products
          for (int i = 0; i < 3; ++i) {
            for (int x = 0; x < 6; ++x) s.cdof_dot[da + i][x] = T(0);
            for (int x = 0; x < 6; ++x) v6[x] = v6[x] + S.cdof[da + i][x] * S.qv[da + i];
          }
          for (int i = 0; i < 3; ++i) motion_cross(s.cdof_dot[da + 3 + i], v6, S.cdof[da + 3 + i]);
          for (int i = 0; i < 3; ++i)
            for (int x = 0; x < 6; ++x) v6[x] = v6[x] + S.cdof[da + 3 + i][x] * S.qv[da + 3 + i];
        } else {
          motion_cross(s.cdof_dot[da], v6, S.cdof[da]);
          for (int x = 0; x < 6; ++x) v6[x] = v6[x] + S.cdof[da][x] * S.qv[da];
        }
      }
      const int da = tp.body_dofadr[b];
      for (int i = 0; i < tp.body_dofnum[b]; ++i)
        for (int x = 0; x < 6; ++x) a6[x] = a6[x] + s.cdof_dot[da + i][x] * S.qv[da + i];
      T h6[6], f6[6], fc[6];
      m6_vec(h6, s.cinert[b], v6);
      m6_vec(f6, s.cinert[b], a6);
      force_cross(fc, v6, h6);
      for (int x = 0; x < 6; ++x) {
        S.cvel[b][x] = v6[x];
        s.cacc[b][x] = a6[x];
        s.cfrc[b][x] = f6[x] + fc[x];
      }
    }
    tm.sync();
  }

  // ---- RNE backward sum and composite inertias: children into parents,
  // deepest parents first (the world takes nothing) ----
  for (int lv = NLEVEL - 2; lv >= 0; --lv) {
    const int k0 = ro(tl.level_adr[lv]), n = (ro(tl.level_adr[lv + 1]) - k0) * 42;
    for (int t = lane; t < n; t += LANES) {
      const int p = ro(tl.level_body[k0 + t / 42]), x = t % 42;
      T* dst = x < 6 ? &s.cfrc[p][x] : &s.cinert[p][x - 6];
      T acc = *dst;
      for (int e = ro(tl.child_adr[p + 1]) - 1; e >= ro(tl.child_adr[p]); --e) {
        const int ch = ro(tl.child_body[e]);
        acc = acc + (x < 6 ? s.cfrc[ch][x] : s.cinert[ch][x - 6]);
      }
      *dst = acc;
    }
    tm.sync();
  }

  // ---- bias, passive and actuation forces, and the CRB products ----
  for (int i = lane; i < NV; i += LANES) {
    const int b = tp.dof_bodyid[i];
    const T bias = v6_dot(S.cdof[i], s.cfrc[b]);
    m6_vec(s.F[i], s.cinert[b], S.cdof[i]);
    T f = -R.dof_damping[i] * S.qv[i] - bias;
    const int e1 = ro(tl.dact_adr[i + 1]);
    for (int e = ro(tl.dact_adr[i]); e < e1; ++e) {
      const int u = ro(tl.dact[e]);
      T cu = S.ct[u];
      if (tp.act_ctrllimited[u]) cu = tclip(cu, R.act_ctrlrange[u][0], R.act_ctrlrange[u][1]);
      T force = R.act_gain[u] * cu;
      if (tp.act_affine[u]) {
        T length = S.qp[tp.act_qposadr[u]] * R.act_gear[u];
        T vel = S.qv[i] * R.act_gear[u];
        force = force + (R.act_bias[u][0] + R.act_bias[u][1] * length + R.act_bias[u][2] * vel);
      }
      if (tp.act_forcelimited[u]) force = tclip(force, R.act_forcerange[u][0], R.act_forcerange[u][1]);
      f = f + force * R.act_gear[u];
    }
    S.qfrc[i] = f;
  }
  tm.sync();

  // ---- CRB mass matrix, one lane a masked lower entry ----
  for (int e = lane; e < MC_N_ment; e += LANES) {
    const int ij = ro(tl.ment[e]), i = ij >> 8, j = ij & 255;
    T val = v6_dot(s.F[i], S.cdof[j]);
    if (i == j) val = val + R.dof_armature[i];
    S.M[i][j] = val;
    S.M[j][i] = val;
  }
  tm.sync();

  // ---- qacc_smooth = M^-1 qfrc ----
  for (int e = lane; e < MC_N_mf_ent; e += LANES) {
    const int rc = ro(g_mfac.ent[e]), r = rc >> 8, cl = rc & 255;
    c.A[r][cl] = ro(g_mfac.ent_inm[e]) ? S.M[NV - 1 - cl][NV - 1 - r] : T(0);
  }
  for (int i = lane; i < NV; i += LANES) c.b[NV - 1 - i] = S.qfrc[i];
  tm.sync();
  chol_solve_team<T, NV>(tm, g_mfac, c.A, c.L, c.b, c.w, c.y);
  for (int i = lane; i < NV; i += LANES) S.qacc[i] = c.y[NV - 1 - i];

  // ---- collision, one lane a pair ----
  for (int pr = lane; pr < NPAIR; pr += LANES)
    collide_pair<T>(R, tp, pr, S.xpos, S.xquat, S.con_dist, S.con_pos, c.con_frame);
  tm.sync();

  // ---- translational Jacobian difference (body 2 minus body 1) along each
  // contact's frame, one lane a contact-dof pair ----
  for (int e = lane; e < MC_N_cpair; e += LANES) {
    const int v = ro(tl.cpair[e]), slot = v >> 10, i = v & 255;
    const bool in1 = (v >> 8) & 1, in2 = (v >> 9) & 1;
    const int b1 = tp.con_body1[slot], b2 = tp.con_body2[slot];
    const T* cd = S.cdof[i];
    T dj[3] = {T(0), T(0), T(0)}, cr[3], jp[3], off[3];
    if (in2) {
      v3_sub(off, S.con_pos[slot], S.subtree_com[tp.body_rootid[b2]]);
      v3_cross(cr, cd, off);
      v3_add(dj, cd + 3, cr);
    }
    if (in1) {
      v3_sub(off, S.con_pos[slot], S.subtree_com[tp.body_rootid[b1]]);
      v3_cross(cr, cd, off);
      v3_add(jp, cd + 3, cr);
      if (in2) { v3_sub(dj, dj, jp); } else { v3_set(dj, -jp[0], -jp[1], -jp[2]); }
    }
    const T* frame = c.con_frame[slot];
    for (int a = 0; a < 3; ++a) c.con_jac[slot][a][i] = v3_dot(dj, frame + 3 * a);
    if constexpr (NCON6 > 0) {
      const int k6 = tp.con_rot[slot];
      if (k6 >= 0) {  // rotational: body 2's minus body 1's angular part
        T dr[3];
        for (int x = 0; x < 3; ++x) dr[x] = (in2 ? cd[x] : T(0)) - (in1 ? cd[x] : T(0));
        for (int a = 0; a < 3; ++a) c.con_jac[NCON + k6][a][i] = v3_dot(dr, frame + 3 * a);
      }
    }
  }
  tm.sync();

  // ---- constraint rows, one lane a row: friction-loss dofs, joint limits,
  // then the contact rows (four pyramid facets a slot, or the crow table) ----
  const T timestep = C.timestep;
  for (int r = lane; r < NEFC; r += LANES) {
    if (r < NFRIC) {
      const int i = tp.fric_dof[r];
      T imp = impedance(R.dof_solimp[i], T(0));
      T ar = ref_acc(R.dof_solref[i], R.dof_solimp[i], timestep, imp, T(0), S.qv[i]);
      T Rr = tmax((T(1) - imp) / imp * R.dof_invweight0[i], T(MJ_MINVAL));
      S.J[r][i] = T(1);
      S.D[r] = T(1) / Rr;
      S.aref[r] = ar;
    } else if (r < NFRIC + NLIMIT) {
      const int j = tp.limit_jnt[r - NFRIC];
      const int dadr = tp.jnt_dofadr[j];
      T q = S.qp[tp.jnt_qposadr[j]];
      T dist_lo = q - R.jnt_range[j][0], dist_hi = R.jnt_range[j][1] - q;
      bool use_lo = dist_lo < dist_hi;
      T dist = use_lo ? dist_lo : dist_hi;
      T sign = use_lo ? T(1) : T(-1);
      T pos = dist - R.jnt_margin[j];
      T active = dist < R.jnt_margin[j] ? T(1) : T(0);
      T imp = impedance(R.jnt_solimp[j], pos);
      T ar = ref_acc(R.jnt_solref[j], R.jnt_solimp[j], timestep, imp, pos, sign * S.qv[dadr]);
      T Rr = tmax((T(1) - imp) / imp * R.dof_invweight0[dadr], T(MJ_MINVAL));
      S.J[r][dadr] = sign * active;
      S.D[r] = active / Rr;
      S.aref[r] = ar * active;
    } else if constexpr (CON_TABLE) {
      // elliptic: the normal row, or friction row dir alone (its aref has no
      // position term, its R is R_n mu^2 / (eta^2 impratio)); pyramidal: the
      // facet n +/- mu_k d_k, d_k a tangent or (condim 6) a rotation
      const int v = tp.crow[r - NFRIC - NLIMIT];
      const int slot = v >> 4, dir = (v >> 1) & 7;
      const int b1 = tp.con_body1[slot], b2 = tp.con_body2[slot];
      const T pos = S.con_dist[slot] - R.con_includemargin[slot];
      const T active = S.con_dist[slot] < R.con_includemargin[slot] ? T(1) : T(0);
      const T imp = impedance(R.con_solimp[slot], pos);
      const T invw_t = R.body_invweight0[b1][0] + R.body_invweight0[b2][0];
      const T* Jn = c.con_jac[slot][0];
      const T* Jd = dir < 3 ? c.con_jac[slot][dir] : c.con_jac[NCON + tp.con_rot[slot]][dir - 3];
      T Rr, cd = T(1), posr = pos;  // the row is Jd (elliptic) or Jn + cd Jd
      if constexpr (ELLIPTIC) {
        const T Rn = tmax((T(1) - imp) / imp * invw_t, T(MJ_MINVAL));
        Rr = Rn;
        if (dir > 0) {
          const T mu = R.con_friction[slot][0], eta = R.con_friction[slot][dir - 1];
          Rr = Rn * mu * mu / tmax(eta * eta * C.impratio, T(MJ_MINVAL));
          posr = T(0);
        }
      } else {
        const T invw_r = R.body_invweight0[b1][1] + R.body_invweight0[b2][1];
        const T mu = R.con_friction[slot][dir - 1];
        const T invw_fac = invw_t + mu * mu * (dir < 3 ? invw_t : invw_r);
        Rr = tmax((T(1) - imp) / imp * invw_fac * T(2) * mu * mu, T(MJ_MINVAL));
        cd = (v & 1) ? -mu : mu;
      }
      T vel = T(0);
      const int e1 = ro(tl.jrow_adr[r + 1]);
      for (int e = ro(tl.jrow_adr[r]); e < e1; ++e) {
        const int i = ro(tl.jrow_col[e]);
        const T ej = ELLIPTIC ? Jd[i] : Jn[i] + cd * Jd[i];
        S.J[r][i] = ej * active;
        vel = vel + ej * S.qv[i];
      }
      T ar = ref_acc(R.con_solref[slot], R.con_solimp[slot], timestep, imp, posr, vel);
      S.D[r] = active / Rr;
      S.aref[r] = ar * active;
    } else {
      const int slot = (r - NFRIC - NLIMIT) >> 2, facet = (r - NFRIC - NLIMIT) & 3;
      const int kdir = facet >> 1;
      const int b1 = tp.con_body1[slot], b2 = tp.con_body2[slot];
      T pos = S.con_dist[slot] - R.con_includemargin[slot];
      T active = S.con_dist[slot] < R.con_includemargin[slot] ? T(1) : T(0);
      T imp = impedance(R.con_solimp[slot], pos);
      const T invw_t = R.body_invweight0[b1][0] + R.body_invweight0[b2][0];
      const T mu = R.con_friction[slot][kdir];
      const T invw_fac = invw_t + mu * mu * invw_t;
      T Rr = tmax((T(1) - imp) / imp * invw_fac * T(2) * mu * mu, T(MJ_MINVAL));
      const T smu = (facet & 1) == 0 ? mu : -mu;
      const T* Jn = c.con_jac[slot][0];
      const T* Jt = c.con_jac[slot][1 + kdir];
      T vel = T(0);
      const int e1 = ro(tl.jrow_adr[r + 1]);
      for (int e = ro(tl.jrow_adr[r]); e < e1; ++e) {
        const int i = ro(tl.jrow_col[e]);
        T ej = Jn[i] + smu * Jt[i];
        S.J[r][i] = ej * active;
        vel = vel + ej * S.qv[i];
      }
      T ar = ref_acc(R.con_solref[slot], R.con_solimp[slot], timestep, imp, pos, vel);
      S.D[r] = active / Rr;
      S.aref[r] = ar * active;
    }
  }
  tm.sync();

  // ---- Newton solve: qacc_smooth -> qacc ----
  if constexpr (NEFC > 0)
    newton_solve_team<EnginePolicy, T>(tm, S.J, S.D, S.aref, S.M, S.qacc, c.A, c.L, c.b, c.w,
                                       c.y, c.force, c.quad_w, C.tolerance, R.efc_frictionloss,
                                       R.efc_eta, &c.con_jac[0][0][0], c.y);

  // ---- outputs that belong to the pre-step state ----
  if (out != nullptr) {
    for (int i = lane; i < NV; i += LANES) out[O_QACC + i] = S.qacc[i];
    for (int st = lane; st < NSITE; st += LANES) {
      const int b = tp.site_bodyid[st];
      T tmp[3], sx[3], sq[4], Rs[9];
      quat_rot(tmp, R.site_pos[st], S.xquat[b]);
      v3_add(sx, S.xpos[b], tmp);
      quat_mul(sq, S.xquat[b], R.site_quat[st]);
      quat_to_mat(Rs, sq);
      for (int i = 0; i < 3; ++i) out[O_SITE_XPOS + 3 * st + i] = sx[i];
      for (int i = 0; i < 9; ++i) out[O_SITE_XMAT + 9 * st + i] = Rs[i];
    }
    if (NSITE == 0 && lane == 0) {
      out[O_SITE_XPOS] = T(0);
      out[O_SITE_XMAT] = T(0);
    }
    for (int b = 1 + lane; b < NBODY; b += LANES) {
      T off[3], cr[3];
      v3_sub(off, S.xpos[b], S.subtree_com[tp.body_rootid[b]]);
      v3_cross(cr, S.cvel[b], off);
      for (int i = 0; i < 3; ++i) {
        out[O_XPOS + 3 * (b - 1) + i] = S.xpos[b][i];
        out[O_XDVEL + 3 * (b - 1) + i] = S.cvel[b][3 + i] + cr[i];
        out[O_XDANG + 3 * (b - 1) + i] = S.cvel[b][i];
      }
      for (int i = 0; i < 4; ++i) out[O_XROT + 4 * (b - 1) + i] = S.xquat[b][i];
    }
    for (int st = lane; st < NCON; st += LANES) {
      out[O_CDIST + st] = S.con_dist[st];
      for (int i = 0; i < 3; ++i) out[O_CPOS + 3 * st + i] = S.con_pos[st][i];
    }
    if (NCON == 0 && lane == 0)
      for (int i = 0; i < 4; ++i) out[O_CDIST + i] = T(0);
  }

  // ---- integrate (semi-implicit Euler) ----
  const T h = timestep;
  if constexpr (EULERDAMP) {
    // (M + h diag(damping)) qacc = qfrc_smooth + J' force (J' force in c.y
    // from the solve), factored on M's schedule; M's own factor is not reused,
    // its diagonal differs
    for (int e = lane; e < MC_N_mf_ent; e += LANES) {
      const int rc = ro(g_mfac.ent[e]), rr = rc >> 8, cl = rc & 255;
      T a = ro(g_mfac.ent_inm[e]) ? S.M[NV - 1 - cl][NV - 1 - rr] : T(0);
      if (rr == cl) a = a + h * R.dof_damping[NV - 1 - rr];
      c.A[rr][cl] = a;
    }
    for (int i = lane; i < NV; i += LANES)
      c.b[NV - 1 - i] = NEFC > 0 ? S.qfrc[i] + c.y[i] : S.qfrc[i];
    tm.sync();
    chol_solve_team<T, NV>(tm, g_mfac, c.A, c.L, c.b, c.w, c.y);
    for (int i = lane; i < NV; i += LANES) S.qv[i] = S.qv[i] + h * c.y[NV - 1 - i];
  } else {
    if constexpr (NEFC == 0) tm.sync();  // qacc was written by other lanes
    for (int i = lane; i < NV; i += LANES) S.qv[i] = S.qv[i] + h * S.qacc[i];
  }
  tm.sync();
  for (int j = lane; j < NJNT; j += LANES) {
    const int qadr = tp.jnt_qposadr[j], dadr = tp.jnt_dofadr[j];
    T* qp = S.qp;
    if (tp.jnt_type[j] == JNT_FREE) {
      for (int i = 0; i < 3; ++i) qp[qadr + i] = qp[qadr + i] + h * S.qv[dadr + i];
      const T* omega = S.qv + dadr + 3;
      T angle = v3_norm(omega) * h;
      T axis[3];
      v3_scale(axis, omega, T(1) / v3_norm(omega));
      T sn = sin(angle * T(0.5)), cs = cos(angle * T(0.5));
      T dq[4] = {cs, axis[0] * sn, axis[1] * sn, axis[2] * sn}, qn[4];
      quat_mul(qn, qp + qadr + 3, dq);
      quat_normalize(qp + qadr + 3, qn);
    } else {
      qp[qadr] = qp[qadr] + h * S.qv[dadr];
    }
  }
  tm.sync();

  if (out != nullptr) {
    for (int i = lane; i < NQ; i += LANES) out[O_QPOS + i] = S.qp[i];
    for (int i = lane; i < NV; i += LANES) out[O_QVEL + i] = S.qv[i];
  }
}

// One sample's launch: in holds its NQ+NV+NU inputs, out receives its
// N_OUT_ROWS outputs (rows of the sample-major (B, rows) arrays).
template <typename T>
__device__ __forceinline__ void engine_step_team(const Team tm, StepShared<T>& S,
                                                 const T* __restrict__ in, T* __restrict__ out,
                                                 int n_steps) {
  for (int k = tm.lane; k < N_IN_ROWS; k += LANES) {
    const T v = in[k];
    if (k < NQ) S.qp[k] = v;
    else if (k < NQ + NV) S.qv[k - NQ] = v;
    else S.ct[k - NQ - NV] = v;
  }
  tm.sync();
  for (int st = 0; st < n_steps; ++st) step_once<T>(tm, S, st == n_steps - 1 ? out : nullptr);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

constexpr int MAX_SAMPLES_PER_BLOCK = 4;
constexpr int THREADS = LANES * MAX_SAMPLES_PER_BLOCK;

// a team's share of the block's dynamic shared memory, 16-byte aligned
template <typename T>
struct TeamBytes { static constexpr int value = (int)((sizeof(StepShared<T>) + 15) / 16 * 16); };

// blocks of four teams an SM should hold by registers: float32 four, float64 two
template <typename T>
struct MinBlocks { static constexpr int value = sizeof(T) == 4 ? 4 : 2; };

// in: (B, N_IN_ROWS) rows qpos, qvel, ctrl; out: (B, N_OUT_ROWS)
template <typename T>
__global__ void __launch_bounds__(THREADS, MinBlocks<T>::value)
    engine_step_kernel(const T* __restrict__ in, T* __restrict__ out, int B, int n_steps,
                       int samples_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int team = threadIdx.x / LANES;
  const int sample = blockIdx.x * samples_per_block + team;
  if (sample >= B) return;  // the whole team leaves together
  const unsigned mask =
      LANES == 32 ? 0xffffffffu : ((1u << LANES) - 1u) << (threadIdx.x % 32 / LANES * LANES);
  StepShared<T>& S = *reinterpret_cast<StepShared<T>*>(smem + team * TeamBytes<T>::value);
  engine_step_team<T>(Team{(int)(threadIdx.x % LANES), mask}, S, in + (size_t)sample * N_IN_ROWS,
                      out + (size_t)sample * N_OUT_ROWS, n_steps);
}

// Samples a block, chosen once per type from the team's shared memory and
// the occupancy it gives: the count of 1, 2 or 4 that keeps the most teams on
// an SM, the largest of equals (a small working set keeps four a block). Minus
// a CUDA error code if a query fails, 0 if one team's working set exceeds
// what a block may have.
struct LaunchShape {
  int samples_per_block, teams_per_sm;
};

template <typename T>
static LaunchShape choose_shape() {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return {-(int)err, 0};
  const int bytes = TeamBytes<T>::value;
  if (bytes > optin) return {0, 0};
  const int most = optin / bytes < MAX_SAMPLES_PER_BLOCK ? optin / bytes : MAX_SAMPLES_PER_BLOCK;
  // more than 48 KB of dynamic shared memory needs the kernel's consent
  err = cudaFuncSetAttribute(engine_step_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             most * bytes);
  if (err != cudaSuccess) return {-(int)err, 0};
  LaunchShape best = {0, 0};
  for (int spb = 1; spb <= most; spb *= 2) {
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, engine_step_kernel<T>,
                                                        spb * LANES, spb * bytes);
    if (err != cudaSuccess) return {-(int)err, 0};
    if (blocks * spb >= best.teams_per_sm) best = {spb, blocks * spb};
  }
  return best;
}

template <typename T>
static const LaunchShape& launch_shape() {
  static const LaunchShape shape = choose_shape<T>();
  return shape;
}

template <typename T>
static int launch(const void* in, void* out, int B, int n_steps, void* stream) {
  if (B <= 0 || n_steps < 1) return (int)cudaErrorInvalidValue;
  const LaunchShape& sh = launch_shape<T>();
  if (sh.samples_per_block < 0) return -sh.samples_per_block;
  if (sh.samples_per_block == 0) return (int)cudaErrorInvalidConfiguration;
  const int spb = sh.samples_per_block;
  const int blocks = (B + spb - 1) / spb;
  engine_step_kernel<T><<<blocks, spb * LANES, spb * TeamBytes<T>::value, (cudaStream_t)stream>>>(
      (const T*)in, (T*)out, B, n_steps, spb);
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
// the packed arrays are (B, rows): one contiguous row a sample
int engine_sample_major() { return 1; }
int engine_lanes() { return LANES; }
int engine_team_bytes_f32() { return TeamBytes<float>::value; }
int engine_team_bytes_f64() { return TeamBytes<double>::value; }
// samples a block and teams an SM of the launch (0: a team does not fit a
// block; negative: minus a CUDA error code)
int engine_samples_per_block_f32() { return launch_shape<float>().samples_per_block; }
int engine_samples_per_block_f64() { return launch_shape<double>().samples_per_block; }
int engine_teams_per_sm_f32() { return launch_shape<float>().teams_per_sm; }
int engine_teams_per_sm_f64() { return launch_shape<double>().teams_per_sm; }
}
