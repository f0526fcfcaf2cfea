// The Newton constraint solve of one sample, evaluated by a team of lanes.
//
// The counterpart of dial_mpc_tpu/physics/solver_pallas.py::newton_solve_rows
// and ::_chol_solve_lanes, used by both kernels: the step kernel
// (engine_step.cu: the model's static sparsity, unilateral rows) and the
// standalone solver kernel (solver_newton.cu: dense rows of every kind). It
// solves
//   min_x 0.5 (x - qs)' M (x - qs) + sum_i s_i(J_i x - aref_i)
// on a static schedule (P::ITERATIONS Newton steps of P::LS_ITERATIONS exact
// line-search updates each, frozen once a step stops improving) with
//   unilateral rows       s = 0.5 D jar^2 where jar < 0, else 0;
//   friction-loss rows    (P::FRICTION_ROWS; rows with fl > 0) the Huber term
//                         0.5 D jar^2 where |D jar| <= fl, else
//                         fl |jar| - 0.5 fl^2 / D;
//   elliptic cone groups  (P::NGROUPS) of 2 to 6 rows, three zones
//                         (group_terms below), each owned whole by one lane;
//                         on lists a group's rows share its first row's
//                         support, and P::hgrp_adr(), P::hgrp() name the
//                         groups whose rank-1 term reaches each factor entry.
//
// A team is LANES lanes of one warp that work on one sample; they sync with
// __syncwarp on the team's mask and reduce with __shfl_xor_sync, never with
// __syncthreads. The sample's matrices and the vectors lanes exchange live in
// shared memory; each lane keeps the rows and dofs it owns (r = lane + k
// LANES) in registers. Every value is summed by one lane in a fixed order, or
// by the fixed butterfly of Team::sum, so the results do not depend on timing.
//
// What the solve needs of the model is a policy type P:
//   P::NV, P::NEFC, P::ITERATIONS, P::LS_ITERATIONS   sizes and schedule
//   P::FRICTION_ROWS, P::NGROUPS   the row kinds beyond unilateral; with
//     groups also P::group_row0(g), P::group_dim(g) (constexpr) and
//     P::impratio<T>()
//   P::CONSTRAINT_FORCE            also return qfrc = J' force at the result
//     (qfrc in dof order, summed over the rows in order)
//   P::DENSE   every row reaches every dof, M and the Hessian are full: rows,
//     dofs and lower entries are compile-time ranges, J, M and L are 2-D
//     arrays, the Hessian lives in the lanes' registers and its factor is
//     dense (dense_chol_solve_team); no index list is read. Otherwise the
//     sparsity comes as lists, and J, M, the Hessian A and its factor L are
//     stored on their patterns alone (model_consts.cuh says where each entry
//     lies); an item that names an entry carries its position:
//   P::jrow_adr(), P::jrow_col()   the dofs each row of J can reach (entry e at J[e])
//   P::jcol_at(), P::jcol_row()    the rows that can reach each dof (row | J position << 8)
//   P::mrow_at(), P::mrow_col()    M's symmetric rows (column | M position << 8)
//   P::hfac()                      the Hessian's factor schedule (FactorSchedule)
//   P::hrow_at(), P::hrow()        rows reaching both dofs of each factor entry
//                                  (row | J positions of both dofs << 8, << 20)
// Lists are index arrays in global memory, read through the read-only path; a
// list xs with offsets xs_adr holds item k at xs[xs_adr[k] .. xs_adr[k+1]).
// The lists a lane walks alone (xs with xs_at) are interleaved, so that the
// lanes of a warp read one line at each step: item k's n entries lie at s,
// s + LIST_STRIDE, ..., where xs_at[k] = s | n << 16.
#pragma once

#include <type_traits>

#include "lane_math.cuh"

// lanes a sample: a warp, or a power-of-two part of one
#ifndef LANES
#define LANES 32
#endif
static_assert(LANES == 32 || LANES == 16 || LANES == 8, "LANES must be 8, 16 or 32");
// the interleaving of the lists a lane walks alone (engine_cuda.LIST_STRIDE)
constexpr int LIST_STRIDE = 32;

struct Team {
  int lane;       // 0 .. LANES - 1
  unsigned mask;  // the team's lanes within its warp
  __device__ __forceinline__ void sync() const { __syncwarp(mask); }
  // The sum over the team's lanes, the same bits on every lane: the butterfly
  // adds the same two partial sums on both lanes of each pair, and lane 0's
  // result is broadcast besides, so no lane can round differently.
  template <typename T>
  __device__ __forceinline__ T sum(T v) const {
#pragma unroll
    for (int o = LANES / 2; o > 0; o >>= 1) v = v + __shfl_xor_sync(mask, v, o, LANES);
    return __shfl_sync(mask, v, 0, LANES);
  }
};

// one entry of a read-only table in global memory
template <typename V>
__device__ __forceinline__ V ro(const V& v) { return __ldg(&v); }

// ---------------------------------------------------------------------------
// Masked Cholesky solve, one column at a time.
//
// On entry A holds the lower entries of the pattern of the matrix in
// elimination order (fill entries zero), stored where the schedule s puts
// them (the diagonal of row k at k, the row's entries left of it at N + their
// place in s.back), and b the right-hand side in that order; on exit y
// holds the solution in that order. A and b are destroyed; L receives the
// factor, stored as A; w is scratch. Column c is one phase: every lane
// reads the pivot, the lanes share the entries below it (scaled into L, and
// the forward sweep's update of b) and the trailing updates of the columns
// right of it, each of which reads column c of A and scales it itself. The
// backward sweep is one phase a row. One team sync per phase. Pivots are
// clamped at 1e-12. The caller syncs between filling A, b and this call.
//
// A phase's time is its chain of dependent loads, so a lane first loads the
// items of all its entries (S::MAXCOL, S::MAXUPD, S::MAXBACK bound how many),
// each of which names the rows and the storage positions it touches, then all
// their operands, while the pivot's square root and divisions run beside;
// only then does it compute and store. A lane without an item of its own
// points at the pivot, which no lane writes in the phase.
// ---------------------------------------------------------------------------

template <typename T, int N, typename S>
__device__ __forceinline__ void chol_solve_team(const Team& tm, const S& s, T* A, T* L, T* b, T* w,
                                                T* y) {
  constexpr int CP = (S::MAXCOL + LANES - 1) / LANES, UP = (S::MAXUPD + LANES - 1) / LANES;
  constexpr int BP = (S::MAXBACK + LANES - 1) / LANES;
  int e0 = ro(s.col_adr[0]), u0 = ro(s.upd_adr[0]);
  for (int c = 0; c < N; ++c) {
    const int e1 = ro(s.col_adr[c + 1]), u1 = ro(s.upd_adr[c + 1]);
    // rows[p] and the position of (rows[p], c); rk[p] those of (r, c), (k, c), (r, k)
    int rows[CP > 0 ? CP : 1], pos[CP > 0 ? CP : 1], rk[UP > 0 ? UP : 1];
    const int pivot3 = c | (c << 10) | (c << 20);
#pragma unroll
    for (int p = 0; p < CP; ++p) {
      const int e = e0 + tm.lane + p * LANES;
      const int v = ro(s.col[e < S::NCOL_ALL ? e : S::NCOL_ALL - 1]);
      rows[p] = e < e1 ? v & 255 : c;
      pos[p] = e < e1 ? v >> 8 : c;
    }
#pragma unroll
    for (int p = 0; p < UP; ++p) {
      const int u = u0 + tm.lane + p * LANES;
      const int v = ro(s.upd[u < S::NUPD_ALL ? u : S::NUPD_ALL - 1]);
      rk[p] = u < u1 ? v : pivot3;
    }
    const T acc = A[c], bc = b[c];
    T a_rc[CP > 0 ? CP : 1], b_r[CP > 0 ? CP : 1], a1[UP > 0 ? UP : 1], a2[UP > 0 ? UP : 1],
        at[UP > 0 ? UP : 1];
#pragma unroll
    for (int p = 0; p < CP; ++p) {
      a_rc[p] = A[pos[p]];
      b_r[p] = b[rows[p]];
    }
#pragma unroll
    for (int p = 0; p < UP; ++p) {
      a1[p] = A[rk[p] & 1023];
      a2[p] = A[(rk[p] >> 10) & 1023];
      at[p] = A[rk[p] >> 20];
    }
    const T d = sqrt(tmax(acc, T(1e-12)));
    const T inv = T(1) / d;
    const T yc = bc / d;
#pragma unroll
    for (int p = 0; p < CP; ++p)
      if (rows[p] != c) {
        const T l = a_rc[p] * inv;
        L[pos[p]] = l;
        b[rows[p]] = b_r[p] - l * yc;
      }
#pragma unroll
    for (int p = 0; p < UP; ++p)
      if (rk[p] != pivot3) A[rk[p] >> 20] = at[p] - (a1[p] * inv) * (a2[p] * inv);
    if (tm.lane == 0) {
      L[c] = d;
      w[c] = yc;
    }
    e0 = e1;
    u0 = u1;
    tm.sync();
  }
  int f1 = ro(s.back_adr[N]);
  for (int k = N - 1; k >= 0; --k) {
    const int f0 = ro(s.back_adr[k]);
    int cols[BP > 0 ? BP : 1], lpos[BP > 0 ? BP : 1];  // columns, and where (k, column) lies
#pragma unroll
    for (int p = 0; p < BP; ++p) {
      const int e = f0 + tm.lane + p * LANES;
      const int v = ro(s.back[e < S::NBACK_ALL ? e : S::NBACK_ALL - 1]);
      cols[p] = e < f1 ? v : k;
      lpos[p] = e < f1 ? N + e : k;
    }
    const T wk = w[k], lkk = L[k];
    T w_c[BP > 0 ? BP : 1], l_kc[BP > 0 ? BP : 1];
#pragma unroll
    for (int p = 0; p < BP; ++p) {
      w_c[p] = w[cols[p]];
      l_kc[p] = L[lpos[p]];
    }
    const T xk = wk / lkk;
#pragma unroll
    for (int p = 0; p < BP; ++p)
      if (cols[p] != k) w[cols[p]] = w_c[p] - l_kc[p] * xk;
    if (tm.lane == 0) y[k] = xk;
    f1 = f0;
    tm.sync();
  }
}

// ---------------------------------------------------------------------------
// Dense Cholesky solve A y = b, one column a phase (the dense policy's).
//
// Each lane holds the lower entries (ei[p], ej[p]) of A it owns in a[p]
// (valid[p] false for the padding of its last pass) and updates them in
// place; column c of A reaches the other lanes through col[c & 1], which the
// owners of column c filled in the phase before (the caller fills column 0
// and syncs). Phase c: every lane takes the pivot, scales its entries of
// column c into L and updates b below the pivot (the forward sweep), updates
// its trailing entries from column c, and writes its entries of column c+1
// into the other buffer. L receives the factor below the diagonal and the
// pivots' inverses on it. The backward sweep runs in registers: each lane
// holds w of its dofs, and x_k comes from lane k % LANES by a shuffle, so it
// needs no sync. On exit y holds the solution; b is destroyed. Pivots are
// clamped at 1e-12. Ends with a team sync.
// ---------------------------------------------------------------------------

template <typename T, int N, int EPL>
__device__ __forceinline__ void dense_chol_solve_team(const Team& tm, const int* ei, const int* ej,
                                                      const bool* valid, T* a, T (*col)[N],
                                                      T (*L)[N], T* b, T* w, T* y) {
  constexpr int DPL = (N + LANES - 1) / LANES;
#pragma unroll 1
  for (int c = 0; c < N; ++c) {
    const T* cc = col[c & 1];
    T* cn = col[(c + 1) & 1];
    T a_i[EPL], a_j[EPL], b_i[EPL];
#pragma unroll
    for (int p = 0; p < EPL; ++p) {
      a_i[p] = cc[ei[p]];
      a_j[p] = cc[ej[p]];
      b_i[p] = valid[p] && ej[p] == c ? b[ei[p]] : T(0);
    }
    const T d = sqrt(tmax(cc[c], T(1e-12)));
    const T inv = T(1) / d;
    const T yc = b[c] * inv;
#pragma unroll
    for (int p = 0; p < EPL; ++p)
      if (valid[p]) {
        const int i = ei[p], j = ej[p];
        if (j == c) {
          if (i > c) {
            const T l = a[p] * inv;
            L[i][c] = l;
            b[i] = b_i[p] - l * yc;
          }
        } else if (j > c) {
          a[p] = a[p] - (a_i[p] * inv) * (a_j[p] * inv);
          if (j == c + 1) cn[i] = a[p];
        }
      }
    if (tm.lane == 0) {
      L[c][c] = inv;
      w[c] = yc;
    }
    tm.sync();
  }
  T wr[DPL], xr[DPL];
#pragma unroll
  for (int k = 0; k < DPL; ++k) {
    const int i = tm.lane + k * LANES;
    wr[k] = i < N ? w[i] : T(0);
    xr[k] = T(0);
  }
#pragma unroll
  for (int k = N - 1; k >= 0; --k) {
    const T xk = __shfl_sync(tm.mask, wr[k / LANES], k % LANES, LANES) * L[k][k];
#pragma unroll
    for (int q = 0; q < DPL; ++q) {
      const int c = tm.lane + q * LANES;
      if (c < k) wr[q] = wr[q] - L[k][c] * xk;
      if (c == k) xr[q] = xk;
    }
  }
#pragma unroll
  for (int k = 0; k < DPL; ++k) {
    const int i = tm.lane + k * LANES;
    if (i < N) y[i] = xr[k];
  }
  tm.sync();
}

// ---------------------------------------------------------------------------
// penalty terms
// ---------------------------------------------------------------------------

// force f and diagonal Hessian weight wq of a unilateral row, or with
// P::FRICTION_ROWS and fl > 0 of a friction-loss row, at ja = J_r x - aref_r
template <typename P, typename T>
__device__ __forceinline__ void row_force(T D, T fl, T ja, T& f, T& wq) {
  const bool neg = ja < T(0);
  f = neg ? -D * ja : T(0);
  wq = neg ? D : T(0);
  if constexpr (P::FRICTION_ROWS) {
    if (fl > T(0)) {
      const T f_quad = -D * ja;
      f = tclip(f_quad, -fl, fl);
      wq = fabs(f_quad) <= fl ? D : T(0);
    }
  }
}

// the cost of the same row
template <typename P, typename T>
__device__ __forceinline__ T row_cost(T D, T fl, T ja) {
  if constexpr (P::FRICTION_ROWS) {
    if (fl > T(0)) {
      const T quad = T(0.5) * D * ja * ja;
      const T lin = fl * fabs(ja) - T(0.5) * fl * fl / tmax(D, T(1e-30));
      return fabs(D * ja) <= fl ? quad : lin;
    }
  }
  return ja < T(0) ? T(0.5) * D * ja * ja : T(0);
}

// One elliptic cone group of dim rows (normal, then friction rows with
// eta > 0), entries dim..5 of the arrays zero. With u_i = eta_i jar_i,
// U = |u|, N = jar_normal:
//   top    (N >= U):                       force 0, cost 0
//   bottom (N <= -(impratio / mu^2) U):    force -D_i jar_i, cost 0.5 sum D_i jar_i^2
//   middle:  f_n = k (U - N), f_i = -k (U - N) eta_i u_i / U, cost 0.5 k (U - N)^2
// with k = 1 / (R_n + mu^2 R_t). Writes the forces f, diagonal Hessian
// weights wq, the middle-zone weight k_mid (0 outside the middle zone) and
// the direction g = grad(U - N) of the rank-1 Gauss-Newton term; returns the
// cost.
template <typename P, typename T>
__device__ __forceinline__ T group_terms(int dim, const T* Dg, const T* et, const T* jr, T* f,
                                         T* wq, T& k_mid, T* g) {
  const T mu = et[1], N = jr[0];
  T usq = T(0), cb = Dg[0] * jr[0] * jr[0];
#pragma unroll
  for (int kk = 1; kk < 6; ++kk)
    if (kk < dim) {
      const T u = et[kk] * jr[kk];
      usq = kk == 1 ? u * u : usq + u * u;
      cb = cb + Dg[kk] * jr[kk] * jr[kk];
    }
  const T U = sqrt(usq + T(1e-30));
  // an inactive contact (D = 0) gets a huge regulariser: k becomes ~0
  const T Rn = Dg[0] > T(0) ? T(1) / tmax(Dg[0], T(1e-30)) : T(1e30);
  const T Rt = Dg[1] > T(0) ? T(1) / tmax(Dg[1], T(1e-30)) : T(1e30);
  const T k = T(1) / (Rn + mu * mu * Rt);
  const bool top = N >= U;
  const bool bottom = N <= -(P::template impratio<T>() / tmax(mu * mu, T(1e-12))) * U;
  const T fn_mid = k * (U - N);
#pragma unroll
  for (int kk = 0; kk < 6; ++kk) {
    const T u = et[kk] * jr[kk];
    const T f_mid = kk == 0 ? fn_mid : -fn_mid * et[kk] * u / U;
    f[kk] = top ? T(0) : (bottom ? -Dg[kk] * jr[kk] : f_mid);
    wq[kk] = bottom ? Dg[kk] : T(0);
    g[kk] = kk == 0 ? T(-1) : et[kk] * u / U;
  }
  k_mid = (top || bottom) ? T(0) : k;
  return top ? T(0) : (bottom ? T(0.5) * cb : T(0.5) * k * (U - N) * (U - N));
}

// ---------------------------------------------------------------------------
// The solve.
//
// Shared inputs: J (NEFC x NV, or with lists its entries on the rows'
// supports), M (NV x NV, or with lists its masked lower entries), x (enters as
// qacc_smooth, leaves as qacc). D, aref and, where the policy has them, fl
// and eta may lie in shared or global memory: each lane reads its own rows'
// once. Shared scratch: A (lists only), L (NV x NV), b, w, y (NV), force,
// quad_w (NEFC) and, for a dense policy, ds (dense_scratch_size<P> values:
// two column buffers, the groups' middle-zone terms). With
// P::CONSTRAINT_FORCE, qfrc receives J' force at the result. Ends with a team
// sync.
// ---------------------------------------------------------------------------

template <typename P>
constexpr int dense_scratch_size() {
  return 2 * P::NV + P::NGROUPS * (1 + 6 + P::NV);
}

// the scratch ds of a list policy with elliptic groups: each group's k_mid and
// v = J_g' g (NV, written on the group's support only)
template <typename P>
constexpr int list_scratch_size() {
  return P::NGROUPS * (1 + P::NV);
}

// how a policy's matrices are passed: 2-D arrays (dense), or the values on
// their static patterns (lists)
template <typename P, typename T>
using SolveMat = std::conditional_t<P::DENSE, T (*)[P::NV], T*>;

template <typename P, typename T>
__device__ __forceinline__ void newton_solve_team(const Team& tm, SolveMat<P, const T> J, const T* D,
                                                  const T* aref, SolveMat<P, const T> M, T* x_sh,
                                                  SolveMat<P, T> A, SolveMat<P, T> L, T* b, T* w,
                                                  T* y, T* force, T* quad_w, T tolerance,
                                                  const T* fl = nullptr, const T* eta = nullptr,
                                                  T* ds = nullptr, T* qfrc = nullptr) {
  constexpr int NV = P::NV, NEFC = P::NEFC, NG = P::NGROUPS;
  constexpr int DPL = (NV + LANES - 1) / LANES, RPL = (NEFC + LANES - 1) / LANES;
  // dense: the lower entries of the Hessian this lane owns, and the groups
  constexpr int NTRI = NV * (NV + 1) / 2, EPL = (NTRI + LANES - 1) / LANES;
  constexpr int GPL = NG > 0 ? (NG + LANES - 1) / LANES : 1;
  // dense scratch: col[2][NV], then each group's k_mid, g[6] and v = J_g' g (NV);
  // list scratch: each group's k_mid, then its v
  T(*col)[NV] = reinterpret_cast<T(*)[NV]>(ds);
  T* const gk = NG > 0 ? ds + (P::DENSE ? 2 * NV : 0) : nullptr;
  T* const gg = NG > 0 && P::DENSE ? gk + NG : nullptr;
  T* const gv = NG > 0 ? (P::DENSE ? gg + 6 * NG : gk + NG) : nullptr;

  // what this lane owns: dofs lane + k LANES, rows lane + k LANES
  T x[DPL], dx[DPL], Mdx[DPL], p[DPL], Mp[DPL];
  T jar[RPL], jv[RPL], jar_a[RPL], Dr[RPL], Fl[RPL];
  bool simple[RPL];  // not in an elliptic group
#pragma unroll
  for (int k = 0; k < DPL; ++k) {
    const int i = tm.lane + k * LANES;
    x[k] = i < NV ? x_sh[i] : T(0);
    dx[k] = T(0);
    Mdx[k] = T(0);
    p[k] = T(0);
    Mp[k] = T(0);
  }
#pragma unroll
  for (int k = 0; k < RPL; ++k) {
    const int r = tm.lane + k * LANES;
    T acc = T(0), d = T(0);
    if (r < NEFC) {
      if constexpr (P::DENSE) {
#pragma unroll
        for (int i = 0; i < NV; ++i) acc = acc + J[r][i] * x_sh[i];
      } else {
        const short* jrow_adr = P::jrow_adr();
        const short* jrow_col = P::jrow_col();
        const int e1 = ro(jrow_adr[r + 1]);
        for (int e = ro(jrow_adr[r]); e < e1; ++e) {
          const int i = ro(jrow_col[e]);
          acc = acc + J[e] * x_sh[i];
        }
      }
      acc = acc - aref[r];
      d = D[r];
    }
    jar[k] = acc;
    Dr[k] = d;
    jv[k] = T(0);
    jar_a[k] = T(0);
    Fl[k] = T(0);
    if constexpr (P::FRICTION_ROWS) Fl[k] = r < NEFC ? fl[r] : T(0);
    simple[k] = true;
    if constexpr (NG > 0) {
#pragma unroll
      for (int g = 0; g < NG; ++g)
        if (r >= P::group_row0(g) && r < P::group_row0(g) + P::group_dim(g)) simple[k] = false;
    }
  }

  // elliptic groups: group lane + s LANES is this lane's, all its rows in
  // registers (entries dim..5 zero)
  int grow0[GPL], gdim[GPL];
  T gD[GPL][6], geta[GPL][6], gjar[GPL][6], gjv[GPL][6];
  if constexpr (NG > 0) {
#pragma unroll
    for (int s = 0; s < GPL; ++s) {
      const int gi = tm.lane + s * LANES;
      grow0[s] = 0;
      gdim[s] = 0;
#pragma unroll
      for (int g = 0; g < NG; ++g)
        if (g == gi) {
          grow0[s] = P::group_row0(g);
          gdim[s] = P::group_dim(g);
        }
#pragma unroll
      for (int kk = 0; kk < 6; ++kk) {
        const int r = grow0[s] + kk;
        T acc = T(0);
        if (kk < gdim[s]) {
          if constexpr (P::DENSE) {
#pragma unroll
            for (int i = 0; i < NV; ++i) acc = acc + J[r][i] * x_sh[i];
          } else {
            const short* jrow_adr = P::jrow_adr();
            const short* jrow_col = P::jrow_col();
            const int e1 = ro(jrow_adr[r + 1]);
            for (int e = ro(jrow_adr[r]); e < e1; ++e) {
              const int i = ro(jrow_col[e]);
              acc = acc + J[e] * x_sh[i];
            }
          }
          acc = acc - aref[r];
        }
        gjar[s][kk] = acc;
        gD[s][kk] = kk < gdim[s] ? D[r] : T(0);
        geta[s][kk] = kk < gdim[s] ? eta[r] : T(0);
        gjv[s][kk] = T(0);
      }
    }
  }

  bool done = false;

  for (int it = 0; it < P::ITERATIONS; ++it) {
    // penalty terms at jar, and the cost before the step
    T pen = T(0), quad = T(0);
#pragma unroll
    for (int k = 0; k < RPL; ++k) {
      const int r = tm.lane + k * LANES;
      if (r < NEFC && simple[k]) {
        T f, wq;
        row_force<P>(Dr[k], Fl[k], jar[k], f, wq);
        force[r] = f;
        quad_w[r] = wq;
        pen = pen + row_cost<P>(Dr[k], Fl[k], jar[k]);
      }
    }
    if constexpr (NG > 0) {
#pragma unroll
      for (int s = 0; s < GPL; ++s)
        if (gdim[s] > 0) {
          const int gi = tm.lane + s * LANES;
          T f[6], wq[6], g[6];
          pen = pen + group_terms<P>(gdim[s], gD[s], geta[s], gjar[s], f, wq, gk[gi], g);
#pragma unroll
          for (int kk = 0; kk < 6; ++kk) {
            if (kk < gdim[s]) {
              force[grow0[s] + kk] = f[kk];
              quad_w[grow0[s] + kk] = wq[kk];
            }
            if constexpr (P::DENSE) gg[6 * gi + kk] = g[kk];
          }
          if constexpr (!P::DENSE) {
            // v = J_g' g on the group's support, by the group's lane; the
            // group's rows follow each other, each on that support
            const short* jrow_adr = P::jrow_adr();
            const short* jrow_col = P::jrow_col();
            const int e0 = ro(jrow_adr[grow0[s]]), e1 = ro(jrow_adr[grow0[s] + 1]);
            for (int e = e0; e < e1; ++e) {
              const int i = ro(jrow_col[e]);
              T v = T(0);
#pragma unroll
              for (int kk = 0; kk < 6; ++kk)
                if (kk < gdim[s]) v = v + J[e + kk * (e1 - e0)] * g[kk];
              gv[NV * gi + i] = v;
            }
          }
        }
    }
#pragma unroll
    for (int k = 0; k < DPL; ++k) quad = quad + dx[k] * Mdx[k];
    const T prev_cost = T(0.5) * tm.sum(quad) + tm.sum(pen);
    tm.sync();

    if constexpr (P::DENSE) {
      // this lane's lower entries (ei, ej) of the Hessian, column by column
      int ei[EPL], ej[EPL];
      bool valid[EPL];
      T h[EPL];
#pragma unroll
      for (int q = 0; q < EPL; ++q) {
        int e = tm.lane + q * LANES, j = 0;
        valid[q] = e < NTRI;
        if (!valid[q]) e = 0;
#pragma unroll 1
        while (e >= NV - j) {
          e -= NV - j;
          ++j;
        }
        ei[q] = j + e;
        ej[q] = j;
      }
      // -gradient into b, and each group's v = J_g' g
#pragma unroll
      for (int k = 0; k < DPL; ++k) {
        const int i = tm.lane + k * LANES;
        if (i < NV) {
          T g = T(0);
#pragma unroll 4
          for (int r = 0; r < NEFC; ++r) g = g + J[r][i] * force[r];
          b[i] = -(Mdx[k] - g);
          if constexpr (NG > 0) {
#pragma unroll
            for (int gi = 0; gi < NG; ++gi) {
              T v = T(0);
#pragma unroll
              for (int kk = 0; kk < P::group_dim(gi); ++kk)
                v = v + J[P::group_row0(gi) + kk][i] * gg[6 * gi + kk];
              gv[NV * gi + i] = v;
            }
          }
        }
      }
      if constexpr (NG > 0) tm.sync();
      // the Hessian M + J' diag(quad_w) J + sum_g k_g v_g v_g' into this
      // lane's entries; rows of weight 0 add nothing and are skipped (the
      // weight is the same on every lane)
#pragma unroll
      for (int q = 0; q < EPL; ++q) h[q] = M[ei[q]][ej[q]];
#pragma unroll 2
      for (int r = 0; r < NEFC; ++r) {
        const T wr = quad_w[r];
        if (wr != T(0)) {
#pragma unroll
          for (int q = 0; q < EPL; ++q) h[q] = h[q] + (wr * J[r][ei[q]]) * J[r][ej[q]];
        }
      }
      if constexpr (NG > 0) {
#pragma unroll
        for (int gi = 0; gi < NG; ++gi) {
          const T kg = gk[gi];
#pragma unroll
          for (int q = 0; q < EPL; ++q)
            h[q] = h[q] + kg * gv[NV * gi + ei[q]] * gv[NV * gi + ej[q]];
        }
      }
#pragma unroll
      for (int q = 0; q < EPL; ++q)
        if (valid[q] && ej[q] == 0) col[0][ei[q]] = h[q];
      tm.sync();
      // the Newton direction p, then J p and M p
      dense_chol_solve_team<T, NV, EPL>(tm, ei, ej, valid, h, col, L, b, w, y);
#pragma unroll
      for (int k = 0; k < DPL; ++k) {
        const int i = tm.lane + k * LANES;
        if (i < NV) {
          p[k] = y[i];
          T acc = T(0);
#pragma unroll
          for (int j = 0; j < NV; ++j) acc = acc + M[i][j] * y[j];
          Mp[k] = acc;
        }
      }
#pragma unroll
      for (int k = 0; k < RPL; ++k) {
        const int r = tm.lane + k * LANES;
        T acc = T(0);
        if (r < NEFC) {
#pragma unroll
          for (int i = 0; i < NV; ++i) acc = acc + J[r][i] * y[i];
        }
        jv[k] = acc;
      }
      if constexpr (NG > 0) {
#pragma unroll
        for (int s = 0; s < GPL; ++s)
#pragma unroll
          for (int kk = 0; kk < 6; ++kk) {
            T acc = T(0);
            if (kk < gdim[s]) {
#pragma unroll
              for (int i = 0; i < NV; ++i) acc = acc + J[grow0[s] + kk][i] * y[i];
            }
            gjv[s][kk] = acc;
          }
      }
    } else {
      const short* jrow_adr = P::jrow_adr();
      const short* jrow_col = P::jrow_col();
      const int* jcol_at = P::jcol_at();
      const int* jcol_row = P::jcol_row();
      const int* mrow_at = P::mrow_at();
      const int* mrow_col = P::mrow_col();
      const int* hrow_at = P::hrow_at();
      const unsigned* hrow = P::hrow();
      const auto& hf = P::hfac();
      constexpr int NHENT = sizeof(hf.ent) / sizeof(hf.ent[0]);
      // -gradient into b and the Hessian M + J' diag(quad_w) J into A, both in
      // elimination order
#pragma unroll
      for (int k = 0; k < DPL; ++k) {
        const int i = tm.lane + k * LANES;
        if (i < NV) {
          T g = T(0);
          const int at = ro(jcol_at[i]);
          for (int e = at & 0xffff, e1 = e + LIST_STRIDE * (at >> 16); e < e1; e += LIST_STRIDE) {
            const int v = ro(jcol_row[e]);
            g = g + J[v >> 8] * force[v & 255];
          }
          b[NV - 1 - i] = -(Mdx[k] - g);
        }
      }
      for (int e = tm.lane; e < NHENT; e += LANES) {
        const int v = ro(hf.ent[e]), r = (v >> 8) & 255, c = v & 255, m_at = ro(hf.ent_inm[e]);
        const int i = NV - 1 - c, j = NV - 1 - r;  // dofs, i >= j
        T h = m_at >= 0 ? M[m_at] : T(0);
        const int at = ro(hrow_at[e]);
        for (int q = at & 0xffff, q1 = q + LIST_STRIDE * (at >> 16); q < q1; q += LIST_STRIDE) {
          const unsigned hv = ro(hrow[q]);
          h = h + (quad_w[hv & 255] * J[(hv >> 8) & 4095]) * J[hv >> 20];
        }
        if constexpr (NG > 0) {
          const short* hgrp_adr = P::hgrp_adr();
          const short* hgrp = P::hgrp();
          const int g1 = ro(hgrp_adr[e + 1]);
          for (int q = ro(hgrp_adr[e]); q < g1; ++q) {
            const int g = ro(hgrp[q]);
            h = h + gk[g] * gv[NV * g + i] * gv[NV * g + j];
          }
        }
        A[v >> 16] = h;
      }
      tm.sync();

      // the Newton direction p, then J p and M p
      chol_solve_team<T, NV>(tm, hf, A, L, b, w, y);
#pragma unroll
      for (int k = 0; k < DPL; ++k) {
        const int i = tm.lane + k * LANES;
        if (i < NV) {
          p[k] = y[NV - 1 - i];
          T acc = T(0);
          const int at = ro(mrow_at[i]);
          for (int e = at & 0xffff, e1 = e + LIST_STRIDE * (at >> 16); e < e1; e += LIST_STRIDE) {
            const int v = ro(mrow_col[e]);
            acc = acc + M[v >> 8] * y[NV - 1 - (v & 255)];
          }
          Mp[k] = acc;
        }
      }
#pragma unroll
      for (int k = 0; k < RPL; ++k) {
        const int r = tm.lane + k * LANES;
        T acc = T(0);
        if (r < NEFC) {
          const int e1 = ro(jrow_adr[r + 1]);
          for (int e = ro(jrow_adr[r]); e < e1; ++e) {
            const int i = ro(jrow_col[e]);
            acc = acc + J[e] * y[NV - 1 - i];
          }
        }
        jv[k] = acc;
      }
      if constexpr (NG > 0) {
#pragma unroll
        for (int s = 0; s < GPL; ++s)
#pragma unroll
          for (int kk = 0; kk < 6; ++kk) {
            T acc = T(0);
            if (kk < gdim[s]) {
              const int r = grow0[s] + kk;
              const int e1 = ro(jrow_adr[r + 1]);
              for (int e = ro(jrow_adr[r]); e < e1; ++e) {
                const int i = ro(jrow_col[e]);
                acc = acc + J[e] * y[NV - 1 - i];
              }
            }
            gjv[s][kk] = acc;
          }
      }
    }
    T pmp = T(0), pmx = T(0);
#pragma unroll
    for (int k = 0; k < DPL; ++k) {
      pmp = pmp + p[k] * Mp[k];
      pmx = pmx + p[k] * Mdx[k];
    }
    const T pMp = tm.sum(pmp), pMx = tm.sum(pmx);

    // exact Newton line search on alpha
    T alpha = T(0);
    for (int ls = 0; ls < (P::LS_ITERATIONS > 1 ? P::LS_ITERATIONS : 1); ++ls) {
      T jvf = T(0), curv = T(0);
#pragma unroll
      for (int k = 0; k < RPL; ++k) {
        const T ja = jar[k] + alpha * jv[k];
        T f, wq;
        row_force<P>(Dr[k], Fl[k], ja, f, wq);
        if (simple[k]) {
          jvf = jvf + jv[k] * f;
          curv = curv + wq * jv[k] * jv[k];
        }
      }
      if constexpr (NG > 0) {
#pragma unroll
        for (int s = 0; s < GPL; ++s)
          if (gdim[s] > 0) {
            T ja[6], f[6], wq[6], g[6], km;
#pragma unroll
            for (int kk = 0; kk < 6; ++kk) ja[kk] = gjar[s][kk] + alpha * gjv[s][kk];
            group_terms<P>(gdim[s], gD[s], geta[s], ja, f, wq, km, g);
            T gjv_g = T(0);
#pragma unroll
            for (int kk = 0; kk < 6; ++kk) {
              jvf = jvf + gjv[s][kk] * f[kk];
              curv = curv + wq[kk] * gjv[s][kk] * gjv[s][kk];
              gjv_g = gjv_g + g[kk] * gjv[s][kk];
            }
            curv = curv + km * gjv_g * gjv_g;
          }
      }
      const T dphi = (pMx + alpha * pMp) - tm.sum(jvf);
      const T ddphi = pMp + tm.sum(curv);
      alpha = alpha - dphi / tmax(ddphi, T(1e-30));
    }

    // cost after the step; take it only while it improves
    T pen_new = T(0), quad_new = T(0);
#pragma unroll
    for (int k = 0; k < RPL; ++k) {
      jar_a[k] = jar[k] + alpha * jv[k];
      pen_new = pen_new + (simple[k] ? row_cost<P>(Dr[k], Fl[k], jar_a[k]) : T(0));
    }
    T gjar_a[GPL][6];
    if constexpr (NG > 0) {
#pragma unroll
      for (int s = 0; s < GPL; ++s) {
#pragma unroll
        for (int kk = 0; kk < 6; ++kk) gjar_a[s][kk] = gjar[s][kk] + alpha * gjv[s][kk];
        if (gdim[s] > 0) {
          T f[6], wq[6], g[6], km;
          pen_new = pen_new + group_terms<P>(gdim[s], gD[s], geta[s], gjar_a[s], f, wq, km, g);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < DPL; ++k) quad_new = quad_new + (dx[k] + alpha * p[k]) * (Mdx[k] + alpha * Mp[k]);
    const T new_cost = T(0.5) * tm.sum(quad_new) + tm.sum(pen_new);
    const bool improved = (prev_cost - new_cost) > tolerance * tmax(prev_cost, T(1));
    if (!done && new_cost < prev_cost) {
#pragma unroll
      for (int k = 0; k < DPL; ++k) {
        x[k] = x[k] + alpha * p[k];
        dx[k] = dx[k] + alpha * p[k];
        Mdx[k] = Mdx[k] + alpha * Mp[k];
      }
#pragma unroll
      for (int k = 0; k < RPL; ++k) jar[k] = jar_a[k];
      if constexpr (NG > 0) {
#pragma unroll
        for (int s = 0; s < GPL; ++s)
#pragma unroll
          for (int kk = 0; kk < 6; ++kk) gjar[s][kk] = gjar_a[s][kk];
      }
    }
    done = done || !improved;
    tm.sync();  // y was read above; the next iteration writes force, b, A
  }

  if constexpr (P::CONSTRAINT_FORCE) {
    // qfrc = J' force at the result, summed over rows in order
#pragma unroll
    for (int k = 0; k < RPL; ++k) {
      const int r = tm.lane + k * LANES;
      if (r < NEFC && simple[k]) {
        T f, wq;
        row_force<P>(Dr[k], Fl[k], jar[k], f, wq);
        force[r] = f;
      }
    }
    if constexpr (NG > 0) {
#pragma unroll
      for (int s = 0; s < GPL; ++s)
        if (gdim[s] > 0) {
          T f[6], wq[6], g[6], km;
          group_terms<P>(gdim[s], gD[s], geta[s], gjar[s], f, wq, km, g);
#pragma unroll
          for (int kk = 0; kk < 6; ++kk)
            if (kk < gdim[s]) force[grow0[s] + kk] = f[kk];
        }
    }
    tm.sync();
#pragma unroll
    for (int k = 0; k < DPL; ++k) {
      const int i = tm.lane + k * LANES;
      if (i < NV) {
        T acc = T(0);
        if constexpr (P::DENSE) {
#pragma unroll 4
          for (int r = 0; r < NEFC; ++r) acc = acc + J[r][i] * force[r];
        } else {
          const int* jcol_at = P::jcol_at();
          const int* jcol_row = P::jcol_row();
          const int at = ro(jcol_at[i]);
          for (int e = at & 0xffff, e1 = e + LIST_STRIDE * (at >> 16); e < e1; e += LIST_STRIDE) {
            const int v = ro(jcol_row[e]);
            acc = acc + J[v >> 8] * force[v & 255];
          }
        }
        qfrc[i] = acc;
      }
    }
  }

  if constexpr (P::ITERATIONS == 0) tm.sync();  // x_sh was read above
#pragma unroll
  for (int k = 0; k < DPL; ++k) {
    const int i = tm.lane + k * LANES;
    if (i < NV) x_sh[i] = x[k];
  }
  tm.sync();
}
