// The Newton constraint solve of one sample, evaluated by one thread.
//
// Shared by the two kernels that solve
//   min_x 0.5 (x - qs)' M (x - qs) + sum_i s_i(J_i x - aref_i):
// the step kernel (engine_step.cu: static sparsity from the model's tree and
// pair table, unilateral rows only, J and M in the thread's local arrays) and
// the standalone solver kernel (solver_newton.cu: dense, all row kinds, J and
// M read in place from global memory). It is the counterpart of
// dial_mpc_tpu/physics/solver_pallas.py::newton_solve_rows and
// ::_chol_solve_lanes.
//
// What differs between the two is a policy type P and two accessors:
//   P::NV, P::NEFC, P::ITERATIONS, P::LS_ITERATIONS   sizes and the static schedule
//   P::j_sup(r, i)    row r of J can be non-zero at dof i
//   P::m_mask(i, j)   M can be non-zero at (i, j)
//   P::h_mask(i, j)   the Hessian can be non-zero at (i, j)
//   P::solve_hessian<T>(H, g, x, L)   chol_solve with the Hessian's patterns
//   P::FRICTION_ROWS  rows with frictionloss > 0 get the Huber penalty
//   P::NGROUPS, P::group_row0(g), P::group_dim(g), P::row_simple(r),
//   P::impratio<T>()  elliptic cone groups (only read when NGROUPS > 0)
//   J(r, i), M(i, j)  read one entry of the Jacobian / the mass matrix
// A dense policy answers every pattern question with true.
#pragma once

#include "lane_math.cuh"

// Loops over constraint rows stay loops. Fully unrolled, nvcc 12.9 keeps the
// per-row arrays (D, aref, jar) in registers and then drops the first
// joint-limit row from the solve: jar[0] comes out NaN on the card, while the
// same source compiled for the host is right. `unroll 1` avoids that and
// also halves the register spills.
#define ROW_LOOP _Pragma("unroll 1")

// a matrix in the thread's local memory, row-major with N columns
template <typename T, int N>
struct LocalMat {
  const T (*a)[N];
  __device__ __forceinline__ T operator()(int r, int i) const { return a[r][i]; }
};

// a matrix of a sample-minor array: entry (r, i) of this thread's sample is
// `stride` elements after entry (r, i) - 1, so a warp's loads coalesce
template <typename T>
struct LaneMat {
  const T* p;  // entry (0, 0) of this thread's sample
  int ncol;
  size_t stride;  // the batch size
  __device__ __forceinline__ T operator()(int r, int i) const {
    return p[(size_t)(r * ncol + i) * stride];
  }
};

// One entry of a pattern table (constant memory); a dense pattern has no
// table and every entry is set. The tables are passed as plain pointers:
// wrapped in a functor that the non-inlined chol_solve took by value, the
// step kernel ran 17 % slower (nvcc 12.9, H100).
template <bool DENSE, int N>
__device__ __forceinline__ bool pattern_at(const unsigned char (*table)[N], int i, int j) {
  if constexpr (DENSE) return true;
  else return table[i][j] != 0;
}

// per-row quantities of one sample; fl and eta may be null where the policy
// has neither friction-loss rows nor elliptic groups
template <typename T>
struct RowData {
  const T* D;
  const T* aref;
  const T* fl;
  const T* eta;
};

// ---------------------------------------------------------------------------
// Masked Cholesky solve H x = g, children first.
//
// The factorisation runs on P H P^T with P the reversal of the dof order, so
// that a tree-structured pattern factorises without fill-in; `pat` is the
// pattern of the factor in that order (fill included), `mask` the pattern of
// H itself in dof order. Entries outside the patterns are never read. With
// DENSE both patterns are full and the tables are not read (pass nullptr).
// Pivots are clamped at 1e-12.
// ---------------------------------------------------------------------------

template <typename T, int N, bool DENSE>
__device__ __noinline__ void chol_solve(const T (*H)[N], const unsigned char (*mask_table)[N],
                                        const unsigned char (*pat_table)[N], const T* g, T* x,
                                        T (*L)[N]) {
  for (int j = 0; j < N; ++j) {
    const int pj = N - 1 - j;
    T s = H[pj][pj];
    for (int k = 0; k < j; ++k)
      if (pattern_at<DENSE, N>(pat_table, j, k)) s = s - L[j][k] * L[j][k];
    T d = sqrt(tmax(s, T(1e-12)));
    L[j][j] = d;
    T inv = T(1) / d;
    for (int i = j + 1; i < N; ++i) {
      if (!pattern_at<DENSE, N>(pat_table, i, j)) continue;
      const int pi = N - 1 - i;
      s = pattern_at<DENSE, N>(mask_table, pi, pj) ? H[pi][pj] : T(0);
      for (int k = 0; k < j; ++k)
        if (pattern_at<DENSE, N>(pat_table, i, k) && pattern_at<DENSE, N>(pat_table, j, k))
          s = s - L[i][k] * L[j][k];
      L[i][j] = s * inv;
    }
  }
  T y[N];
  for (int i = 0; i < N; ++i) {
    T s = g[N - 1 - i];
    for (int k = 0; k < i; ++k)
      if (pattern_at<DENSE, N>(pat_table, i, k)) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  for (int i = N - 1; i >= 0; --i) {
    T s = y[i];
    for (int k = i + 1; k < N; ++k)  // y[k] already holds the solution for k > i
      if (pattern_at<DENSE, N>(pat_table, k, i)) s = s - L[k][i] * y[k];
    y[i] = s / L[i][i];
  }
  for (int i = 0; i < N; ++i) x[N - 1 - i] = y[i];
}

// ---------------------------------------------------------------------------
// penalty terms
// ---------------------------------------------------------------------------

// cost of one unilateral or friction-loss row
template <typename P, typename T>
__device__ __forceinline__ T simple_row_cost(const RowData<T>& rw, const T* jar, int r) {
  const T D = rw.D[r], j = jar[r];
  if constexpr (P::FRICTION_ROWS) {
    const T fl = rw.fl[r];
    if (fl > T(0)) {
      T quad = T(0.5) * D * j * j;
      T lin = fl * fabs(j) - T(0.5) * fl * fl / tmax(D, T(1e-30));
      return fabs(D * j) <= fl ? quad : lin;
    }
  }
  return j < T(0) ? T(0.5) * D * j * j : T(0);
}

// One elliptic cone group (rows row0 .. row0+dim-1: normal, then friction
// rows with eta > 0). With u_i = eta_i jar_i, U = |u|, N = jar_normal:
//   top    (N >= U):                       force 0, cost 0
//   bottom (N <= -(impratio / mu^2) U):    force -D_i jar_i, cost 0.5 sum D_i jar_i^2
//   middle:  f_n = k (U - N), f_i = -k (U - N) eta_i u_i / U, cost 0.5 k (U - N)^2
// with k = 1 / (R_n + mu^2 R_t). Returns the cost; with force != nullptr it
// also writes the group's forces and diagonal Hessian weights, the
// middle-zone weight *k_mid (0 outside the middle zone) and direction gv =
// grad(U - N) of the rank-1 Gauss-Newton term.
template <typename P, typename T>
__device__ __forceinline__ T group_terms(const RowData<T>& rw, const T* jar, int gi, T* force,
                                         T* quad_w, T* k_mid, T* gv) {
  const int row0 = P::group_row0(gi), dim = P::group_dim(gi);
  const T* jr = jar + row0;
  const T* Dg = rw.D + row0;
  const T* et = rw.eta + row0;
  const T mu = et[1], N = jr[0];
  T usq = T(0), cb = Dg[0] * jr[0] * jr[0];
  for (int kk = 1; kk < dim; ++kk) {
    T u = et[kk] * jr[kk];
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
  if (force != nullptr) {
    for (int kk = 0; kk < dim; ++kk) {
      T u = et[kk] * jr[kk];
      T f_mid = kk == 0 ? fn_mid : -fn_mid * et[kk] * u / U;
      T f_bot = -Dg[kk] * jr[kk];
      force[row0 + kk] = top ? T(0) : (bottom ? f_bot : f_mid);
      quad_w[row0 + kk] = bottom ? Dg[kk] : T(0);
      gv[kk] = kk == 0 ? T(-1) : et[kk] * u / U;
    }
    *k_mid = (top || bottom) ? T(0) : k;
  }
  const T cost_m = T(0.5) * k * (U - N) * (U - N);
  return top ? T(0) : (bottom ? T(0.5) * cb : cost_m);
}

template <typename T, int NG>
struct MidTerms {
  T k[NG > 0 ? NG : 1];
  T g[NG > 0 ? NG : 1][6];
};

// penalty terms at jar: force and diagonal Hessian weight per row and the
// groups' middle-zone terms; returns the cost
template <typename P, typename T>
__device__ __forceinline__ T penalty_terms(const RowData<T>& rw, const T* jar, T* force,
                                           T* quad_w, MidTerms<T, P::NGROUPS>& mids) {
  T cost = T(0);
  ROW_LOOP
  for (int r = 0; r < P::NEFC; ++r) {
    if constexpr (P::NGROUPS > 0)
      if (!P::row_simple(r)) continue;
    const T D = rw.D[r];
    bool neg = jar[r] < T(0);
    T f = neg ? -D * jar[r] : T(0);
    T w = neg ? D : T(0);
    if constexpr (P::FRICTION_ROWS) {
      const T fl = rw.fl[r];
      if (fl > T(0)) {
        T f_quad = -D * jar[r];
        f = tclip(f_quad, -fl, fl);
        w = fabs(f_quad) <= fl ? D : T(0);
      }
    }
    force[r] = f;
    quad_w[r] = w;
    cost = cost + simple_row_cost<P, T>(rw, jar, r);
  }
  if constexpr (P::NGROUPS > 0) {
    ROW_LOOP
    for (int gi = 0; gi < P::NGROUPS; ++gi)
      cost = cost + group_terms<P, T>(rw, jar, gi, force, quad_w, &mids.k[gi], mids.g[gi]);
  }
  return cost;
}

template <typename P, typename T>
__device__ __forceinline__ T penalty_cost(const RowData<T>& rw, const T* jar) {
  T cost = T(0);
  ROW_LOOP
  for (int r = 0; r < P::NEFC; ++r) {
    if constexpr (P::NGROUPS > 0)
      if (!P::row_simple(r)) continue;
    cost = cost + simple_row_cost<P, T>(rw, jar, r);
  }
  if constexpr (P::NGROUPS > 0) {
    ROW_LOOP
    for (int gi = 0; gi < P::NGROUPS; ++gi)
      cost = cost + group_terms<P, T>(rw, jar, gi, (T*)nullptr, (T*)nullptr, (T*)nullptr,
                                      (T*)nullptr);
  }
  return cost;
}

// ---------------------------------------------------------------------------
// products with J
// ---------------------------------------------------------------------------

template <int N, typename T>
__device__ __forceinline__ T dof_dot(const T* a, const T* b) {
  T s = a[0] * b[0];
  for (int i = 1; i < N; ++i) s = s + a[i] * b[i];
  return s;
}

// out[r] = sum over the row's support of J(r, i) * v[i]
template <typename P, typename T, typename JA>
__device__ __forceinline__ void jac_apply(const JA& J, const T* v, T* out) {
  ROW_LOOP
  for (int r = 0; r < P::NEFC; ++r) {
    T acc = T(0);
    for (int i = 0; i < P::NV; ++i)
      if (P::j_sup(r, i)) acc = acc + J(r, i) * v[i];
    out[r] = acc;
  }
}

// out[i] = sum over rows of J(r, i) * w[r]
template <typename P, typename T, typename JA>
__device__ __forceinline__ void jac_t_apply(const JA& J, const T* w, T* out) {
  for (int i = 0; i < P::NV; ++i) out[i] = T(0);
  ROW_LOOP
  for (int r = 0; r < P::NEFC; ++r)
    for (int i = 0; i < P::NV; ++i)
      if (P::j_sup(r, i)) out[i] = out[i] + J(r, i) * w[r];
}

// ---------------------------------------------------------------------------
// The solve: P::ITERATIONS Newton steps, each with an exact line search of
// P::LS_ITERATIONS updates, frozen per sample once a step stops improving.
// x enters as qacc_smooth and leaves as qacc; with qfrc != nullptr the
// constraint force J' f at the solution is written there. H and L are
// scratch.
// ---------------------------------------------------------------------------

template <typename P, typename T, typename JA, typename MA>
__device__ __forceinline__ void newton_solve(const JA& J, const RowData<T>& rw, const MA& M,
                                             T* x, T (*H)[P::NV], T (*L)[P::NV], T tolerance,
                                             T* qfrc) {
  constexpr int NV = P::NV, NEFC = P::NEFC, NEFC1 = NEFC > 0 ? NEFC : 1;
  T dx[NV], Mdx[NV], jar[NEFC1], force[NEFC1], quad_w[NEFC1];
  T grad[NV], p[NV], Mp[NV], jv[NEFC1], jar_a[NEFC1];
  MidTerms<T, P::NGROUPS> mids;
  for (int i = 0; i < NV; ++i) { dx[i] = T(0); Mdx[i] = T(0); }
  jac_apply<P>(J, x, jar);
  ROW_LOOP
  for (int r = 0; r < NEFC; ++r) jar[r] = jar[r] - rw.aref[r];
  bool done = false;

  for (int it = 0; it < P::ITERATIONS; ++it) {
    T cost_pen = penalty_terms<P, T>(rw, jar, force, quad_w, mids);
    T prev_cost = T(0.5) * dof_dot<NV>(dx, Mdx) + cost_pen;
    jac_t_apply<P>(J, force, grad);
    for (int i = 0; i < NV; ++i) grad[i] = -(Mdx[i] - grad[i]);  // holds -gradient

    // lower-triangle Hessian H = M + J^T diag(w) J on the static pattern
    for (int i = 0; i < NV; ++i)
      for (int j = 0; j <= i; ++j)
        if (P::h_mask(i, j)) H[i][j] = P::m_mask(i, j) ? M(i, j) : T(0);
    ROW_LOOP
    for (int r = 0; r < NEFC; ++r)
      for (int i = 0; i < NV; ++i) {
        if (!P::j_sup(r, i)) continue;
        T wi = quad_w[r] * J(r, i);
        for (int j = 0; j <= i; ++j)
          if (P::j_sup(r, j)) H[i][j] = H[i][j] + wi * J(r, j);
      }
    if constexpr (P::NGROUPS > 0) {
      // middle-zone rank-1 terms k v v', v = J_group' g; Mp is free here
      T* v = Mp;
      ROW_LOOP
      for (int gi = 0; gi < P::NGROUPS; ++gi) {
        const int row0 = P::group_row0(gi), dim = P::group_dim(gi);
        for (int i = 0; i < NV; ++i) {
          T acc = T(0);
          for (int kk = 0; kk < dim; ++kk)
            if (P::j_sup(row0 + kk, i)) acc = acc + J(row0 + kk, i) * mids.g[gi][kk];
          v[i] = acc;
        }
        for (int i = 0; i < NV; ++i)
          for (int j = 0; j <= i; ++j)
            if (P::h_mask(i, j)) H[i][j] = H[i][j] + mids.k[gi] * v[i] * v[j];
      }
    }
    for (int i = 0; i < NV; ++i)
      for (int j = 0; j < i; ++j)
        if (P::h_mask(i, j)) H[j][i] = H[i][j];

    P::template solve_hessian<T>(H, grad, p, L);
    jac_apply<P>(J, p, jv);
    for (int i = 0; i < NV; ++i) {
      T acc = T(0);
      for (int j = 0; j < NV; ++j)
        if (P::m_mask(i, j)) acc = acc + M(i, j) * p[j];
      Mp[i] = acc;
    }
    T pMp = dof_dot<NV>(p, Mp);
    T pMx = dof_dot<NV>(p, Mdx);

    // exact Newton line search on alpha; force and quad_w are free here
    T alpha = T(0);
    for (int ls = 0; ls < (P::LS_ITERATIONS > 1 ? P::LS_ITERATIONS : 1); ++ls) {
      ROW_LOOP
      for (int r = 0; r < NEFC; ++r) jar_a[r] = jar[r] + alpha * jv[r];
      penalty_terms<P, T>(rw, jar_a, force, quad_w, mids);
      T dphi = pMx + alpha * pMp;
      T jvf = T(0), curv = T(0);
      ROW_LOOP
      for (int r = 0; r < NEFC; ++r) {
        jvf = jvf + jv[r] * force[r];
        curv = curv + quad_w[r] * jv[r] * jv[r];
      }
      dphi = dphi - jvf;
      T ddphi = pMp + curv;
      if constexpr (P::NGROUPS > 0) {
        ROW_LOOP
        for (int gi = 0; gi < P::NGROUPS; ++gi) {
          const int row0 = P::group_row0(gi), dim = P::group_dim(gi);
          T gjv = T(0);
          for (int kk = 0; kk < dim; ++kk) gjv = gjv + mids.g[gi][kk] * jv[row0 + kk];
          ddphi = ddphi + mids.k[gi] * gjv * gjv;
        }
      }
      alpha = alpha - dphi / tmax(ddphi, T(1e-30));
    }

    ROW_LOOP
    for (int r = 0; r < NEFC; ++r) jar_a[r] = jar[r] + alpha * jv[r];
    T cost_new_pen = penalty_cost<P, T>(rw, jar_a);
    T new_quad = T(0);
    for (int i = 0; i < NV; ++i) {
      T a = dx[i] + alpha * p[i], b = Mdx[i] + alpha * Mp[i];
      new_quad = i == 0 ? a * b : new_quad + a * b;
    }
    T new_cost = T(0.5) * new_quad + cost_new_pen;

    bool improved = (prev_cost - new_cost) > tolerance * tmax(prev_cost, T(1));
    bool take = !done && new_cost < prev_cost;
    if (take) {
      for (int i = 0; i < NV; ++i) {
        x[i] = x[i] + alpha * p[i];
        dx[i] = dx[i] + alpha * p[i];
        Mdx[i] = Mdx[i] + alpha * Mp[i];
      }
      ROW_LOOP
      for (int r = 0; r < NEFC; ++r) jar[r] = jar_a[r];
    }
    done = done || !improved;
  }

  if (qfrc != nullptr) {
    penalty_terms<P, T>(rw, jar, force, quad_w, mids);
    jac_t_apply<P>(J, force, qfrc);
  }
}
