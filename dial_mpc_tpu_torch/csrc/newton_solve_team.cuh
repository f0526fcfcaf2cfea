// The Newton constraint solve of one sample, evaluated by a team of lanes.
//
// The cooperative counterpart of newton_solve.cuh (one thread a sample), and
// like it the counterpart of dial_mpc_tpu/physics/solver_pallas.py
// ::newton_solve_rows and ::_chol_solve_lanes. It solves
//   min_x 0.5 (x - qs)' M (x - qs) + sum_i s_i(J_i x - aref_i)
// for unilateral rows on a static schedule (P::ITERATIONS Newton steps of
// P::LS_ITERATIONS exact line-search updates each, frozen once a step stops
// improving).
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
//   P::jrow_adr(), P::jrow_col()   the dofs each row of J can reach
//   P::jcol_adr(), P::jcol_row()   the rows that can reach each dof
//   P::mrow_adr(), P::mrow_col()   M's symmetric rows
//   P::hfac()                      the Hessian's factor schedule (FactorSchedule)
//   P::hrow_adr(), P::hrow()       rows reaching both dofs of each factor entry
// Lists are index arrays in global memory, read through the read-only path; a
// list xs with offsets xs_adr holds item k at xs[xs_adr[k] .. xs_adr[k+1]).
#pragma once

#include "lane_math.cuh"

// lanes a sample: a warp, or a power-of-two part of one
#ifndef LANES
#define LANES 32
#endif
static_assert(LANES == 32 || LANES == 16 || LANES == 8, "LANES must be 8, 16 or 32");

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
// elimination order (fill entries zero) and b the right-hand side in that
// order; on exit y holds the solution in that order. A and b are destroyed;
// L receives the factor; w is scratch. Column c is one phase: every lane
// reads the pivot, the lanes share the entries below it (scaled into L, and
// the forward sweep's update of b) and the trailing updates of the columns
// right of it, each of which reads column c of A and scales it itself. The
// backward sweep is one phase a row. One team sync per phase. Pivots are
// clamped at 1e-12. The caller syncs between filling A, b and this call.
//
// A phase's time is its chain of dependent loads, so a lane first loads the
// indices of all its items (S::MAXCOL, S::MAXUPD, S::MAXBACK bound how many),
// then all their operands, while the pivot's square root and divisions run
// beside; only then does it compute and store. A lane without an item of its
// own points at the pivot, which no lane writes in the phase.
// ---------------------------------------------------------------------------

template <typename T, int N, typename S>
__device__ __forceinline__ void chol_solve_team(const Team& tm, const S& s, T (*A)[N], T (*L)[N],
                                                T* b, T* w, T* y) {
  constexpr int CP = (S::MAXCOL + LANES - 1) / LANES, UP = (S::MAXUPD + LANES - 1) / LANES;
  constexpr int BP = (S::MAXBACK + LANES - 1) / LANES;
  int e0 = ro(s.col_adr[0]), u0 = ro(s.upd_adr[0]);
  for (int c = 0; c < N; ++c) {
    const int e1 = ro(s.col_adr[c + 1]), u1 = ro(s.upd_adr[c + 1]);
    int rows[CP > 0 ? CP : 1], rk[UP > 0 ? UP : 1];
#pragma unroll
    for (int p = 0; p < CP; ++p) {
      const int e = e0 + tm.lane + p * LANES;
      const int v = ro(s.col[e < S::NCOL_ALL ? e : S::NCOL_ALL - 1]);
      rows[p] = e < e1 ? v : c;
    }
#pragma unroll
    for (int p = 0; p < UP; ++p) {
      const int u = u0 + tm.lane + p * LANES;
      const int v = ro(s.upd[u < S::NUPD_ALL ? u : S::NUPD_ALL - 1]);
      rk[p] = u < u1 ? v : (c << 8) | c;
    }
    const T acc = A[c][c], bc = b[c];
    T a_rc[CP > 0 ? CP : 1], b_r[CP > 0 ? CP : 1], a1[UP > 0 ? UP : 1], a2[UP > 0 ? UP : 1],
        at[UP > 0 ? UP : 1];
#pragma unroll
    for (int p = 0; p < CP; ++p) {
      a_rc[p] = A[rows[p]][c];
      b_r[p] = b[rows[p]];
    }
#pragma unroll
    for (int p = 0; p < UP; ++p) {
      const int r = rk[p] >> 8, k = rk[p] & 255;
      a1[p] = A[r][c];
      a2[p] = A[k][c];
      at[p] = A[r][k];
    }
    const T d = sqrt(tmax(acc, T(1e-12)));
    const T inv = T(1) / d;
    const T yc = bc / d;
#pragma unroll
    for (int p = 0; p < CP; ++p)
      if (rows[p] != c) {
        const T l = a_rc[p] * inv;
        L[rows[p]][c] = l;
        b[rows[p]] = b_r[p] - l * yc;
      }
#pragma unroll
    for (int p = 0; p < UP; ++p)
      if (rk[p] != ((c << 8) | c)) A[rk[p] >> 8][rk[p] & 255] = at[p] - (a1[p] * inv) * (a2[p] * inv);
    if (tm.lane == 0) {
      L[c][c] = d;
      w[c] = yc;
    }
    e0 = e1;
    u0 = u1;
    tm.sync();
  }
  int f1 = ro(s.back_adr[N]);
  for (int k = N - 1; k >= 0; --k) {
    const int f0 = ro(s.back_adr[k]);
    int cols[BP > 0 ? BP : 1];
#pragma unroll
    for (int p = 0; p < BP; ++p) {
      const int e = f0 + tm.lane + p * LANES;
      const int v = ro(s.back[e < S::NBACK_ALL ? e : S::NBACK_ALL - 1]);
      cols[p] = e < f1 ? v : k;
    }
    const T wk = w[k], lkk = L[k][k];
    T w_c[BP > 0 ? BP : 1], l_kc[BP > 0 ? BP : 1];
#pragma unroll
    for (int p = 0; p < BP; ++p) {
      w_c[p] = w[cols[p]];
      l_kc[p] = L[k][cols[p]];
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
// The solve.
//
// Shared inputs: J (NEFC x NV, entries outside the rows' supports never
// read), D, aref, M (NV x NV, entries outside its mask never read), x (enters
// as qacc_smooth, leaves as qacc). Shared scratch: A, L (NV x NV), b, w, y
// (NV), force, quad_w (NEFC). Ends with a team sync.
// ---------------------------------------------------------------------------

template <typename P, typename T>
__device__ __forceinline__ void newton_solve_team(const Team& tm, const T (*J)[P::NV], const T* D,
                                                  const T* aref, const T (*M)[P::NV], T* x_sh,
                                                  T (*A)[P::NV], T (*L)[P::NV], T* b, T* w, T* y,
                                                  T* force, T* quad_w, T tolerance) {
  constexpr int NV = P::NV, NEFC = P::NEFC;
  constexpr int DPL = (NV + LANES - 1) / LANES, RPL = (NEFC + LANES - 1) / LANES;
  const short* jrow_adr = P::jrow_adr();
  const short* jrow_col = P::jrow_col();
  const short* jcol_adr = P::jcol_adr();
  const short* jcol_row = P::jcol_row();
  const short* mrow_adr = P::mrow_adr();
  const short* mrow_col = P::mrow_col();
  const short* hrow_adr = P::hrow_adr();
  const short* hrow = P::hrow();
  const auto& hf = P::hfac();
  constexpr int NHENT = sizeof(hf.ent) / sizeof(hf.ent[0]);

  // what this lane owns: dofs lane + k LANES, rows lane + k LANES
  T x[DPL], dx[DPL], Mdx[DPL], p[DPL], Mp[DPL];
  T jar[RPL], jv[RPL], jar_a[RPL], Dr[RPL];
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
      const int e1 = ro(jrow_adr[r + 1]);
      for (int e = ro(jrow_adr[r]); e < e1; ++e) {
        const int i = ro(jrow_col[e]);
        acc = acc + J[r][i] * x_sh[i];
      }
      acc = acc - aref[r];
      d = D[r];
    }
    jar[k] = acc;
    Dr[k] = d;
    jv[k] = T(0);
    jar_a[k] = T(0);
  }
  bool done = false;

  for (int it = 0; it < P::ITERATIONS; ++it) {
    // penalty terms at jar, and the cost before the step
    T pen = T(0), quad = T(0);
#pragma unroll
    for (int k = 0; k < RPL; ++k) {
      const int r = tm.lane + k * LANES;
      if (r < NEFC) {
        const bool neg = jar[k] < T(0);
        force[r] = neg ? -Dr[k] * jar[k] : T(0);
        quad_w[r] = neg ? Dr[k] : T(0);
        pen = pen + (neg ? T(0.5) * Dr[k] * jar[k] * jar[k] : T(0));
      }
    }
#pragma unroll
    for (int k = 0; k < DPL; ++k) quad = quad + dx[k] * Mdx[k];
    const T prev_cost = T(0.5) * tm.sum(quad) + tm.sum(pen);
    tm.sync();

    // -gradient into b and the Hessian M + J' diag(quad_w) J into A, both in
    // elimination order
#pragma unroll
    for (int k = 0; k < DPL; ++k) {
      const int i = tm.lane + k * LANES;
      if (i < NV) {
        T g = T(0);
        const int e1 = ro(jcol_adr[i + 1]);
        for (int e = ro(jcol_adr[i]); e < e1; ++e) {
          const int r = ro(jcol_row[e]);
          g = g + J[r][i] * force[r];
        }
        b[NV - 1 - i] = -(Mdx[k] - g);
      }
    }
    for (int e = tm.lane; e < NHENT; e += LANES) {
      const int rc = ro(hf.ent[e]), r = rc >> 8, c = rc & 255;
      const int i = NV - 1 - c, j = NV - 1 - r;  // dofs, i >= j
      T h = ro(hf.ent_inm[e]) ? M[i][j] : T(0);
      const int q1 = ro(hrow_adr[e + 1]);
      for (int q = ro(hrow_adr[e]); q < q1; ++q) {
        const int row = ro(hrow[q]);
        h = h + (quad_w[row] * J[row][i]) * J[row][j];
      }
      A[r][c] = h;
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
        const int e1 = ro(mrow_adr[i + 1]);
        for (int e = ro(mrow_adr[i]); e < e1; ++e) {
          const int j = ro(mrow_col[e]);
          acc = acc + M[i][j] * y[NV - 1 - j];
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
          acc = acc + J[r][i] * y[NV - 1 - i];
        }
      }
      jv[k] = acc;
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
        const bool neg = ja < T(0);
        const T f = neg ? -Dr[k] * ja : T(0);
        const T wq = neg ? Dr[k] : T(0);
        jvf = jvf + jv[k] * f;
        curv = curv + wq * jv[k] * jv[k];
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
      pen_new = pen_new + (jar_a[k] < T(0) ? T(0.5) * Dr[k] * jar_a[k] * jar_a[k] : T(0));
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
    }
    done = done || !improved;
    tm.sync();  // y was read above; the next iteration writes force, b, A
  }

  if constexpr (P::ITERATIONS == 0) tm.sync();  // x_sh was read above
#pragma unroll
  for (int k = 0; k < DPL; ++k) {
    const int i = tm.lane + k * LANES;
    if (i < NV) x_sh[i] = x[k];
  }
  tm.sync();
}
