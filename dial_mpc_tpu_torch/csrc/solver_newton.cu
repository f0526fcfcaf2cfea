// The whole Newton constraint solve of one sample per thread, on dense inputs.
//
// Replaces the JAX package's standalone Pallas solver kernel,
// dial_mpc_tpu/physics/solver_pallas.py::_build::batched (kernel
// ::_make_kernel, body ::newton_solve -> ::newton_solve_rows and
// ::_chol_solve_lanes). For each sample it solves
//   min_x 0.5 (x - qs)' M (x - qs) + sum_i s_i(J_i x - aref_i)
// with unilateral rows, friction-loss (Huber) rows and elliptic cone groups,
// on a static schedule of SC_ITERATIONS Newton steps with SC_LS_ITERATIONS
// exact line-search updates each, and writes x and qfrc = J' force.
//
// Layout: every array has the sample axis last (contiguous), so thread t of a
// warp reads entry (r, i) of its own sample next to thread t+1's: one packed
// input (N_IN_ROWS, B) with rows J (nefc*nv), M (nv*nv), D, aref, fl, eta
// (nefc each), qs (nv), and one packed output (2 nv, B) with rows x, qfrc.
// J and M are read in place from global memory every time the solve needs an
// entry (they stay in L1/L2: one warp's working set is N_IN_ROWS * 128 bytes);
// the per-row vectors, the Hessian and its factor live in the thread's local
// memory.
//
// What bounds it: about N_IN_ROWS + 2 nv values of traffic per sample (994 +
// 36 for the Go2 flat scene) against some 10^4..10^5 dependent floating-point
// operations per sample (dense Hessian assembly and Cholesky per Newton step).
// At one sample per thread 2049 samples are 65 warps for 132 SMs, so the time
// is one thread's dependent chain, not memory and not throughput. This first
// design does nothing about that beyond spreading the warps over the SMs (32
// threads a block). The ragged edge is masked, so a batch of one goes through
// the same launch.
//
// "solver_constants.h" is generated by solver_cuda.render_constants_header
// from the kernel's key: sizes, schedule, tolerance, impratio and the
// elliptic groups' rows.

#include <cuda_runtime.h>

#include "newton_solve.cuh"
#include "solver_constants.h"

namespace sc {
constexpr int NV = SC_NV, NEFC = SC_NEFC, NGROUPS = SC_NGROUPS;
constexpr int NGROUPS1 = NGROUPS > 0 ? NGROUPS : 1;
// input rows, in the order the wrapper packs them
constexpr int I_J = 0;
constexpr int I_M = I_J + NEFC * NV;
constexpr int I_D = I_M + NV * NV;
constexpr int I_AREF = I_D + NEFC;
constexpr int I_FL = I_AREF + NEFC;
constexpr int I_ETA = I_FL + NEFC;
constexpr int I_QS = I_ETA + NEFC;
constexpr int N_IN_ROWS = I_QS + NV;
constexpr int N_OUT_ROWS = 2 * NV;
}  // namespace sc

// first row and dimension of each elliptic group; row_simple[r] is 0 for the
// rows that belong to a group
__constant__ int g_group_row0[sc::NGROUPS1] = SCI_group_row0;
__constant__ int g_group_dim[sc::NGROUPS1] = SCI_group_dim;
__constant__ unsigned char g_row_simple[sc::NEFC] = SCI_row_simple;

struct SolverPolicy {
  static constexpr int NV = sc::NV, NEFC = sc::NEFC;
  static constexpr int ITERATIONS = SC_ITERATIONS, LS_ITERATIONS = SC_LS_ITERATIONS;
  static constexpr int NGROUPS = sc::NGROUPS;
  static constexpr bool FRICTION_ROWS = true;
  static __device__ __forceinline__ bool j_sup(int, int) { return true; }
  static __device__ __forceinline__ bool m_mask(int, int) { return true; }
  static __device__ __forceinline__ bool h_mask(int, int) { return true; }
  static __device__ __forceinline__ int group_row0(int g) { return g_group_row0[g]; }
  static __device__ __forceinline__ int group_dim(int g) { return g_group_dim[g]; }
  static __device__ __forceinline__ bool row_simple(int r) { return g_row_simple[r] != 0; }
  template <typename T>
  static __device__ __forceinline__ T impratio() { return T(SC_IMPRATIO); }
  template <typename T>
  static __device__ __forceinline__ void solve_hessian(const T (*H)[NV], const T* g, T* x,
                                                       T (*L)[NV]) {
    chol_solve<T, NV, true>(H, nullptr, nullptr, g, x, L);
  }
};

// in: (N_IN_ROWS, B); out: (N_OUT_ROWS, B)
template <typename T>
__global__ void solver_newton_kernel(const T* __restrict__ in, T* __restrict__ out, int B) {
  using namespace sc;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= B) return;
  const T* base = in + tid;
  const LaneMat<T> J = {base + (size_t)I_J * B, NV, (size_t)B};
  const LaneMat<T> M = {base + (size_t)I_M * B, NV, (size_t)B};
  T D[NEFC], aref[NEFC], fl[NEFC], eta[NEFC], x[NV], qfrc[NV];
  ROW_LOOP
  for (int r = 0; r < NEFC; ++r) {
    D[r] = base[(size_t)(I_D + r) * B];
    aref[r] = base[(size_t)(I_AREF + r) * B];
    fl[r] = base[(size_t)(I_FL + r) * B];
    eta[r] = base[(size_t)(I_ETA + r) * B];
  }
  for (int i = 0; i < NV; ++i) x[i] = base[(size_t)(I_QS + i) * B];
  T H[NV][NV], L[NV][NV];
  const RowData<T> rows = {D, aref, fl, eta};
  newton_solve<SolverPolicy, T>(J, rows, M, x, H, L, T(SC_TOLERANCE), qfrc);
  T* o = out + tid;
  for (int i = 0; i < NV; ++i) {
    o[(size_t)i * B] = x[i];
    o[(size_t)(NV + i) * B] = qfrc[i];
  }
}

constexpr int THREADS_PER_BLOCK = 32;

template <typename T>
static int launch(const void* in, void* out, int B, void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (B + THREADS_PER_BLOCK - 1) / THREADS_PER_BLOCK;
  solver_newton_kernel<T><<<blocks, THREADS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      (const T*)in, (T*)out, B);
  return (int)cudaGetLastError();
}

extern "C" {
int solver_newton_f32(const void* in, void* out, int B, void* stream) {
  return launch<float>(in, out, B, stream);
}
int solver_newton_f64(const void* in, void* out, int B, void* stream) {
  return launch<double>(in, out, B, stream);
}
int solver_in_rows() { return sc::N_IN_ROWS; }
int solver_out_rows() { return sc::N_OUT_ROWS; }
}
