// The whole Newton constraint solve of one sample per team of lanes, on dense
// inputs.
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
// What bounds it: about nefc nv + nv^2 + 4 nefc + nv values in and 2 nv out
// per sample (958 + 36 for the Go2 flat scene) against some 4e4 floating-point
// operations, nearly all in chains that depend on each other (the Hessian's
// factor and the backward sweep, the line search's updates): the time is the
// latency of one sample's chain, not bytes and not the card's rate. So the
// design shortens the chain and runs many of them side by side:
// - a team of LANES lanes (a warp by default, newton_solve_team.cuh) works on
//   one sample, so 2049 samples are 2049 warps; the launch puts as many teams
//   in a block as keep the most of them on an SM (solver_samples_per_block);
// - the work is split by what each lane owns: rows (jar, D, aref, fl, eta in
//   registers, forces and weights, the line search's terms), dofs (x, dx,
//   M dx, the direction, the gradient, qfrc), the lower entries of the dense
//   Hessian (in registers through its Cholesky, one column a phase), and the
//   elliptic groups (a group's rows all in its lane's registers);
// - the sample's J and M, the factor and the exchanged vectors live in
//   dynamic shared memory (SolverShared<T>), loaded with lane-contiguous
//   reads;
// - the policy is dense: rows, dofs and entries are compile-time ranges, and
//   no index list is read.
// Each value is summed by one lane in a fixed order, or by Team::sum's fixed
// butterfly, so two launches on the same inputs give the same bits.
//
// The boundary is sample-major: seven separate contiguous inputs J (B, nefc,
// nv), M (B, nv, nv), D, aref, fl, eta (B, nefc), qs (B, nv) and two outputs
// x, qfrc (B, nv), read and written in place. The ragged edge is masked by
// whole teams, so a batch of one goes through the same launch.
//
// "solver_constants.h" is generated by solver_cuda.render_constants_header
// from the kernel's key: sizes, schedule, tolerance, impratio and the
// elliptic groups' rows.

#include <cuda_runtime.h>

#include "newton_solve_team.cuh"
#include "solver_constants.h"

struct SolverPolicy {
  static constexpr int NV = SC_NV, NEFC = SC_NEFC;
  static constexpr int ITERATIONS = SC_ITERATIONS, LS_ITERATIONS = SC_LS_ITERATIONS;
  static constexpr bool DENSE = true, FRICTION_ROWS = true, CONSTRAINT_FORCE = true;
  static constexpr int NGROUPS = SC_NGROUPS;
  // first row and dimension of elliptic group g (read at compile-time indices)
  static __host__ __device__ constexpr int group_row0(int g) {
    constexpr int a[] = SCI_group_row0;
    return a[g];
  }
  static __host__ __device__ constexpr int group_dim(int g) {
    constexpr int a[] = SCI_group_dim;
    return a[g];
  }
  template <typename T>
  static __device__ __forceinline__ T impratio() { return T(SC_IMPRATIO); }
};

namespace sc {
constexpr int NV = SolverPolicy::NV, NEFC = SolverPolicy::NEFC;
}  // namespace sc

// the working set of one sample, in shared memory
template <typename T>
struct SolverShared {
  T J[sc::NEFC][sc::NV], M[sc::NV][sc::NV], L[sc::NV][sc::NV];
  T x[sc::NV], b[sc::NV], w[sc::NV], y[sc::NV];
  T force[sc::NEFC], quad_w[sc::NEFC];
  T ds[dense_scratch_size<SolverPolicy>()];
};

// One sample: its team loads J, M and qs into S, solves, and writes x and
// qfrc. The pointers are the sample's rows of the sample-major arrays.
template <typename T>
__device__ __forceinline__ void solve_sample(const Team tm, SolverShared<T>& S, const T* J,
                                             const T* M, const T* D, const T* aref, const T* fl,
                                             const T* eta, const T* qs, T* x, T* qfrc) {
  using namespace sc;
  T* sJ = &S.J[0][0];
  T* sM = &S.M[0][0];
  for (int k = tm.lane; k < NEFC * NV; k += LANES) sJ[k] = J[k];
  for (int k = tm.lane; k < NV * NV; k += LANES) sM[k] = M[k];
  for (int k = tm.lane; k < NV; k += LANES) S.x[k] = qs[k];
  tm.sync();
  newton_solve_team<SolverPolicy, T>(tm, S.J, D, aref, S.M, S.x, nullptr, S.L, S.b, S.w, S.y,
                                     S.force, S.quad_w, T(SC_TOLERANCE), fl, eta, S.ds, qfrc);
  for (int k = tm.lane; k < NV; k += LANES) x[k] = S.x[k];
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

constexpr int MAX_SAMPLES_PER_BLOCK = 8;

// a team's share of the block's dynamic shared memory, 16-byte aligned
template <typename T>
struct TeamBytes { static constexpr int value = (int)((sizeof(SolverShared<T>) + 15) / 16 * 16); };

template <typename T>
__global__ void __launch_bounds__(LANES * MAX_SAMPLES_PER_BLOCK)
    solver_newton_kernel(const T* __restrict__ J, const T* __restrict__ M,
                         const T* __restrict__ D, const T* __restrict__ aref,
                         const T* __restrict__ fl, const T* __restrict__ eta,
                         const T* __restrict__ qs, T* __restrict__ x, T* __restrict__ qfrc, int B,
                         int samples_per_block) {
  using namespace sc;
  extern __shared__ __align__(16) unsigned char smem[];
  const int team = threadIdx.x / LANES;
  const int sample = blockIdx.x * samples_per_block + team;
  if (sample >= B) return;  // the whole team leaves together
  const unsigned mask =
      LANES == 32 ? 0xffffffffu : ((1u << LANES) - 1u) << (threadIdx.x % 32 / LANES * LANES);
  SolverShared<T>& S = *reinterpret_cast<SolverShared<T>*>(smem + team * TeamBytes<T>::value);
  const size_t s = (size_t)sample;
  solve_sample<T>(Team{(int)(threadIdx.x % LANES), mask}, S, J + s * NEFC * NV, M + s * NV * NV,
                  D + s * NEFC, aref + s * NEFC, fl + s * NEFC, eta + s * NEFC, qs + s * NV,
                  x + s * NV, qfrc + s * NV);
}

// Samples a block, chosen once per type from the team's shared memory and
// the occupancy it gives: the count of 1, 2, 4 or 8 that keeps the most
// teams on an SM, the smallest of equals. Minus a CUDA error code if the
// query fails, 0 if one team's working set exceeds what a block may have.
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
  err = cudaFuncSetAttribute(solver_newton_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             most * bytes);
  if (err != cudaSuccess) return {-(int)err, 0};
  LaunchShape best = {0, 0};
  for (int spb = 1; spb <= most; spb *= 2) {
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, solver_newton_kernel<T>,
                                                        spb * LANES, spb * bytes);
    if (err != cudaSuccess) return {-(int)err, 0};
    if (blocks * spb > best.teams_per_sm) best = {spb, blocks * spb};
  }
  return best;
}

template <typename T>
static const LaunchShape& launch_shape() {
  static const LaunchShape shape = choose_shape<T>();
  return shape;
}

template <typename T>
static int launch(const void* J, const void* M, const void* D, const void* aref, const void* fl,
                  const void* eta, const void* qs, void* x, void* qfrc, int B, void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  const LaunchShape& sh = launch_shape<T>();
  if (sh.samples_per_block < 0) return -sh.samples_per_block;
  if (sh.samples_per_block == 0) return (int)cudaErrorInvalidConfiguration;
  const int spb = sh.samples_per_block;
  const int blocks = (B + spb - 1) / spb;
  solver_newton_kernel<T><<<blocks, spb * LANES, spb * TeamBytes<T>::value, (cudaStream_t)stream>>>(
      (const T*)J, (const T*)M, (const T*)D, (const T*)aref, (const T*)fl, (const T*)eta,
      (const T*)qs, (T*)x, (T*)qfrc, B, spb);
  return (int)cudaGetLastError();
}

extern "C" {
int solver_newton_f32(const void* J, const void* M, const void* D, const void* aref,
                      const void* fl, const void* eta, const void* qs, void* x, void* qfrc, int B,
                      void* stream) {
  return launch<float>(J, M, D, aref, fl, eta, qs, x, qfrc, B, stream);
}
int solver_newton_f64(const void* J, const void* M, const void* D, const void* aref,
                      const void* fl, const void* eta, const void* qs, void* x, void* qfrc, int B,
                      void* stream) {
  return launch<double>(J, M, D, aref, fl, eta, qs, x, qfrc, B, stream);
}
// seven (B, ...) inputs and two (B, nv) outputs, one contiguous row a sample
int solver_sample_major() { return 1; }
int solver_nv() { return sc::NV; }
int solver_nefc() { return sc::NEFC; }
int solver_lanes() { return LANES; }
int solver_team_bytes_f32() { return TeamBytes<float>::value; }
int solver_team_bytes_f64() { return TeamBytes<double>::value; }
// samples a block and teams an SM of the launch (0: a team does not fit a
// block; negative: minus a CUDA error code)
int solver_samples_per_block_f32() { return launch_shape<float>().samples_per_block; }
int solver_samples_per_block_f64() { return launch_shape<double>().samples_per_block; }
int solver_teams_per_sm_f32() { return launch_shape<float>().teams_per_sm; }
int solver_teams_per_sm_f64() { return launch_shape<double>().teams_per_sm; }
}
