// Batched small SPD factor and solve for Hopper (sm_90a), env-last layout.
//
// N independent n x n SPD systems (n <= 32), one per env. Every buffer is
// contiguous float32 with the env index e fastest:
//
//     At (n, n, N):  A[i][j] of env e     at At[(i * n + j) * N + e]
//     Lt (n, n, N):  L[i][k] of env e     at Lt[(k * n + i) * N + e]
//                    (Lt[k] holds column k of the lower factor L; the
//                    entries above the diagonal, i < k, are 0)
//     bt, xt (K, n, N): rhs r, row i      at bt[(r * n + i) * N + e]
//
// Entry points (plain C, bound with ctypes):
//     spd_factor_lanes_f32      A = L L^T, column Cholesky
//     spd_substitute_lanes_f32  x = L^-T L^-1 b for K right-hand sides
//     spd_solve_lanes_f32       factor + substitute in one launch (K = 1)
//
// Replaces the Pallas TPU kernel bayes_sim_ig_tpu/ops/spd_kernel.py
// (_pallas_lanes, body _spd_kernel), which solves the same systems by
// Gauss elimination in one fused pass, and the two halves of the
// column Cholesky the physics calls on every step (_chol_lanes_factor,
// _chol_lanes_substitute): the factor is computed once per env step and
// reused for every substep and every extra right-hand side, so factor and
// substitute are separate entry points here.
//
// NaN policy (as _chol_lanes_factor): a pivot that is not > 0, NaN
// included, makes that column's pivot NaN, so the env's whole solution
// is NaN and the env step's non-finite quarantine resets it. Other envs
// are untouched: nothing is shared between threads.
//
// What bounds it on an H100: at the physics shapes (n = 14, N = 1024) a
// factor is n^3 / 6 = 457 multiply-adds per env and the whole batch reads
// and writes ~1.6 MB: microseconds of work, so latency bounds it, not
// FLOPs or bytes. The design is one thread per env: a warp's 32 threads
// touch 32 consecutive floats of every row, which is one coalesced 128 B
// transaction, and no thread ever waits on another. The recurrences run
// on global memory (the ~800 B per env of A and L stay in L2); the fused
// solve keeps its factor in a per-thread local array, which the hardware
// interleaves across threads, so those accesses coalesce too. Full
// precision sqrtf and division: this file must not be built with
// --use_fast_math.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int MAX_N = 32;
// One warp a block: at N = 1024 envs the batch then spreads over 32 SMs
// instead of 8 (the work per env is a long dependent chain).
constexpr int BLOCK = 32;

// L[i][k] (i >= k) in the env-last Lt layout of one env.
struct LanesFactor {
  float* p;  // Lt + e
  int n;
  int N;
  __device__ float& operator()(int i, int k) const {
    return p[((size_t)k * n + i) * N];
  }
};

// L[i][k] (i >= k) packed row by row in a thread's own array.
struct PackedFactor {
  float* p;
  __device__ float& operator()(int i, int k) const {
    return p[i * (i + 1) / 2 + k];
  }
};

// Column Cholesky of the system whose A[i][j] is a[(i * n + j) * N]. The
// order of the operations follows _chol_lanes_factor: column j subtracts
// the built columns from A's column j, then divides by the pivot.
template <class Factor>
__device__ void factor_one(const float* a, Factor L, int n, int N) {
  for (int j = 0; j < n; ++j) {
    float raw_jj = a[((size_t)j * n + j) * N];
    for (int k = 0; k < j; ++k) {
      const float ljk = L(j, k);
      raw_jj -= ljk * ljk;
    }
    const float d = raw_jj > 0.0f ? sqrtf(fmaxf(raw_jj, 1e-30f))
                                    : CUDART_NAN_F;
    L(j, j) = raw_jj / d;
    for (int i = j + 1; i < n; ++i) {
      float raw = a[((size_t)i * n + j) * N];
      for (int k = 0; k < j; ++k) raw -= L(j, k) * L(i, k);
      L(i, j) = raw / d;
    }
  }
}

// x = L^-T L^-1 b for one right-hand side; y lives in x between the two
// passes (the back pass reads y[i] before it writes x[i]).
template <class Factor>
__device__ void substitute_one(Factor L, const float* b, float* x, int n,
                               int N) {
  for (int i = 0; i < n; ++i) {
    float acc = b[(size_t)i * N];
    for (int k = 0; k < i; ++k) acc -= L(i, k) * x[(size_t)k * N];
    x[(size_t)i * N] = acc / L(i, i);
  }
  for (int i = n - 1; i >= 0; --i) {
    float acc = x[(size_t)i * N];
    for (int k = i + 1; k < n; ++k) acc -= L(k, i) * x[(size_t)k * N];
    x[(size_t)i * N] = acc / L(i, i);
  }
}

__global__ void __launch_bounds__(BLOCK)
spd_factor_kernel(const float* __restrict__ At, float* Lt, int n, int N) {
  const int e = blockIdx.x * BLOCK + threadIdx.x;
  if (e >= N) return;
  LanesFactor L{Lt + e, n, N};
  for (int k = 1; k < n; ++k)
    for (int i = 0; i < k; ++i) L(i, k) = 0.0f;  // above the diagonal
  factor_one(At + e, L, n, N);
}

__global__ void __launch_bounds__(BLOCK)
spd_substitute_kernel(const float* Lt, const float* __restrict__ bt,
                      float* __restrict__ xt, int n, int N) {
  const int e = blockIdx.x * BLOCK + threadIdx.x;
  if (e >= N) return;
  const size_t rhs = (size_t)blockIdx.y * n * N;
  LanesFactor L{const_cast<float*>(Lt) + e, n, N};
  substitute_one(L, bt + rhs + e, xt + rhs + e, n, N);
}

__global__ void __launch_bounds__(BLOCK)
spd_solve_kernel(const float* __restrict__ At, const float* __restrict__ bt,
                 float* __restrict__ xt, int n, int N) {
  const int e = blockIdx.x * BLOCK + threadIdx.x;
  if (e >= N) return;
  float packed[MAX_N * (MAX_N + 1) / 2];
  PackedFactor L{packed};
  factor_one(At + e, L, n, N);
  substitute_one(L, bt + e, xt + e, n, N);
}

int check(int n, int N, int K) {
  if (n < 1 || n > MAX_N || N < 0 || K < 0 || K > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

}  // namespace

// Plain C entries for ctypes. Each launches on `stream` and returns
// cudaGetLastError() (or cudaErrorInvalidValue for a shape the kernels do
// not take), so a refused launch is reported to the caller.
extern "C" int spd_factor_lanes_f32(const float* At, float* Lt, int n, int N,
                                    void* stream) {
  if (int err = check(n, N, 1)) return err;
  if (N == 0) return (int)cudaSuccess;
  spd_factor_kernel<<<(N + BLOCK - 1) / BLOCK, BLOCK, 0,
                      (cudaStream_t)stream>>>(At, Lt, n, N);
  return (int)cudaGetLastError();
}

extern "C" int spd_substitute_lanes_f32(const float* Lt, const float* bt,
                                        float* xt, int n, int K, int N,
                                        void* stream) {
  if (int err = check(n, N, K)) return err;
  if (N == 0 || K == 0) return (int)cudaSuccess;
  dim3 grid((N + BLOCK - 1) / BLOCK, K);
  spd_substitute_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      Lt, bt, xt, n, N);
  return (int)cudaGetLastError();
}

extern "C" int spd_solve_lanes_f32(const float* At, const float* bt,
                                   float* xt, int n, int N, void* stream) {
  if (int err = check(n, N, 1)) return err;
  if (N == 0) return (int)cudaSuccess;
  spd_solve_kernel<<<(N + BLOCK - 1) / BLOCK, BLOCK, 0,
                     (cudaStream_t)stream>>>(At, bt, xt, n, N);
  return (int)cudaGetLastError();
}
