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
//     spd_factor_lanes_f32      A = L L^T, Cholesky
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
// are untouched: lanes of different envs share no data.
//
// What bounds it on an H100: at the physics shapes (n = 14, N = 1024) a
// factor is n^3 / 6 = 457 multiply-adds per env and the call needs 1.2 MB
// of traffic (0.4 us at 3.35 TB/s): neither FLOPs nor bytes bound it, the
// latency of its dependent chains does. One thread per env (the first
// design) ran the whole 457-deep chain per thread on global memory, with
// 32 warps for 132 SMs at N = 1024. This design:
//   - gives each env a group of G lanes, a half warp for n <= 16 and a
//     full warp for n <= 32 (two instances of one template); a block of
//     128 threads holds 128 / G envs, so N = 1024 at n = 14 is 128 blocks
//     of 4 warps, and lane i of a group owns row i of its env;
//   - stages the block's tile of At (or Lt) in shared memory with 4-B
//     cp.async copies in the global order, so a warp's copies are
//     consecutive envs of one row (coalesced), and pads the tile's row
//     and env strides so that the lanes reading their rows, or their
//     columns, fall in distinct banks;
//   - factors right-looking in registers: in column step k the pivot lane
//     broadcasts its raw pivot with __shfl_sync, every lane takes sqrtf
//     and divides its own entry, and the rank-1 update of the trailing
//     rows takes L[j][k] from lane j by shuffle. Each entry receives the
//     same fused multiply-adds in the same order as the column Cholesky
//     of _chol_lanes_factor, so the factor is that of the first design
//     bit for bit;
//   - substitutes with lane i's row of L left of the diagonal and its
//     column below it in one register array (<= 32 floats: the two meet
//     only at the diagonal): n shuffle steps forward, n back. The forward
//     pass keeps the first design's order of operations; the back pass
//     subtracts in descending column order (held to the same tolerance).
//     Two arrays, a row and a column, made the full-warp instance spill
//     12 bytes (see the times below);
//   - writes results back through the shared tile, coalesced.
// n shuffle steps of a divide, a shuffle and an FMA replace n^3 / 6
// global round trips. Measured on an H100 80GB HBM3 at its 700.00 W limit
// (kernel_ab.py: profiler device time per call, n = 14, N = 1024): factor
// 8.8 us (first design 36.2, torch.linalg.cholesky_ex 14.0), substitute
// 7.4 us (7.1 with the two arrays below; first design 14.6;
// torch.cholesky_solve 46.3), fused solve 12.0 us (36.1;
// torch.linalg.solve 35.9). The same launches at n = 1 (launch, one
// staging round trip, the store) take 1.9, 2.5 and 3.1 us. At Anymal's
// n = 18, N = 4000 (the full-warp instance, same card and limit):
// factor 25.0 us (cholesky_ex 72.9), substitute 16.6 us (21.2 with the
// two arrays; cholesky_solve 162), fused solve 32.2 us. Staging the
// tile row by row to spare the index divisions measured slower.
// Full-precision sqrtf and division: this file must not be built with
// --use_fast_math.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int MAX_N = 32;
constexpr int THREADS = 128;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4-B global -> shared copy; with valid false it reads nothing and
// writes 0.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// The shared tile of a block's T = THREADS / G envs: entry (a, b) of env t
// (global offset (a * n + b) * N + e) at t * ts + a * rs + b. Lane i reads
// its row (i, .) at stride rs and its column (., i) at stride 1. With
// G = 32 one env fills a warp and rs is odd; with G = 16 two envs share a
// warp, rs is twice an odd number (16 lanes on 16 distinct even banks)
// and ts is odd (the second env on the odd banks).
template <int G>
struct Tile {
  static constexpr int T = THREADS / G;
  int n, rs, ts;
  __host__ __device__ explicit Tile(int n_) : n(n_) {
    rs = G == 32 ? (n | 1) : 2 * (((n + 1) / 2) | 1);
    ts = G == 32 ? n * rs : n * rs + 1;
  }
  __device__ int at(int t, int a, int b) const { return t * ts + a * rs + b; }
  __host__ __device__ int floats() const { return T * ts; }
};

// Copies `rows` rows of the block's envs e0 .. e0 + T - 1 from the env-last
// array src (row q of env e at q * N + e) into dst(t, q): consecutive
// threads copy consecutive envs of one row. Envs at or past N read 0.
template <int T, class Dst>
__device__ __forceinline__ void stage_rows(const float* __restrict__ src,
                                           int rows, int N, int e0,
                                           Dst dst) {
  for (int u = threadIdx.x; u < rows * T; u += THREADS) {
    const int t = u % T, q = u / T;
    const bool ok = e0 + t < N;
    cp_async4(dst(t, q), ok ? src + (size_t)q * N + e0 + t : src, ok);
  }
}

// Writes `rows` rows of the block's envs from src(t, q) to the env-last
// array dst, coalesced as stage_rows.
template <int T, class Src>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, int rows,
                                           int N, int e0, Src src) {
  for (int u = threadIdx.x; u < rows * T; u += THREADS) {
    const int t = u % T, q = u / T;
    if (e0 + t < N) dst[(size_t)q * N + e0 + t] = src(t, q);
  }
}

// Right-looking Cholesky of one env held one row a lane: on entry lane i
// holds A[i][j] in a[j] (j <= i read), on exit L[i][k] in a[k] (k <= i).
template <int G>
__device__ __forceinline__ void factor_rows(float (&a)[G], int i, int n) {
#pragma unroll
  for (int k = 0; k < G; ++k) {
    if (k >= n) break;
    const float raw = __shfl_sync(FULL, a[k], k, G);
    const float d = raw > 0.0f ? sqrtf(fmaxf(raw, 1e-30f)) : CUDART_NAN_F;
    const float lik = a[k] / d;
    if (i >= k) a[k] = lik;
#pragma unroll
    for (int j = k + 1; j < G; ++j) {
      if (j >= n) break;
      const float ljk = __shfl_sync(FULL, lik, j, G);
      if (j <= i) a[j] = fmaf(-lik, ljk, a[j]);
    }
  }
}

// x = L^-T L^-1 b for one env: lane i holds lc[k] = L[i][k] for k <= i
// (its row) and L[k][i] for k >= i (its column), and b_i; returns x_i.
template <int G>
__device__ __forceinline__ float substitute_rows(const float (&lc)[G],
                                                 float b, int i, int n) {
  float diag = 0.0f;
#pragma unroll
  for (int k = 0; k < G; ++k)
    if (k == i) diag = lc[k];
  float acc = b, y = 0.0f;
#pragma unroll
  for (int k = 0; k < G; ++k) {
    if (k >= n) break;
    const float yk = __shfl_sync(FULL, acc / diag, k, G);
    if (i == k) y = yk;
    if (i > k) acc = fmaf(-lc[k], yk, acc);
  }
  acc = y;
  float x = 0.0f;
#pragma unroll
  for (int k = G - 1; k >= 0; --k) {
    if (k >= n) continue;
    const float xk = __shfl_sync(FULL, acc / diag, k, G);
    if (i == k) x = xk;
    if (i < k) acc = fmaf(-lc[k], xk, acc);
  }
  return x;
}

template <int G>
__global__ void __launch_bounds__(THREADS)
spd_factor_kernel(const float* __restrict__ At, float* __restrict__ Lt,
                  int n, int N) {
  extern __shared__ float s[];
  const Tile<G> tile(n);
  constexpr int T = Tile<G>::T;
  const int e0 = blockIdx.x * T;
  stage_rows<T>(At, n * n, N, e0, [&](int t, int q) {
    return s + tile.at(t, q / n, q % n);
  });
  cp_async_wait_all();
  __syncthreads();
  const int t = threadIdx.x / G, i = threadIdx.x % G;
  float a[G];
#pragma unroll
  for (int j = 0; j < G; ++j)
    a[j] = (i < n && j < n) ? s[tile.at(t, i, j)] : 0.0f;
  factor_rows<G>(a, i, n);
  __syncwarp();  // every lane of the env has read its row of A
  if (i < n) {
#pragma unroll
    for (int k = 0; k < G; ++k)
      if (k < n) s[tile.at(t, k, i)] = k <= i ? a[k] : 0.0f;
  }
  __syncthreads();
  store_rows<T>(Lt, n * n, N, e0, [&](int t, int q) {
    return s[tile.at(t, q / n, q % n)];
  });
}

// Lane i's row of L left of the diagonal and its column below it (see
// substitute_rows) from a tile that holds Lt's (k, i) layout: L[i][k] at
// (k, i), L[k][i] at (i, k).
template <int G>
__device__ __forceinline__ void load_factor(const float* s, const Tile<G>& tile,
                                            int t, int i, int n,
                                            float (&lc)[G]) {
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const bool ok = i < n && k < n;
    lc[k] = !ok ? 0.0f : k <= i ? s[tile.at(t, k, i)] : s[tile.at(t, i, k)];
  }
}

template <int G>
__global__ void __launch_bounds__(THREADS)
spd_substitute_kernel(const float* __restrict__ Lt,
                      const float* __restrict__ bt, float* __restrict__ xt,
                      int n, int N) {
  extern __shared__ float s[];
  const Tile<G> tile(n);
  constexpr int T = Tile<G>::T;
  float* xs = s + tile.floats();  // row i of env t at xs[t * G + i]
  const int e0 = blockIdx.x * T;
  const size_t rhs = (size_t)blockIdx.y * n * N;
  stage_rows<T>(Lt, n * n, N, e0, [&](int t, int q) {
    return s + tile.at(t, q / n, q % n);
  });
  stage_rows<T>(bt + rhs, n, N, e0, [&](int t, int q) {
    return xs + t * G + q;
  });
  cp_async_wait_all();
  __syncthreads();
  const int t = threadIdx.x / G, i = threadIdx.x % G;
  float lc[G];
  load_factor<G>(s, tile, t, i, n, lc);
  const float x = substitute_rows<G>(lc, i < n ? xs[t * G + i] : 0.0f, i, n);
  if (i < n) xs[t * G + i] = x;
  __syncthreads();
  store_rows<T>(xt + rhs, n, N, e0, [&](int t, int q) {
    return xs[t * G + q];
  });
}

template <int G>
__global__ void __launch_bounds__(THREADS)
spd_solve_kernel(const float* __restrict__ At, const float* __restrict__ bt,
                 float* __restrict__ xt, int n, int N) {
  extern __shared__ float s[];
  const Tile<G> tile(n);
  constexpr int T = Tile<G>::T;
  float* xs = s + tile.floats();
  const int e0 = blockIdx.x * T;
  stage_rows<T>(At, n * n, N, e0, [&](int t, int q) {
    return s + tile.at(t, q / n, q % n);
  });
  stage_rows<T>(bt, n, N, e0, [&](int t, int q) { return xs + t * G + q; });
  cp_async_wait_all();
  __syncthreads();
  const int t = threadIdx.x / G, i = threadIdx.x % G;
  float lc[G];
#pragma unroll
  for (int j = 0; j < G; ++j)
    lc[j] = (i < n && j < n) ? s[tile.at(t, i, j)] : 0.0f;
  factor_rows<G>(lc, i, n);
  // Lane i's row of L goes where it read its row of A, (i, k); lane i
  // then reads its column below the diagonal, L[k][i], at (k, i).
  if (i < n) {
#pragma unroll
    for (int k = 0; k < G; ++k)
      if (k < n) s[tile.at(t, i, k)] = k <= i ? lc[k] : 0.0f;
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < G; ++k)
    if (k > i) lc[k] = (i < n && k < n) ? s[tile.at(t, k, i)] : 0.0f;
  const float x = substitute_rows<G>(lc, i < n ? xs[t * G + i] : 0.0f, i, n);
  if (i < n) xs[t * G + i] = x;
  __syncthreads();
  store_rows<T>(xt, n, N, e0, [&](int t, int q) { return xs[t * G + q]; });
}

int check(int n, int N, int K) {
  if (n < 1 || n > MAX_N || N < 0 || K < 0 || K > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

// Shared bytes of a launch: the tile, plus the right-hand-side rows.
template <int G>
size_t smem_bytes(int n, bool rhs) {
  return sizeof(float) * (Tile<G>(n).floats() + (rhs ? THREADS : 0));
}

template <int G>
int blocks(int N) {
  constexpr int T = THREADS / G;
  return (N + T - 1) / T;
}

}  // namespace

// Plain C entries for ctypes. Each launches on `stream` and returns
// cudaGetLastError() (or cudaErrorInvalidValue for a shape the kernels do
// not take), so a refused launch is reported to the caller. n <= 16 takes
// the half-warp instance, 16 < n <= 32 the full-warp one.
extern "C" int spd_factor_lanes_f32(const float* At, float* Lt, int n, int N,
                                    void* stream) {
  if (int err = check(n, N, 1)) return err;
  if (N == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 16)
    spd_factor_kernel<16><<<blocks<16>(N), THREADS, smem_bytes<16>(n, false),
                            st>>>(At, Lt, n, N);
  else
    spd_factor_kernel<32><<<blocks<32>(N), THREADS, smem_bytes<32>(n, false),
                            st>>>(At, Lt, n, N);
  return (int)cudaGetLastError();
}

extern "C" int spd_substitute_lanes_f32(const float* Lt, const float* bt,
                                        float* xt, int n, int K, int N,
                                        void* stream) {
  if (int err = check(n, N, K)) return err;
  if (N == 0 || K == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 16)
    spd_substitute_kernel<16><<<dim3(blocks<16>(N), K), THREADS,
                                smem_bytes<16>(n, true), st>>>(Lt, bt, xt, n,
                                                               N);
  else
    spd_substitute_kernel<32><<<dim3(blocks<32>(N), K), THREADS,
                                smem_bytes<32>(n, true), st>>>(Lt, bt, xt, n,
                                                               N);
  return (int)cudaGetLastError();
}

extern "C" int spd_solve_lanes_f32(const float* At, const float* bt,
                                   float* xt, int n, int N, void* stream) {
  if (int err = check(n, N, 1)) return err;
  if (N == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 16)
    spd_solve_kernel<16><<<blocks<16>(N), THREADS, smem_bytes<16>(n, true),
                           st>>>(At, bt, xt, n, N);
  else
    spd_solve_kernel<32><<<blocks<32>(N), THREADS, smem_bytes<32>(n, true),
                           st>>>(At, bt, xt, n, N);
  return (int)cudaGetLastError();
}
