// The half-solves of the branch-sparse L^T D L factor for Hopper (sm_90a),
// env-last layout: z = L^-T b (upsolve) and x = L^-1 z (downsolve) for K
// right-hand sides against csrc/tree_ltdl.cu's factor.
//
// Layout and table as in csrc/tree_ltdl.cu: H (E, N) holds L at pair p of
// env e at H[p * N + e], right-hand side r, row k at b[(r * nv + k) * N +
// e]; the pairs of dof k are rows off[k] .. off[k+1]-1, (k, k) first, then
// (k, anc[p]) for its proper ancestors, leaf to root. These kernels read
// only off (nv + 1) and anc (E), the head of the table ops/tree_solve.py
// builds (kernel_table); the rest of it is the factor's and the
// substitute's.
//
// Replaces bayes_sim_ig_tpu/ops/tree_solve.py's ltdl_upsolve (:146) and
// ltdl_downsolve (:163), jnp loops that XLA fuses (no Pallas original).
// The contact impulse pass (physics/contact.py) up-solves its Jacobian
// rows once a control step (ShadowHand: K = 51) and down-solves one
// vector a substep (K = 1). An up-solve of rows that are zero outside an
// ancestor-closed dof set leaves them zero there, so one full pass serves
// every closure at once.
//
//   up:   for k = nv-1 .. 0: for each pair p of k: x[anc[p]] -= H[p] x[k]
//   down: for k = 0 .. nv-1: x[k] -= sum over k's pairs p of H[p] x[anc[p]]
//
// Each row receives the same fused multiply-adds in the same order as the
// substitute kernel's up and down passes, so both are bit for bit those
// passes (kernel_ab.py --half-same holds them to the earlier half-solves,
// the substitute kernel with a pass mask).
//
// What bounds them on an H100: the bytes. ShadowHand (nv 30, E 128, 98
// off-diagonal pairs, chains at most 6 deep) at N = 1024 and K = 51 moves
// 12.9 MB (b read, x written, H read once: 3.9 us at 3.35 TB/s) for 98
// multiply-adds a right-hand side. The first form was the substitute
// kernel with a pass mask: 16 envs a block of 256 threads, G = 16 lanes an
// env, a block for every right-hand side. At K = 51 it staged the same H
// 51 times over (3,264 blocks, ~26 MB through L2) and walked the 30 dofs
// one after another with a __syncwarp at each, one ancestor a lane: at
// least 10 of 16 lanes idle at ShadowHand's chains. It lost to one
// solve_triangular call (0.0477 against 0.0393 ms on an H100 80GB HBM3 at
// 700 W).
//
// This design gives one thread one (env, right-hand side), which walks the
// whole pass alone, with no barrier inside it:
//   - threadIdx.x covers 32 consecutive envs, so a warp's load of a row of
//     b or of a pair of H is one 128-B line; threadIdx.y covers Kb
//     right-hand sides, blockIdx.y the tiles of Kb;
//   - the working x sits in shared memory as [row][thread], so a warp's 32
//     threads touch 32 consecutive words (no bank conflict);
//   - H for the block's 32 envs is staged once in shared memory and read
//     by all Kb right-hand sides: H goes through L2 ceil(K / Kb) times,
//     not K times (reading it through L1 instead was 1.2-2.4x slower at
//     every shape timed: PERF.md, kernel_ab.py --half-same);
//   - the table head, b and H arrive with cp.async and one wait, 16 B a
//     copy where rows are 16-B aligned (N % 4 == 0), from every warp of
//     the block: a block has at least 4 warps, those past Kb only stage
//     (one warp issuing ShadowHand's 4,096 4-B copies of H took longer
//     than the whole lane kernel);
//   - inside the pass a dof's pairs (ancestor, H) go in batches of
//     HALF_BATCH, the next dof's first batch loaded before this dof's
//     updates: they do not depend on x;
//   - the host picks Kb (half_plan below, the same function as
//     ops/tree_solve.py's half_plan): up to TREE_HALF_KB, no more than K,
//     and no more than the 227 KB of shared memory hold. At ShadowHand's
//     1024 envs and K = 51 that is 32 x 7 = 224 blocks of 256 threads. At
//     the wrapper's edge (nv 256, E 1,024) Kb is 2. TREE_HALF_KB is a
//     macro so that kernel_ab.py --half-same can build Kb 4 and 16 beside
//     the default 8 and re-run the sweep.
// One thread per env is latency-bound where few warps exist: at
// ShadowHand's 1024 envs and K = 1 (the downsolve of every substep) the
// whole card holds 32 walking warps, each a chain of 30 dofs with nothing
// to hide it (6.2 us against the lane kernel's 3.4 on an H100 80GB HBM3
// at 700 W, kernel_ab.py --half-same). So where ceil(N / 32) K is
// under the card's SM count (132 on an H100), the entries launch the
// substitute's up or down pass alone (tree_lanes.cuh: 16 lanes an env, a
// depth round at a time), which is bit for bit the same.
// Tensor cores do not apply: the work is 98 multiply-adds a right-hand
// side along dependent chains at most 6 deep (ShadowHand), no matrix
// product for wgmma, and a block's tiles (8-16 KB) are too small for TMA
// to help.
//
// NaN policy: a thread (or a lane group) reads only its own env's H and
// b, so an env whose factor went non-finite comes out non-finite alone; no
// other env is touched.

#include "tree_lanes.cuh"

#ifndef TREE_HALF_KB
#define TREE_HALF_KB 8  // most right-hand sides a block (ops/tree_solve.py)
#endif

namespace {

constexpr int ENVS = 32;         // envs a block: one warp wide
constexpr int KB_MAX = TREE_HALF_KB;
constexpr int MIN_WARPS = 4;     // warps a block at least: the rest stage
constexpr int HALF_BATCH = 4;    // pairs of a dof loaded at once
constexpr int SMEM_LIMIT = 232448;  // shared memory a block can use

// 16-B global -> shared copy; with valid false it reads nothing and
// writes 0.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// Rows of the block's 32 envs from an env-last array: row i is
// src[map(i).src + e0 + t] for env e0 + t (map(i).src < 0: a row of
// zeros), to dst[map(i).dst + t]. All threads of the block take part;
// 16-B copies when `vec` (rows 16-B aligned: N % 4 == 0 and src aligned),
// else 4-B. Envs at or past N read 0.
struct RowMap {
  long long src;
  int dst;
};

template <class Map>
__device__ __forceinline__ void stage_env_rows(float* dst, const float* src,
                                               int rows, Map map, bool vec,
                                               int e0, int N, int tid,
                                               int threads) {
  const int w = vec ? 4 : 1, per_row = ENVS / w;
  for (int u = tid; u < rows * per_row; u += threads) {
    const int i = u / per_row, c = (u - i * per_row) * w;
    const RowMap m = map(i);
    const bool ok = m.src >= 0 && e0 + c < N;
    const float* g = ok ? src + m.src + e0 + c : src;
    if (vec)
      cp_async16(dst + m.dst + c, g, ok);
    else
      cp_async4(dst + m.dst + c, g, ok);
  }
}

__device__ __forceinline__ bool rows_aligned(const float* p, int N) {
  return (N & 3) == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Dof k's pairs p .. p + HALF_BATCH - 1 (those below p1): their ancestors
// and H (h: this thread's env in the staged [pair][env] tile); a pair past
// the chain gets ancestor k and 0. Its loads read pair
// 0 instead, so that a load the compiler issues unpredicated stays inside
// the table and H.
__device__ __forceinline__ void load_batch(const int* anc, const float* h,
                                           int p, int p1, int k,
                                           int a[HALF_BATCH],
                                           float l[HALF_BATCH]) {
#pragma unroll
  for (int u = 0; u < HALF_BATCH; ++u) {
    const bool in = p + u < p1;
    const int q = in ? p + u : 0;
    const int aq = anc[q];
    const float hq = h[q * ENVS];
    a[u] = in ? aq : k;
    l[u] = in ? hq : 0.0f;
  }
}

// z = L^-T b in place on this thread's column xs (row k at xs[k * cols]):
// dof k, leaf to root, pushes its row to its chain, the next dof's first
// batch loaded before this dof's updates.
__device__ __forceinline__ void up_walk(const int* off, const int* anc,
                                        const float* h, float* xs, int cols,
                                        int nv) {
  int a[HALF_BATCH];
  float l[HALF_BATCH];
  load_batch(anc, h, off[nv - 1] + 1, off[nv], nv - 1, a, l);
  for (int k = nv - 1; k >= 0; --k) {
    const int p0 = off[k] + 1, p1 = off[k + 1];
    const float xk = xs[k * cols];
    float v[HALF_BATCH];
#pragma unroll
    for (int u = 0; u < HALF_BATCH; ++u) v[u] = xs[a[u] * cols];
    int na[HALF_BATCH];
    float nl[HALF_BATCH];
    const int kn = k > 0 ? k - 1 : 0;
    load_batch(anc, h, off[kn] + 1, k > 0 ? off[k] : 0, kn, na, nl);
    // The ancestors of one chain are distinct: the batch's reads and
    // writes touch distinct rows.
#pragma unroll
    for (int u = 0; u < HALF_BATCH; ++u)
      if (p0 + u < p1) xs[a[u] * cols] = fmaf(-l[u], xk, v[u]);
    for (int p = p0 + HALF_BATCH; p < p1; p += HALF_BATCH) {
      load_batch(anc, h, p, p1, k, a, l);
#pragma unroll
      for (int u = 0; u < HALF_BATCH; ++u) v[u] = xs[a[u] * cols];
#pragma unroll
      for (int u = 0; u < HALF_BATCH; ++u)
        if (p + u < p1) xs[a[u] * cols] = fmaf(-l[u], xk, v[u]);
    }
#pragma unroll
    for (int u = 0; u < HALF_BATCH; ++u) {
      a[u] = na[u];
      l[u] = nl[u];
    }
  }
}

// x = L^-1 z in place on this thread's column xs, root to leaf: dof k
// subtracts its chain's terms, leaf to root, the next dof's first batch
// loaded before this dof's sum. A term past the chain is fmaf(-0, 0, acc),
// which leaves acc as it is (the substitute's padding).
__device__ __forceinline__ void down_walk(const int* off, const int* anc,
                                          const float* h, float* xs, int cols,
                                          int nv) {
  int a[HALF_BATCH];
  float l[HALF_BATCH];
  load_batch(anc, h, off[0] + 1, off[1], 0, a, l);
  for (int k = 0; k < nv; ++k) {
    const int p0 = off[k] + 1, p1 = off[k + 1];
    float v[HALF_BATCH];
#pragma unroll
    for (int u = 0; u < HALF_BATCH; ++u)
      v[u] = p0 + u < p1 ? xs[a[u] * cols] : 0.0f;
    int na[HALF_BATCH];
    float nl[HALF_BATCH];
    const int kn = k + 1 < nv ? k + 1 : k;
    load_batch(anc, h, off[kn] + 1, k + 1 < nv ? off[kn + 1] : 0, kn, na,
               nl);
    float acc = xs[k * cols];
#pragma unroll
    for (int u = 0; u < HALF_BATCH; ++u) acc = fmaf(-l[u], v[u], acc);
    for (int p = p0 + HALF_BATCH; p < p1; p += HALF_BATCH) {
      load_batch(anc, h, p, p1, k, a, l);
#pragma unroll
      for (int u = 0; u < HALF_BATCH; ++u)
        v[u] = p + u < p1 ? xs[a[u] * cols] : 0.0f;
#pragma unroll
      for (int u = 0; u < HALF_BATCH; ++u) acc = fmaf(-l[u], v[u], acc);
    }
    xs[k * cols] = acc;
#pragma unroll
    for (int u = 0; u < HALF_BATCH; ++u) {
      a[u] = na[u];
      l[u] = nl[u];
    }
  }
}

// Words of the table head (off, anc) in shared memory, padded to 16 B.
__host__ __device__ inline int table_words(int nv, int E) {
  return (nv + 1 + E + 3) & ~3;
}

// One (env, right-hand side) a thread: envs blockIdx.x * 32 + threadIdx.x,
// right-hand sides blockIdx.y * kb + threadIdx.y for threadIdx.y < kb; the
// block's other warps (blockDim.y is at least MIN_WARPS) only stage.
// Dynamic shared memory: the table head, x (nv rows of cols = 32 kb
// columns), then H (E x 32).
template <bool UPWARD>
__global__ void __launch_bounds__(ENVS *(KB_MAX > MIN_WARPS ? KB_MAX
                                                            : MIN_WARPS))
tree_half_kernel(const int* __restrict__ table, int nv, int E,
                 const float* __restrict__ H, const float* __restrict__ b,
                 float* __restrict__ x, int K, int N, int kb) {
  extern __shared__ float smem[];  // 16-B aligned, as the lane kernel's
  const int cols = ENVS * kb, threads = ENVS * blockDim.y;
  const int tid = threadIdx.y * ENVS + threadIdx.x;
  const int e0 = blockIdx.x * ENVS, e = e0 + threadIdx.x;
  const int r0 = blockIdx.y * kb, r = r0 + threadIdx.y;
  int* tab = reinterpret_cast<int*>(smem);
  float* xcol = smem + table_words(nv, E);
  float* sh = xcol + nv * cols;
  for (int u = tid; u < nv + 1 + E; u += threads)
    cp_async4(tab + u, table + u, true);
  // b: row rl * nv + k is right-hand side r0 + rl, dof k.
  stage_env_rows(
      xcol, b, kb * nv,
      [=](int i) {
        const int rl = i / nv, k = i - rl * nv;
        return RowMap{r0 + rl < K ? ((long long)(r0 + rl) * nv + k) * N : -1,
                      k * cols + rl * ENVS};
      },
      rows_aligned(b, N), e0, N, tid, threads);
  stage_env_rows(
      sh, H, E, [=](int i) { return RowMap{(long long)i * N, i * ENVS}; },
      rows_aligned(H, N), e0, N, tid, threads);
  cp_async_wait_all();
  __syncthreads();
  if (threadIdx.y >= kb || r >= K) return;
  float* xs = xcol + tid;
  const float* h = sh + threadIdx.x;
  if (UPWARD)
    up_walk(tab, tab + nv + 1, h, xs, cols, nv);
  else
    down_walk(tab, tab + nv + 1, h, xs, cols, nv);
  if (e < N) {
    const size_t col = (size_t)r * nv * N + e;
    for (int k = 0; k < nv; ++k) x[col + (size_t)k * N] = xs[k * cols];
  }
}

// The launch of a shape (ops/tree_solve.py half_plan, the same function).
// lanes: the thread kernel would walk with fewer warps, ceil(N / 32) K,
// than the card has SMs, each a long chain with nothing to hide it; the
// substitute's lane-group pass (16 lanes an env, a depth round at a time:
// tree_lanes.cuh) takes the shape instead. Else kb = min(KB_MAX, K, what
// 227 KB hold) right-hand sides a block, at least MIN_WARPS warps, and
// the dynamic shared memory. sms: the device's SM count.
struct Plan {
  bool lanes;
  int kb, warps;
  size_t bytes;
};

Plan half_plan(int nv, int E, int K, int N, int sms) {
  Plan pl;
  pl.lanes = (long long)((N + ENVS - 1) / ENVS) * K < sms;
  const size_t fixed = sizeof(float) * (size_t)E * ENVS +
                       sizeof(int) * (size_t)table_words(nv, E);
  const size_t per_rhs = sizeof(float) * (size_t)nv * ENVS;
  int k = (int)((SMEM_LIMIT - fixed) / per_rhs);
  k = k < KB_MAX ? k : KB_MAX;
  k = k < K ? k : K;
  pl.kb = k > 1 ? k : 1;
  pl.warps = pl.kb > MIN_WARPS ? pl.kb : MIN_WARPS;
  pl.bytes = fixed + per_rhs * pl.kb;
  return pl;
}

// Streaming multiprocessors of the current device (0 if it cannot be read:
// the thread kernel then takes every shape, with the same results).
int device_sms() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

template <bool UPWARD>
int half_solve(const int* table, int ints, int nv, int E, int Rd, int Rf,
               const float* H, const float* b, float* x, int K, int N,
               void* stream) {
  if (int err = check(ints, nv, E, Rd, Rf, N, K)) return err;
  if (N == 0 || K == 0) return (int)cudaSuccess;
  const Plan pl = half_plan(nv, E, K, N, device_sms());
  if (pl.lanes)
    return substitute<UPWARD ? UP : DOWN>(table, ints, nv, E, Rd, Rf, H,
                                          nullptr, b, x, K, N, stream);
  if (pl.bytes > STATIC_SMEM) {
    if (int err = (int)cudaFuncSetAttribute(
            tree_half_kernel<UPWARD>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.bytes))
      return err;
  }
  tree_half_kernel<UPWARD>
      <<<dim3((N + ENVS - 1) / ENVS, (K + pl.kb - 1) / pl.kb),
         dim3(ENVS, pl.warps), pl.bytes, (cudaStream_t)stream>>>(
          table, nv, E, H, b, x, K, N, pl.kb);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entries for ctypes, with csrc/tree_ltdl.cu's table and shape
// arguments. Each launches on `stream` and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a shape the kernels do not take).

// z = L^-T b for K right-hand sides.
extern "C" int tree_ltdl_upsolve_f32(const int* table, int ints, int nv,
                                     int E, int Rd, int Rf, const float* H,
                                     const float* b, float* z, int K, int N,
                                     void* stream) {
  return half_solve<true>(table, ints, nv, E, Rd, Rf, H, b, z, K, N,
                          stream);
}

// x = L^-1 z for K right-hand sides.
extern "C" int tree_ltdl_downsolve_f32(const int* table, int ints, int nv,
                                       int E, int Rd, int Rf, const float* H,
                                       const float* z, float* x, int K, int N,
                                       void* stream) {
  return half_solve<false>(table, ints, nv, E, Rd, Rf, H, z, x, K, N,
                           stream);
}

// The launch plan of a shape on the current device: the lane route,
// right-hand sides a block, warps a block and dynamic shared memory bytes
// of the thread kernel, for holding ops/tree_solve.py's half_plan to this
// one.
extern "C" void tree_half_plan(int nv, int E, int K, int N, int* lanes,
                               int* kb, int* warps, int* bytes) {
  const Plan pl = half_plan(nv, E, K, N, device_sms());
  *lanes = pl.lanes;
  *kb = pl.kb;
  *warps = pl.warps;
  *bytes = (int)pl.bytes;
}
