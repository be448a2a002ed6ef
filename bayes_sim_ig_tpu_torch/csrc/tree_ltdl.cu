// Branch-sparse L^T D L factor and substitute for Hopper (sm_90a),
// env-last layout.
//
// The CRBA mass matrix of a kinematic tree is nonzero only at the E
// ancestor pairs (k, i) of the dof tree (i an ancestor-or-self of k), and
// its L^T D L factor fills in only there. N independent systems, one per
// env; every buffer is contiguous float32 with the env index e fastest:
//
//     M, H (E, N):   pair p of env e          at M[p * N + e]
//     D (nv, N):     pivot of dof k            at D[k * N + e]
//     b, x (K, nv, N): rhs r, row k            at b[(r * nv + k) * N + e]
//
// Pairs are in ops/tree_solve.py's ancestor_pairs order: the pairs of dof
// k are rows off[k] .. off[k+1]-1, (k, k) first, then (k, chains[k][t]) at
// off[k] + 1 + t, chains[k] = [parent(k), parent(parent(k)), ...]. So the
// pair (chains[k][t], chains[k][s]), s >= t, is row off[chains[k][t]] +
// s - t. The whole tree structure is the int table [parent (nv), off
// (nv + 1)], built once per model on the host and cached on the device;
// each block stages it in shared memory. One build serves every tree.
//
// Entry points (plain C, bound with ctypes):
//     tree_ltdl_factor_f32      M -> H (L at off-diagonal pairs, raw
//                               pivots on the diagonal) and D
//     tree_ltdl_substitute_f32  x = L^-1 D^-1 L^-T b for K right-hand sides
//
// Replaces the jnp solver of bayes_sim_ig_tpu/ops/tree_solve.py (no Pallas
// original): ltdl_factor (:50) and its left-looking form ltdl_factor_ll
// (:76), and ltdl_substitute (:127). XLA fuses those per-pair graphs; in
// eager PyTorch each pair update is its own launch (~1,100 a step for the
// factor and substitute at Humanoid's 27 dofs), so the solve is one
// launch each here. The factor is the right-looking elimination of
// ltdl_factor, in its order of operations: dof k, from the leaves to the
// root, divides its pairs by its raw pivot and updates its ancestors'
// pairs. The left-looking form gives the same factor up to rounding.
//
// NaN policy (as ltdl_factor): a pivot that is not > 0, NaN included,
// is NaN in D, so that env's solution is NaN and the env step's
// non-finite quarantine resets it. Other envs are untouched: nothing is
// shared between threads but the table.
//
// What bounds it on an H100: at Humanoid's chains (nv = 27, E = 243,
// mean depth 8, max 14) the factor is 1,170 dependent multiply-adds per
// env and the substitute 2 x 216 plus 27 divides; at N = 4096 the whole
// batch moves ~4 MB each way. Latency bounds it, not FLOPs or bytes. The
// design is one thread per env, one warp a block, so N = 4096 spreads
// over 128 SMs: a warp's 32 threads read 32 consecutive floats of each
// pair row, one coalesced 128 B transaction. The factor stages its env's
// pair slab in shared memory (E x 32 floats a block, pair-major, so a
// warp's accesses hit 32 distinct banks) and eliminates there at
// shared-memory latency instead of L2's; the substitute keeps its
// working vector in shared memory and streams H and D from global memory
// once per pass, loads that do not depend on the recurrence. Measured on
// an H100 80GB HBM3 (700 W limit) at Humanoid's chains and N = 4096: the
// factor 0.057 ms and the substitute 0.038 ms of device time per call,
// against 0.38 and 0.98 ms for the plain PyTorch versions. Each factor
// update loads, multiply-adds and stores into the same shared array, so
// the compiler cannot start the next update's loads early: the 1,170
// updates run as shared-memory round trips, one warp per SM. Later work:
// unrolling per model (a kernel generated from the chains), parallel
// elimination of independent subtrees across the threads of one env, and
// fusion with the CRBA pair build. Full-precision division: this file
// must not be built with --use_fast_math.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BLOCK = 32;
constexpr int MAX_NV = 256;      // ops/tree_solve.py MAX_NV
constexpr int MAX_PAIRS = 1024;  // ops/tree_solve.py MAX_PAIRS
constexpr int STATIC_SMEM = 48 * 1024;

// Stages the [parent, off] table of nv dofs in shared memory.
__device__ void load_table(const int* __restrict__ table, int* tab, int nv) {
  for (int u = threadIdx.x; u < 2 * nv + 1; u += BLOCK) tab[u] = table[u];
  __syncthreads();
}

__global__ void __launch_bounds__(BLOCK)
tree_factor_kernel(const int* __restrict__ table, int nv, int E,
                   const float* __restrict__ M, float* __restrict__ H,
                   float* __restrict__ D, int N) {
  extern __shared__ float smem[];
  float* h = smem + threadIdx.x;  // h[p * BLOCK]: pair p of this env
  int* tab = reinterpret_cast<int*>(smem + (size_t)E * BLOCK);
  const int* parent = tab;
  const int* off = tab + nv;
  load_table(table, tab, nv);
  const int e = blockIdx.x * BLOCK + threadIdx.x;
  if (e >= N) return;
  for (int p = 0; p < E; ++p) h[p * BLOCK] = M[(size_t)p * N + e];
  for (int k = nv - 1; k >= 0; --k) {
    const int pk = off[k];
    const int dk = off[k + 1] - pk - 1;  // depth of k: its proper ancestors
    const float pivot = h[pk * BLOCK];
    float* __restrict__ src = h + (pk + 1) * BLOCK;  // (k, chains[k][s])
    int i = parent[k];
    for (int t = 0; t < dk; ++t) {
      // (i, chains[k][s]) for s >= t is row off[i] + s - t, a row of an
      // ancestor: it never aliases row k's pairs.
      float* __restrict__ tgt = h + off[i] * BLOCK;
      const float a = src[t * BLOCK] / pivot;
      for (int s = t; s < dk; ++s) tgt[(s - t) * BLOCK] -= a * src[s * BLOCK];
      src[t * BLOCK] = a;
      i = parent[i];
    }
  }
  for (int p = 0; p < E; ++p) H[(size_t)p * N + e] = h[p * BLOCK];
  for (int k = 0; k < nv; ++k) {
    const float d = h[off[k] * BLOCK];
    D[(size_t)k * N + e] = d > 0.0f ? d : CUDART_NAN_F;
  }
}

__global__ void __launch_bounds__(BLOCK)
tree_substitute_kernel(const int* __restrict__ table, int nv,
                       const float* __restrict__ H,
                       const float* __restrict__ D,
                       const float* __restrict__ b, float* __restrict__ x,
                       int N) {
  extern __shared__ float smem[];
  float* xs = smem + threadIdx.x;  // xs[k * BLOCK]: row k of this env
  int* tab = reinterpret_cast<int*>(smem + (size_t)nv * BLOCK);
  const int* parent = tab;
  const int* off = tab + nv;
  load_table(table, tab, nv);
  const int e = blockIdx.x * BLOCK + threadIdx.x;
  if (e >= N) return;
  const size_t rhs = (size_t)blockIdx.y * nv * N + e;
  const float* He = H + e;
  for (int k = 0; k < nv; ++k) xs[k * BLOCK] = b[rhs + (size_t)k * N];
  // z = L^-T b: each dof, leaf to root, pushes its row up its chain.
  for (int k = nv - 1; k >= 0; --k) {
    const int pk = off[k];
    const int dk = off[k + 1] - pk - 1;
    const float xk = xs[k * BLOCK];
    int i = parent[k];
    for (int t = 0; t < dk; ++t) {
      xs[i * BLOCK] -= He[(size_t)(pk + 1 + t) * N] * xk;
      i = parent[i];
    }
  }
  for (int k = 0; k < nv; ++k) xs[k * BLOCK] /= D[(size_t)k * N + e];
  // x = L^-1 z: each dof, root to leaf, pulls from its chain.
  for (int k = 0; k < nv; ++k) {
    const int pk = off[k];
    const int dk = off[k + 1] - pk - 1;
    float acc = xs[k * BLOCK];
    int i = parent[k];
    for (int t = 0; t < dk; ++t) {
      acc -= He[(size_t)(pk + 1 + t) * N] * xs[i * BLOCK];
      i = parent[i];
    }
    xs[k * BLOCK] = acc;
  }
  for (int k = 0; k < nv; ++k) x[rhs + (size_t)k * N] = xs[k * BLOCK];
}

int check(int nv, int E, int N, int K) {
  if (nv < 1 || nv > MAX_NV || E < nv || E > MAX_PAIRS || N < 0 || K < 0 ||
      K > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

// Dynamic shared memory of a launch: `floats` per-thread floats a block
// plus the table; above the 48 KB default the kernel must opt in.
template <class Kernel>
int smem_bytes(Kernel kernel, int floats, int nv, size_t* bytes) {
  *bytes = (size_t)floats * BLOCK * sizeof(float) + (2 * nv + 1) * sizeof(int);
  if (*bytes > STATIC_SMEM)
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
  return (int)cudaSuccess;
}

}  // namespace

// Plain C entries for ctypes. Each launches on `stream` and returns
// cudaGetLastError() (or cudaErrorInvalidValue for a shape the kernels do
// not take), so a refused launch is reported to the caller. `table` is the
// device int array [parent (nv), off (nv + 1)].
extern "C" int tree_ltdl_factor_f32(const int* table, int nv, int E,
                                    const float* M, float* H, float* D,
                                    int N, void* stream) {
  if (int err = check(nv, E, N, 1)) return err;
  if (N == 0) return (int)cudaSuccess;
  size_t bytes;
  if (int err = smem_bytes(tree_factor_kernel, E, nv, &bytes)) return err;
  tree_factor_kernel<<<(N + BLOCK - 1) / BLOCK, BLOCK, bytes,
                       (cudaStream_t)stream>>>(table, nv, E, M, H, D, N);
  return (int)cudaGetLastError();
}

extern "C" int tree_ltdl_substitute_f32(const int* table, int nv, int E,
                                        const float* H, const float* D,
                                        const float* b, float* x, int K,
                                        int N, void* stream) {
  if (int err = check(nv, E, N, K)) return err;
  if (N == 0 || K == 0) return (int)cudaSuccess;
  size_t bytes;
  if (int err = smem_bytes(tree_substitute_kernel, nv, nv, &bytes))
    return err;
  dim3 grid((N + BLOCK - 1) / BLOCK, K);
  tree_substitute_kernel<<<grid, BLOCK, bytes, (cudaStream_t)stream>>>(
      table, nv, H, D, b, x, N);
  return (int)cudaGetLastError();
}
