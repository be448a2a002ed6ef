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
// s - t. The whole tree structure is one int table, built once per model
// on the host (ops/tree_solve.py, kernel_table) and cached on the device:
//
//     off (nv + 1) | anc (E) | down (Rd x G) | head (Rf) |
//     slot (Rf x G) | begin (nv + 1) | contrib
//
//   anc[p]      the ancestor i of pair p = (k, i);
//   down        the back pass's rounds: G dofs (or -1) a round, dofs by
//               depth from the root, so a round needs only earlier rounds;
//   begin, contrib  for each dof i, the pair rows of (c, i) for its
//               descendants c in descending c, padded to a multiple of
//               BATCH with the row E (a zero term);
//   head, slot  the factor's rounds: tasks i | q << 8 (pair q of dof i:
//               (i, i) for q = 0, (i, chains[i][q - 1]) after), dofs by
//               height, G a round, -1 for an idle lane; head flags a
//               height's FIRST and LAST round.
// One build serves every tree up to 256 dofs and 1,024 pairs.
//
// Entry points (plain C, bound with ctypes):
//     tree_ltdl_factor_f32      M -> H (L at off-diagonal pairs, raw
//                               pivots on the diagonal) and D
//     tree_ltdl_substitute_f32  x = L^-1 D^-1 L^-T b for K right-hand sides
//     tree_ltdl_upsolve_f32     z = L^-T b for K right-hand sides
//     tree_ltdl_downsolve_f32   x = L^-1 z for K right-hand sides
// The last three are one kernel with a pass mask (UP, SCALE, DOWN): the
// half-solves are its up and its down pass alone. The contact impulse
// pass (physics/contact.py) up-solves its Jacobian rows once per control
// step and down-solves one vector per substep; an up-solve on rows that
// are zero outside an ancestor-closed dof set leaves them zero there, so
// the full pass serves every closure at once.
//
// Replaces the jnp solver of bayes_sim_ig_tpu/ops/tree_solve.py (no Pallas
// original): ltdl_factor (:50) and its left-looking form ltdl_factor_ll
// (:76), ltdl_substitute (:127), ltdl_upsolve (:146) and ltdl_downsolve
// (:163). XLA fuses those per-pair graphs; in
// eager PyTorch each pair update is its own launch (~1,100 a step for the
// factor and substitute at Humanoid's 27 dofs), so the solve is one
// launch each here. The factor is the right-looking elimination of
// ltdl_factor: dof k, from the leaves to the root, divides its pairs by
// its raw pivot and updates its ancestors' pairs; every pair receives its
// updates in that order. The left-looking form gives the same factor up
// to rounding.
//
// NaN policy (as ltdl_factor): a pivot that is not > 0, NaN included,
// is NaN in D, so that env's solution is NaN and the env step's
// non-finite quarantine resets it. Other envs are untouched: lanes of
// different envs share nothing but the table.
//
// What bounds it on an H100: at Humanoid's chains (nv = 27, E = 243,
// mean depth 8, max 14) and N = 4096 the factor moves 8.4 MB (2.5 us at
// 3.35 TB/s) and the substitute 4.9 MB (1.5 us), for 1,170 and 2 x 216
// multiply-adds per env: the dependent chains bound it, not FLOPs or
// bytes. The first design ran each env's whole chain in one thread, with
// one warp per SM at N = 4096: 1,170 shared-memory round trips for the
// factor, 432 global loads inside the substitute's chain. This design
// gives each env a group of G = 16 lanes, two envs a warp, in blocks of
// 256 threads (a full warp an env measured slower for both kernels at
// Humanoid's 4096 envs):
//   - Both kernels stage their block's envs' slabs, and the table, in
//     shared memory with 4-B cp.async copies: consecutive threads on
//     consecutive envs of one pair row (coalesced), each env's slab 16
//     banks from the next so that the two envs of a warp fall on distinct
//     banks. No global load sits after the staging (a schedule read from
//     global memory measured slower: each round waited on it).
//   - Factor: the right-looking elimination gives pair (i, j) the final
//     value M(i, j) - sum_c a_c[t] h_c[t + q] over the descendants c of i
//     in descending c (a_c = c's pairs over c's pivot); each term is
//     final once c's subtree is. So the pairs of all dofs of one height
//     are independent tasks, one a lane; a lane subtracts its terms in the
//     serial order, BATCH loads at a time, then the height's multipliers
//     are divided out. Every pair receives the same fused multiply-adds in
//     the same order as in the first design: the factor is bit for bit
//     that design's. Each dof's terms are padded on the host to a multiple
//     of BATCH with a zero term, so the batches need no predicates. 24
//     rounds at Humanoid's tree instead of 1,170 serial updates (86 rounds
//     of one update a lane measured no faster).
//   - Substitute, up pass (z = L^-T b): dof k, leaf to root, pushes its
//     value to its chain, one ancestor a lane, the next dof's entries
//     loaded before the barrier; every row receives its updates in the
//     first design's order (pulling by height measured slower).
//   - Substitute, back pass (x = L^-1 z): dofs at one depth depend only on
//     shallower ones, so a round takes up to G dofs of one depth, each
//     lane pulling from its chain in the first design's order.
// Measured on an H100 80GB HBM3 at its 700.00 W limit (kernel_ab.py:
// profiler device time per call, Humanoid's tree, N = 4096): factor
// 19.9 us (first design 56.3), substitute 13.0 us (38.4). The factor's
// staging and stores alone (one empty round) take 5.3 us. Its 24 rounds
// count ~7,000 cycles of dependent loads, multiply-adds and divides per
// warp, under the ~14.5 us they take; no per-stall counters could be read
// on that machine, so what holds them is not located.
// Full-precision division: this file must not be built with
// --use_fast_math.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int G = 16;            // lanes an env (ops/tree_solve.py GROUP)
constexpr int T = THREADS / G;   // envs a block
constexpr int MAX_NV = 256;      // ops/tree_solve.py MAX_NV
constexpr int MAX_PAIRS = 1024;  // ops/tree_solve.py MAX_PAIRS
// Flags of a factor round's head (ops/tree_solve.py _FIRST_ROUND,
// _LAST_ROUND): a height's first and last round.
constexpr int FIRST = 1 << 17;
constexpr int LAST = 1 << 16;
constexpr int BATCH = 8;  // terms a lane loads at once (ops/tree_solve.py)
// Passes of the substitute kernel: z = L^-T b, z /= D, x = L^-1 z.
constexpr int UP = 1, SCALE = 2, DOWN = 4;
constexpr int STATIC_SMEM = 48 * 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4-B global -> shared copy; with valid false it reads nothing and
// writes 0.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Copies `rows` rows of the env-last array src (row q of env e at
// q * N + e) for the block's envs e0 .. e0 + T - 1 to env t's slab at
// dst + t * es + q. Envs at or past N read 0.
__device__ __forceinline__ void stage_rows(float* dst, int es,
                                           const float* __restrict__ src,
                                           int rows, int N, int e0) {
  for (int u = threadIdx.x; u < rows * T; u += THREADS) {
    const int t = u % T, q = u / T;
    const bool ok = e0 + t < N;
    cp_async4(dst + t * es + q, ok ? src + (size_t)q * N + e0 + t : src, ok);
  }
}

// The first `ints` of the table, staged in shared memory: every warp of
// the block walks the same schedule, and from shared memory its entries
// cost no global round trip inside the dependent chains.
__device__ __forceinline__ void stage_table(int* dst,
                                            const int* __restrict__ table,
                                            int ints) {
  for (int u = threadIdx.x; u < ints; u += THREADS)
    cp_async4(dst + u, table + u, true);
}

// Floats between two envs' slabs: at least `floats`, and 16 banks apart,
// so that the two envs of a warp (G = 16), each on a run of consecutive
// pairs, fall on distinct banks.
__host__ __device__ inline int slab_stride(int floats) {
  return ((floats + 15) & ~31) + 16;
}

// The table's parts (see the head of this file).
struct Table {
  const int *off, *anc, *down, *head, *slot, *begin, *contrib;
  __device__ Table(const int* t, int nv, int E, int Rd, int Rf)
      : off(t),
        anc(t + nv + 1),
        down(anc + E),
        head(down + Rd * G),
        slot(head + Rf),
        begin(slot + Rf * G),
        contrib(begin + nv + 1) {}
};

__global__ void __launch_bounds__(THREADS)
tree_factor_kernel(const int* __restrict__ table, int ints, int nv, int E,
                   int Rd, int Rf, const float* __restrict__ M,
                   float* __restrict__ H, float* __restrict__ D, int N) {
  extern __shared__ float smem[];
  // An env's slab: raw pairs h (E), nv zeros, multipliers a (E) and a
  // zero: the padding row E reads a[E] = 0 and h[E + q] = 0.
  const int es = slab_stride(2 * E + nv + 1);
  int* tab = reinterpret_cast<int*>(smem + T * es);
  const Table tb(tab, nv, E, Rd, Rf);
  const int e0 = blockIdx.x * T;
  stage_rows(smem, es, M, E, N, e0);
  stage_table(tab, table, ints);
  const int lane = threadIdx.x % G;
  float* h = smem + (threadIdx.x / G) * es;
  float* a = h + E + nv;
  for (int j = lane; j <= nv; j += G) (j < nv ? h[E + j] : a[E]) = 0.0f;
  cp_async_wait_all();
  __syncthreads();
  int first = 0;
  for (int r = 0; r < Rf; ++r) {
    const int hd = tb.head[r];
    if (hd & FIRST) first = r;
    const int task = tb.slot[r * G + lane];
    if (task >= 0) {  // pair q of dof i: its right-looking sum
      const int i = task & 255, q = task >> 8, p = tb.off[i] + q;
      const float* hq = h + q;
      float acc = h[p];
      for (int j = tb.begin[i]; j < tb.begin[i + 1]; j += BATCH) {
        float x[BATCH], y[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          const int row = tb.contrib[j + u];
          x[u] = a[row];
          y[u] = hq[row];
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u) acc = fmaf(-x[u], y[u], acc);
      }
      h[p] = acc;
    }
    if (hd & LAST) {  // the height is done: its multipliers
      __syncwarp();
      for (int r2 = first; r2 <= r; ++r2) {
        const int t2 = tb.slot[r2 * G + lane];
        if (t2 >= 256) {  // q >= 1
          const int pi = tb.off[t2 & 255];
          a[pi + (t2 >> 8)] = h[pi + (t2 >> 8)] / h[pi];
        }
      }
      __syncwarp();
    }
  }
  for (int k = lane; k < nv; k += G) a[tb.off[k]] = h[tb.off[k]];
  __syncthreads();
  for (int v = threadIdx.x; v < E * T; v += THREADS) {
    const int t = v % T, p = v / T;
    if (e0 + t < N) H[(size_t)p * N + e0 + t] = smem[t * es + E + nv + p];
  }
  for (int v = threadIdx.x; v < nv * T; v += THREADS) {
    const int t = v % T, k = v / T;
    if (e0 + t < N) {
      const float d = smem[t * es + tb.off[k]];
      D[(size_t)k * N + e0 + t] = d > 0.0f ? d : CUDART_NAN_F;
    }
  }
}

// z = L^-T b in place on env slab xs: each dof, leaf to root, pushes its
// row up its chain, one ancestor a lane. A lane's first ancestor and
// factor entry of the next dof are loaded before the barrier that ends
// this one (the table and H do not change).
__device__ __forceinline__ void up_pass(const Table& tb, const float* h,
                                        float* xs, int nv, int lane) {
  int pk = tb.off[nv - 1], pk_end = tb.off[nv];
  int i = lane < pk_end - pk - 1 ? tb.anc[pk + 1 + lane] : 0;
  float l = lane < pk_end - pk - 1 ? h[pk + 1 + lane] : 0.0f;
  for (int k = nv - 1; k >= 0; --k) {
    const int dk = pk_end - pk - 1;
    const int next_pk = k > 0 ? tb.off[k - 1] : 0;
    const int next_dk = pk - next_pk - 1;
    const int next_i = lane < next_dk ? tb.anc[next_pk + 1 + lane] : 0;
    const float next_l = lane < next_dk ? h[next_pk + 1 + lane] : 0.0f;
    if (dk > 0) {
      const float xk = xs[k];
      if (lane < dk) xs[i] = fmaf(-l, xk, xs[i]);
      for (int j = lane + G; j < dk; j += G) {
        const int ij = tb.anc[pk + 1 + j];
        xs[ij] = fmaf(-h[pk + 1 + j], xk, xs[ij]);
      }
      __syncwarp();
    }
    pk_end = pk;
    pk = next_pk;
    i = next_i;
    l = next_l;
  }
}

// x = L^-1 z in place on env slab xs, depth by depth from the root:
// each lane's dof subtracts its chain's terms, leaf to root.
__device__ __forceinline__ void down_pass(const Table& tb, const float* h,
                                          float* xs, int Rd, int lane) {
  for (int r = 0; r < Rd; ++r) {
    const int k = tb.down[r * G + lane];
    if (k >= 0) {  // BATCH terms at a time, so that their loads overlap;
      // terms past the chain are fma(-0, 0, acc), which leaves acc as is
      float acc = xs[k];
      for (int p = tb.off[k] + 1; p < tb.off[k + 1]; p += BATCH) {
        float l[BATCH], xi[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          const bool in = p + u < tb.off[k + 1];
          l[u] = in ? h[p + u] : 0.0f;
          xi[u] = in ? xs[tb.anc[p + u]] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u) acc = fmaf(-l[u], xi[u], acc);
      }
      xs[k] = acc;
    }
    __syncwarp();
  }
}

// The passes in PASSES, in the order up, scale, down; D is read only with
// SCALE. All three are the substitute; UP alone and DOWN alone the
// half-solves. A pass left out costs nothing: each is compiled only into
// the instances that run it.
template <int PASSES>
__global__ void __launch_bounds__(THREADS)
tree_substitute_kernel(const int* __restrict__ table, int nv, int E, int Rd,
                       const float* __restrict__ H,
                       const float* __restrict__ D,
                       const float* __restrict__ b, float* __restrict__ x,
                       int N) {
  extern __shared__ float smem[];
  const int es = slab_stride(E + 2 * nv);  // H (E), D (nv), x (nv)
  int* tab = reinterpret_cast<int*>(smem + T * es);
  const Table tb(tab, nv, E, Rd, 0);
  const int e0 = blockIdx.x * T;
  const size_t rhs = (size_t)blockIdx.y * nv * N;
  stage_rows(smem, es, H, E, N, e0);
  if (PASSES & SCALE) stage_rows(smem + E, es, D, nv, N, e0);
  stage_rows(smem + E + nv, es, b + rhs, nv, N, e0);
  stage_table(tab, table, nv + 1 + E + Rd * G);
  cp_async_wait_all();
  __syncthreads();
  const int lane = threadIdx.x % G;
  float* env = smem + (threadIdx.x / G) * es;
  const float* h = env;
  const float* dd = env + E;
  float* xs = env + E + nv;
  if (PASSES & UP) up_pass(tb, h, xs, nv, lane);
  if (PASSES & SCALE) {
    for (int k = lane; k < nv; k += G) xs[k] /= dd[k];
    __syncwarp();
  }
  if (PASSES & DOWN) down_pass(tb, h, xs, Rd, lane);
  __syncthreads();
  for (int v = threadIdx.x; v < nv * T; v += THREADS) {
    const int t = v % T, q = v / T;
    if (e0 + t < N)
      x[rhs + (size_t)q * N + e0 + t] = smem[t * es + E + nv + q];
  }
}

int check(int ints, int nv, int E, int Rd, int Rf, int N, int K) {
  if (nv < 1 || nv > MAX_NV || E < nv || E > MAX_PAIRS || Rd < 1 ||
      Rf < 1 || N < 0 || K < 0 || K > 65535 ||
      ints < 2 * (nv + 1) + E + Rd * G + Rf * (G + 1))
    return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

// Dynamic shared memory of a launch: T slabs of `floats` and `ints` of the
// table; above the 48 KB default the kernel must opt in.
template <class Kernel>
int smem_bytes(Kernel kernel, int floats, int ints, size_t* bytes) {
  *bytes = sizeof(float) * (size_t)T * slab_stride(floats) +
           sizeof(int) * ints;
  if (*bytes > STATIC_SMEM)
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
  return (int)cudaSuccess;
}

}  // namespace

// Plain C entries for ctypes. Each launches on `stream` and returns
// cudaGetLastError() (or cudaErrorInvalidValue for a shape the kernels do
// not take), so a refused launch is reported to the caller. `table` is the
// device int array described above (`ints` long), with Rd back-pass and
// Rf factor rounds.
extern "C" int tree_ltdl_factor_f32(const int* table, int ints, int nv,
                                    int E, int Rd, int Rf, const float* M,
                                    float* H, float* D, int N,
                                    void* stream) {
  if (int err = check(ints, nv, E, Rd, Rf, N, 1)) return err;
  if (N == 0) return (int)cudaSuccess;
  size_t bytes;
  if (int err = smem_bytes(tree_factor_kernel, 2 * E + nv + 1, ints, &bytes))
    return err;
  tree_factor_kernel<<<(N + T - 1) / T, THREADS, bytes,
                       (cudaStream_t)stream>>>(table, ints, nv, E, Rd, Rf, M,
                                               H, D, N);
  return (int)cudaGetLastError();
}

namespace {

template <int PASSES>
int substitute(const int* table, int ints, int nv, int E, int Rd, int Rf,
               const float* H, const float* D, const float* b, float* x,
               int K, int N, void* stream) {
  if (int err = check(ints, nv, E, Rd, Rf, N, K)) return err;
  if (N == 0 || K == 0) return (int)cudaSuccess;
  size_t bytes;
  if (int err = smem_bytes(tree_substitute_kernel<PASSES>, E + 2 * nv,
                           nv + 1 + E + Rd * G, &bytes))
    return err;
  tree_substitute_kernel<PASSES>
      <<<dim3((N + T - 1) / T, K), THREADS, bytes, (cudaStream_t)stream>>>(
          table, nv, E, Rd, H, D, b, x, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tree_ltdl_substitute_f32(const int* table, int ints, int nv,
                                        int E, int Rd, int Rf,
                                        const float* H, const float* D,
                                        const float* b, float* x, int K,
                                        int N, void* stream) {
  return substitute<UP | SCALE | DOWN>(table, ints, nv, E, Rd, Rf, H, D, b,
                                       x, K, N, stream);
}

// z = L^-T b: the substitute's up pass alone (D is not read).
extern "C" int tree_ltdl_upsolve_f32(const int* table, int ints, int nv,
                                     int E, int Rd, int Rf, const float* H,
                                     const float* b, float* z, int K, int N,
                                     void* stream) {
  return substitute<UP>(table, ints, nv, E, Rd, Rf, H, nullptr, b, z, K, N,
                        stream);
}

// x = L^-1 z: the substitute's down pass alone (D is not read).
extern "C" int tree_ltdl_downsolve_f32(const int* table, int ints, int nv,
                                       int E, int Rd, int Rf, const float* H,
                                       const float* z, float* x, int K, int N,
                                       void* stream) {
  return substitute<DOWN>(table, ints, nv, E, Rd, Rf, H, nullptr, z, x, K, N,
                          stream);
}
