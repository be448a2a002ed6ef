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
// The substitute's kernel, its passes and the staging helpers are in
// csrc/tree_lanes.cuh, which csrc/tree_half.cu shares: the half-solves
// L^-T and L^-1 that the contact impulse pass takes are a kernel of their
// own there (one thread per env and right-hand side), and the
// substitute's up or down pass alone where that kernel would leave the
// card idle.
//
// Replaces the jnp solver of bayes_sim_ig_tpu/ops/tree_solve.py (no Pallas
// original): ltdl_factor (:50) and its left-looking form ltdl_factor_ll
// (:76) and ltdl_substitute (:127). XLA fuses those per-pair graphs; in
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

#include <math_constants.h>

#include "tree_lanes.cuh"

namespace {

// Flags of a factor round's head (ops/tree_solve.py _FIRST_ROUND,
// _LAST_ROUND): a height's first and last round.
constexpr int FIRST = 1 << 17;
constexpr int LAST = 1 << 16;

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

extern "C" int tree_ltdl_substitute_f32(const int* table, int ints, int nv,
                                        int E, int Rd, int Rf,
                                        const float* H, const float* D,
                                        const float* b, float* x, int K,
                                        int N, void* stream) {
  return substitute<UP | SCALE | DOWN>(table, ints, nv, E, Rd, Rf, H, D, b,
                                       x, K, N, stream);
}
