// What csrc/tree_ltdl.cu and csrc/tree_half.cu share: the table's layout,
// the staging helpers, and the lane-group pass kernel of the substitute
// (G = 16 lanes an env, 16 envs a block of 256 threads). See the head of
// csrc/tree_ltdl.cu for the layout and the design.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int G = 16;            // lanes an env (ops/tree_solve.py GROUP)
constexpr int T = THREADS / G;   // envs a block
constexpr int MAX_NV = 256;      // ops/tree_solve.py MAX_NV
constexpr int MAX_PAIRS = 1024;  // ops/tree_solve.py MAX_PAIRS
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
