// Random-Fourier-feature projection for Hopper (sm_90a):
//
//     out[b, j]     = a * cos(sum_k x[b, k] * coeff[k, j])
//     out[b, m + j] = a * sin(sum_k x[b, k] * coeff[k, j])
//
// x (B, d), coeff (d, m) and out (B, 2m) are row-major float32.
//
// Replaces the Pallas TPU kernel bayes_sim_ig_tpu/ops/rff_kernel.py
// (rff_features_pallas, body _kernel): a matrix product followed by a
// cos/sin epilogue in the same pass, so the (B, m) inner product never
// goes to device memory.
//
// What bounds it on an H100: at the shapes of the MDRFF path (d = 302,
// m = 100, B = 1, 100, 200, 1000) one call is at most 60 MFLOP (under
// 2 us of float32 FMA) and under 1.5 MB of traffic (under 1 us), so
// neither FLOPs nor bytes bound it: latency does. A block that walks d in
// chunks of load, barrier and FMA chain pays one global-memory latency
// per chunk (ten at d = 302, ~13 us measured whatever B); a 32-row tile
// gives 4 to 16 blocks on 132 SMs at B <= 200 and computes 31 masked rows
// at B = 1. The design removes each of those costs:
//   - Split K across the block's 8 warps. Warp w sums its own slice of d
//     (40 of 302 at d = 302) over the block's whole tile, so the dependent
//     FMA chain per thread is ~40 deep, not d, and every warp has work at
//     any B. The 8 partial sums meet in shared memory, in a fixed order.
//   - Stage K with cp.async. A warp copies its slice of coeff and x into
//     its own ring of NSTAGE buffers of KS rows each (3 x 16 = 48 >= 40:
//     at d <= 384 the whole slice is in flight at once, in three groups,
//     and the FMAs on the first group overlap the loads of the rest;
//     larger d wraps the ring). Nothing but the final reduction needs a
//     block barrier: each warp reads only what its own lanes copied.
//   - Size the row tile to the batch: TB = 1, 8, 16 or 32 rows (four
//     instances of one template), the smallest whose grid fits in one
//     block per SM, picked by the C entry from B, m and the SM count;
//     row tiles on gridDim.x (no 65,535 bound on B), 32 frequencies on
//     gridDim.y. On 132 SMs at m = 100: B = 1 takes 4 blocks of 1 row,
//     B = 100 52 of 8, B = 200 100 of 8, B = 1000 128 of 32.
//   - Loads take the widest vector the pointers allow. coeff rows of
//     m = 100 floats are 16-B aligned (cp.async.cg, 16 B). x rows of
//     d = 302 floats are 1,208 B, a multiple of 8 but not of 16, and the
//     test split starts x at any row, so x takes 8-B (or 4-B) copies. The
//     width is picked from the pointer and the row length by the C entry.
//     TMA cannot take x: a tensor map's strides must be multiples of 16 B,
//     and this kernel makes no padding copy.
//   - Plain float32 FMA on the CUDA cores. TF32 keeps 10 mantissa bits:
//     on phases of tens to hundreds of radians its cos/sin errors are far
//     above the kernel's tolerance (rtol 2e-4, atol 1e-5). 3xTF32 on
//     mma.sync would keep float32 accuracy at three times the MMA work, on
//     a product whose bound is latency, not FLOPs.
// The epilogue uses full-precision sincosf (this file must not be built
// with --use_fast_math): observations are clipped at 100, so arguments
// are far outside the range where __sinf/__cosf are accurate. Stores of
// the cos half and of the sin half are coalesced along the frequencies.
//
// Measured on an H100 80GB HBM3 at its 700 W limit (profiler device time
// per call, d = 302, m = 100): 2.6, 3.8, 3.8 and 7.7 us at B = 1, 100,
// 200 and 1000, against 10.2-16.6 us for the plain PyTorch version. The
// same launch with d = 0 (no loads, no FMAs) takes 1.3-1.5 us at B <= 200
// and 2.2 us at B = 1000: the rest at B <= 200 (1.4-2.3 us) is one round
// of cp.async loads from L2 and the ~40-deep FMA chain. At B = 1000 the 32-row tile's FMA loop bounds it
// (5.4 us above the floor for ~2 us of FMA issue): 32 accumulators a
// thread take 182 registers, so one block (8 warps) runs per SM, and 2
// warps a scheduler are likely too few to hide the shared-memory latency
// between the broadcast x loads and their FMAs (inferred; no per-stall
// counters were read).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 8;   // K slices per block, one per warp
constexpr int TILE_M = 32;  // frequencies per block, one per lane
constexpr int KS = 16;      // k rows per cp.async group
constexpr int NSTAGE = 3;   // groups a warp keeps in flight
constexpr int K_ALIGN = 4;  // a warp's slice starts on a multiple of this

template <int TB>
struct Tile {
  static constexpr int kStage = KS * TILE_M + TB * KS;  // floats
  static constexpr int kWarp = NSTAGE * kStage;         // floats
  static constexpr int kSmemBytes = sizeof(float) * NWARPS * kWarp;
  // A warp's partial sums reuse its own ring once its loads are done.
  static_assert(TB * TILE_M <= kWarp, "partials must fit in the ring");
  static_assert(kSmemBytes <= 227 * 1024, "shared memory of one block");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies V floats from global to shared memory; with valid false it reads
// nothing and fills the destination with zeros.
template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid) {
  const int n = valid ? 4 * V : 0;
  if constexpr (V == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(4 * V), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// coeff[k0:k0+KS, col0:col0+TILE_M] -> cs[KS][TILE_M]; rows at or past
// k_end and columns at or past m read as zeros.
template <int V>
__device__ __forceinline__ void stage_coeff(float* cs, const float* coeff,
                                            int m, int col0, int k0,
                                            int k_end, int lane) {
  constexpr int PER_ROW = TILE_M / V;
  constexpr int N = KS * PER_ROW;
#pragma unroll
  for (int i0 = 0; i0 < N; i0 += 32) {
    const int i = i0 + lane;
    if (N % 32 != 0 && i >= N) break;
    const int kk = i / PER_ROW, j = (i % PER_ROW) * V;
    const int k = k0 + kk, c = col0 + j;
    const bool ok = k < k_end && c < m;
    cp_async<V>(cs + kk * TILE_M + j, ok ? coeff + (size_t)k * m + c : coeff,
                ok);
  }
}

// x[row0:row0+TB, k0:k0+KS] -> xs[TB][KS]; rows at or past B and columns
// at or past k_end read as zeros.
template <int TB, int V>
__device__ __forceinline__ void stage_x(float* xs, const float* x, int B,
                                        int d, int row0, int k0, int k_end,
                                        int lane) {
  constexpr int PER_ROW = KS / V;
  constexpr int N = TB * PER_ROW;
#pragma unroll
  for (int i0 = 0; i0 < N; i0 += 32) {
    const int i = i0 + lane;
    if (N % 32 != 0 && i >= N) break;
    const int r = i / PER_ROW, kk = (i % PER_ROW) * V;
    const int gr = row0 + r, k = k0 + kk;
    const bool ok = gr < B && k < k_end;
    cp_async<V>(xs + r * KS + kk, ok ? x + (size_t)gr * d + k : x, ok);
  }
}

// Issues one stage (KS rows of K) of a warp's slice. vx and vc, the
// vector widths in floats, are the same for every thread of the grid.
template <int TB>
__device__ __forceinline__ void stage(float* buf, const float* x,
                                      const float* coeff, int B, int d,
                                      int m, int row0, int col0, int k0,
                                      int k_end, int vx, int vc, int lane) {
  float* cs = buf;
  float* xs = buf + KS * TILE_M;
  if (vc == 4) {
    stage_coeff<4>(cs, coeff, m, col0, k0, k_end, lane);
  } else if (vc == 2) {
    stage_coeff<2>(cs, coeff, m, col0, k0, k_end, lane);
  } else {
    stage_coeff<1>(cs, coeff, m, col0, k0, k_end, lane);
  }
  if (vx == 4) {
    stage_x<TB, 4>(xs, x, B, d, row0, k0, k_end, lane);
  } else if (vx == 2) {
    stage_x<TB, 2>(xs, x, B, d, row0, k0, k_end, lane);
  } else {
    stage_x<TB, 1>(xs, x, B, d, row0, k0, k_end, lane);
  }
}

// acc[r] += sum_kk xs[r][kk] * cs[kk][lane] over one stage, in k order.
template <int TB>
__device__ __forceinline__ void fma_stage(const float* buf, int lane,
                                          float (&acc)[TB]) {
  const float* cs = buf;
  const float* xs = buf + KS * TILE_M;
#pragma unroll
  for (int k = 0; k < KS; k += 4) {
    const float c0 = cs[(k + 0) * TILE_M + lane];
    const float c1 = cs[(k + 1) * TILE_M + lane];
    const float c2 = cs[(k + 2) * TILE_M + lane];
    const float c3 = cs[(k + 3) * TILE_M + lane];
#pragma unroll
    for (int r = 0; r < TB; ++r) {
      // Every lane reads the same 16 B: a broadcast.
      const float4 xv = *reinterpret_cast<const float4*>(xs + r * KS + k);
      acc[r] = fmaf(xv.x, c0, acc[r]);
      acc[r] = fmaf(xv.y, c1, acc[r]);
      acc[r] = fmaf(xv.z, c2, acc[r]);
      acc[r] = fmaf(xv.w, c3, acc[r]);
    }
  }
}

// A block computes rows [row0, row0 + TB) by frequencies
// [col0, col0 + TILE_M); warp w sums k in [w kw, (w + 1) kw).
template <int TB>
__global__ void __launch_bounds__(NWARPS * 32)
rff_features_kernel(const float* __restrict__ x,
                    const float* __restrict__ coeff,
                    float* __restrict__ out, int B, int d, int m, int kw,
                    int vx, int vc, float a) {
  extern __shared__ __align__(16) float smem[];
  using T = Tile<TB>;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * TB;
  const int col0 = blockIdx.y * TILE_M;
  float* ring = smem + warp * T::kWarp;
  const int k_lo = min(d, warp * kw);
  const int k_hi = min(d, k_lo + kw);
  const int nchunks = (k_hi - k_lo + KS - 1) / KS;

  float acc[TB];
#pragma unroll
  for (int r = 0; r < TB; ++r) acc[r] = 0.0f;

  // Fill the ring, one commit group per stage (empty groups keep the
  // count uniform for cp.async.wait_group).
#pragma unroll
  for (int s = 0; s < NSTAGE; ++s) {
    if (s < nchunks) {
      stage<TB>(ring + s * T::kStage, x, coeff, B, d, m, row0, col0,
                k_lo + s * KS, k_hi, vx, vc, lane);
    }
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<NSTAGE - 1>();  // this lane's copies of stage c landed
    __syncwarp();                 // and every other lane's
    float* buf = ring + (c % NSTAGE) * T::kStage;
    fma_stage<TB>(buf, lane, acc);
    __syncwarp();  // all lanes done reading buf before it is refilled
    if (c + NSTAGE < nchunks) {
      stage<TB>(buf, x, coeff, B, d, m, row0, col0,
                k_lo + (c + NSTAGE) * KS, k_hi, vx, vc, lane);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncwarp();

  // Partial sums into the warp's own ring, then one barrier, then each
  // output sums the NWARPS partials in warp order.
#pragma unroll
  for (int r = 0; r < TB; ++r) ring[r * TILE_M + lane] = acc[r];
  __syncthreads();
  for (int o = threadIdx.x; o < TB * TILE_M; o += NWARPS * 32) {
    const int gr = row0 + o / TILE_M;
    const int col = col0 + o % TILE_M;
    if (gr >= B || col >= m) continue;
    float inner = 0.0f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) inner += smem[w * T::kWarp + o];
    float s, c;
    sincosf(inner, &s, &c);
    float* orow = out + (size_t)gr * (2 * m);
    orow[col] = a * c;
    orow[m + col] = a * s;
  }
}

// Widest copy, in floats, that keeps every row of a row-major array with
// rows of `len` floats at `ptr` aligned.
int vector_width(const void* ptr, int len) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(ptr);
  if (len % 4 == 0 && p % 16 == 0) return 4;
  if (len % 2 == 0 && p % 8 == 0) return 2;
  return 1;
}

template <int TB>
int launch(const float* x, const float* coeff, float* out, int B, int d,
           int m, float a, cudaStream_t stream) {
  const auto kernel = rff_features_kernel<TB>;
  const int smem = Tile<TB>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int per_warp = (d + NWARPS - 1) / NWARPS;
  const int kw = (per_warp + K_ALIGN - 1) / K_ALIGN * K_ALIGN;
  dim3 grid((B + TB - 1) / TB, (m + TILE_M - 1) / TILE_M);
  kernel<<<grid, NWARPS * 32, smem, stream>>>(
      x, coeff, out, B, d, m, kw, vector_width(x, d),
      vector_width(coeff, m), a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. Launches on `stream` and returns the first
// CUDA error (cudaGetLastError() after the launch), so a refused launch is
// reported to the caller. x and coeff must be at least 4-B aligned.
//
// The row tile is the smallest whose grid is at most one block per SM:
// on an H100 each tile's time is flat up to that grid and steps up past
// it, and a smaller tile is faster while it fits (1, 8, 16 and 32 rows:
// 2.7, 3.7, 4.8 and 7.4 us at d = 302, m = 100). Past 32 rows per block
// at one block per SM, the largest tile takes the extra waves.
extern "C" int rff_features_f32(const float* x, const float* coeff,
                                float* out, int B, int d, int m, float a,
                                void* stream) {
  if (B <= 0 || m <= 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return (int)err;
  const long long row_tiles = (long long)sms / ((m + TILE_M - 1) / TILE_M);
  if (B <= row_tiles) return launch<1>(x, coeff, out, B, d, m, a, s);
  if (B <= 8 * row_tiles) return launch<8>(x, coeff, out, B, d, m, a, s);
  if (B <= 16 * row_tiles) return launch<16>(x, coeff, out, B, d, m, a, s);
  return launch<32>(x, coeff, out, B, d, m, a, s);
}
