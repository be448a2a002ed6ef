// One physics substep's integration for Hopper (sm_90a): semi-implicit
// Euler with the velocity caps, then the joint-limit clamp, for every env
// in one launch.
//
// Every buffer is contiguous float32, env-first, as the tasks hold their
// state:
//
//     q, q_out   (N, nq)   generalized positions (free joints: pos, quat)
//     v, v_out   (N, nv)   velocities (free joints: w, vl in body frame)
//     qdd        (N, nv)   the substep's accelerations
//
// and the model's tables, built once per model and device
// (physics/dynamics.py::_structure):
//
//     table  int32 (n_free + n_j1, 2)  (q offset, v offset) of each free
//                                      joint, then of each 1-dof joint
//     limits float (n_j1, 3)           each 1-dof joint's max_velocity,
//                                      lower and upper limit
//
// and the rigid-body velocity caps max_lin, max_ang (dynamics.py
// MAX_LIN_VEL, MAX_ANG_VEL) as arguments.
//
// Entry point (plain C, bound with ctypes): integrate_clamp_f32.
//
// Replaces no TPU kernel: it replaces the plain PyTorch chain of
// physics/dynamics.py::integrate followed by clamp_limits (the JAX
// package's dynamics.py of the same names, which XLA fuses), about 187
// small launches a substep on the card, two substeps an env step, in
// every articulated task. That chain is its plain version: CPU tensors
// take it, and the card's tests hold the kernel to it.
//
// The arithmetic is the chain's as PyTorch 2.11's kernels round it on the
// card, operation by operation in the same order: each product, sum and
// quotient rounded on its own (__fmul_rn, __fadd_rn, __fdiv_rn), but for
// the one multiply-add that PyTorch's cross product fuses; the sums over a
// 3-vector's rows left to right and over a quaternion's in pairs, as
// PyTorch's reductions order them for the chain's layouts; vmax / |x| as
// the reciprocal times vmax, as the tensor code's scalar division
// computes it. So its result is the chain's bit for bit on an H100
// (chip_smoke.py; tests/test_torch_integrate_kernel.py), and a step stays
// that of the plain reference the benchmark holds it to: a last bit off
// can flip an env's contact or reward term (an unfused cross product
// moved one Anymal env's reward by 5.7 %).
//
// What bounds it on an H100: bytes. An env reads nq + 2 nv floats and
// writes nq + nv (ShadowHand at 10,000 envs: 6.1 MB, 1.8 us at 3.35 TB/s);
// a free body is 273 FLOPs and a 1-dof joint 4 (ops/bounds.py). The chain
// it replaces is bound by its launches' latency. This design:
//   - gives each block 32 envs; the block stages their rows of q, v and
//     qdd into shared memory as the contiguous spans they are (coalesced),
//     updates the tile in place and writes it back the same way, so a
//     column that no joint owns passes through unchanged;
//   - gives warp w of the block's 8 the items w, w + 8, ... (free bodies
//     first, then 1-dof joints), lane l its block's env l: a warp runs one
//     path for 32 envs, and one free body's ~270 dependent operations stay
//     in one thread's registers;
//   - needs nothing but the launch: no allocation, no host sync, so it is
//     captured in the step graphs as it is.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ENVS = 32;    // envs a block: one env a lane
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
// A block's rows fit the 48 KB of dynamic shared memory a launch gets
// without opting in: nq + 2 nv <= 384 (ShadowHand's 91).
constexpr int SMEM_MAX = 48 * 1024;

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

// torch.clamp: a NaN input stays NaN.
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// a b - c d as PyTorch's cross product rounds it on the card: c d
// rounded, then one fused multiply-add.
__device__ __forceinline__ float cross_row(float a, float b, float c,
                                           float d) {
  return __fmaf_rn(a, b, -mul(c, d));
}

// (a0 b0 + a1 b1) + a2 b2, the order of a sum over three rows.
__device__ __forceinline__ float dot3(float a0, float a1, float a2,
                                      float b0, float b1, float b2) {
  return add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2));
}

// Rotation (body -> world) of the quaternion (w, x, y, z), row-major.
__device__ __forceinline__ void quat_to_rot(const float (&qt)[4],
                                            float (&R)[9]) {
  const float w = qt[0], x = qt[1], y = qt[2], z = qt[3];
  R[0] = sub(1.0f, mul(2.0f, add(mul(y, y), mul(z, z))));
  R[1] = mul(2.0f, sub(mul(x, y), mul(w, z)));
  R[2] = mul(2.0f, add(mul(x, z), mul(w, y)));
  R[3] = mul(2.0f, add(mul(x, y), mul(w, z)));
  R[4] = sub(1.0f, mul(2.0f, add(mul(x, x), mul(z, z))));
  R[5] = mul(2.0f, sub(mul(y, z), mul(w, x)));
  R[6] = mul(2.0f, sub(mul(x, z), mul(w, y)));
  R[7] = mul(2.0f, add(mul(y, z), mul(w, x)));
  R[8] = sub(1.0f, mul(2.0f, add(mul(x, x), mul(y, y))));
}

// R x and R^T x.
__device__ __forceinline__ void mv(const float (&R)[9], const float (&x)[3],
                                   float (&out)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out[i] = dot3(R[3 * i], R[3 * i + 1], R[3 * i + 2], x[0], x[1], x[2]);
}
__device__ __forceinline__ void mvT(const float (&R)[9], const float (&x)[3],
                                    float (&out)[3]) {
#pragma unroll
  for (int j = 0; j < 3; ++j)
    out[j] = dot3(R[j], R[3 + j], R[6 + j], x[0], x[1], x[2]);
}

// x *= vmax / max(|x|, vmax), the reciprocal rounded before the product.
__device__ __forceinline__ void clamp_norm(float (&x)[3], float vmax) {
  const float nrm = __fsqrt_rn(dot3(x[0], x[1], x[2], x[0], x[1], x[2]));
  const float den = isnan(nrm) ? nrm : fmaxf(nrm, vmax);
  const float scale = mul(__frcp_rn(den), vmax);
#pragma unroll
  for (int i = 0; i < 3; ++i) x[i] = mul(x[i], scale);
}

// A free joint: q row [pos 3, quat 4] at qo, v row [w 3, vl 3] (body
// frame) at vo; advanced in the world frame and re-expressed in the new
// body frame (dynamics.py::integrate's free-joint loop).
__device__ void free_body(float* q, float* v, const float* a, int qo, int vo,
                          float dt, float max_lin, float max_ang) {
  float w[3], vl[3], aa[3], al[3], p[3], qt[4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    w[i] = v[vo + i];
    vl[i] = v[vo + 3 + i];
    aa[i] = a[vo + i];
    al[i] = a[vo + 3 + i];
    p[i] = q[qo + i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) qt[i] = q[qo + 3 + i];
  float R[9];
  quat_to_rot(qt, R);
  // World-frame accelerations of the link origin: the transport term
  // w x vl added back before the rotation.
  const float tl[3] = {add(al[0], cross_row(w[1], vl[2], w[2], vl[1])),
                       add(al[1], cross_row(w[2], vl[0], w[0], vl[2])),
                       add(al[2], cross_row(w[0], vl[1], w[1], vl[0]))};
  float aw_lin[3], aw_ang[3], vw[3], ww[3];
  mv(R, tl, aw_lin);
  mv(R, aa, aw_ang);
  mv(R, vl, vw);
  mv(R, w, ww);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    vw[i] = add(vw[i], mul(dt, aw_lin[i]));
    ww[i] = add(ww[i], mul(dt, aw_ang[i]));
  }
  clamp_norm(vw, max_lin);
  clamp_norm(ww, max_ang);
  // The Hamilton product (0, ww) x qt, then the normalized quaternion.
  const float zero = 0.0f;
  const float dq[4] = {
      sub(sub(sub(mul(zero, qt[0]), mul(ww[0], qt[1])), mul(ww[1], qt[2])),
          mul(ww[2], qt[3])),
      sub(add(add(mul(zero, qt[1]), mul(ww[0], qt[0])), mul(ww[1], qt[3])),
          mul(ww[2], qt[2])),
      add(add(sub(mul(zero, qt[2]), mul(ww[0], qt[3])), mul(ww[1], qt[0])),
          mul(ww[2], qt[1])),
      add(sub(add(mul(zero, qt[3]), mul(ww[0], qt[2])), mul(ww[1], qt[1])),
          mul(ww[2], qt[0]))};
  float qn[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qn[i] = add(qt[i], mul(dt, mul(0.5f, dq[i])));
  // The squares summed in pairs, (0 + 2) + (1 + 3), as PyTorch's sum over
  // the quaternion's rows (the fastest axis of the chain's env-first state)
  // reduces them across four lanes.
  const float den = add(
      __fsqrt_rn(add(add(mul(qn[0], qn[0]), mul(qn[2], qn[2])),
                     add(mul(qn[1], qn[1]), mul(qn[3], qn[3])))),
      1e-12f);
#pragma unroll
  for (int i = 0; i < 4; ++i) qn[i] = __fdiv_rn(qn[i], den);
  float Rn[9], wb[3], vb[3];
  quat_to_rot(qn, Rn);
  mvT(Rn, ww, wb);
  mvT(Rn, vw, vb);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    q[qo + i] = add(p[i], mul(dt, vw[i]));
    v[vo + i] = wb[i];
    v[vo + 3 + i] = vb[i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) q[qo + 3 + i] = qn[i];
}

// A 1-dof joint: the velocity capped at max_velocity, the position
// advanced, then clamped to its limits with the inward velocity zeroed
// (dynamics.py::integrate, then clamp_limits).
__device__ __forceinline__ void joint(float* q, float* v, const float* a,
                                      int qo, int vo, const float* lim,
                                      float dt) {
  const float maxv = lim[0], lo = lim[1], hi = lim[2];
  const float v1 = clamp(add(v[vo], mul(dt, a[vo])), -maxv, maxv);
  const float q1 = add(q[qo], mul(dt, v1));
  float v2 = v1;
  if (q1 < lo)
    v2 = isnan(v1) ? v1 : fmaxf(v1, 0.0f);
  else if (q1 > hi)
    v2 = isnan(v1) ? v1 : fminf(v1, 0.0f);
  q[qo] = clamp(q1, lo, hi);
  v[vo] = v2;
}

__global__ void __launch_bounds__(THREADS)
integrate_clamp_kernel(const float* __restrict__ q,
                       const float* __restrict__ v,
                       const float* __restrict__ qdd,
                       float* __restrict__ q_out, float* __restrict__ v_out,
                       const int* __restrict__ table,
                       const float* __restrict__ limits, int n_free,
                       int n_j1, int nq, int nv, int N, float dt,
                       float max_lin, float max_ang) {
  extern __shared__ float s[];
  float* sq = s;                // the block's envs' rows, as in memory
  float* sv = sq + ENVS * nq;
  float* sa = sv + ENVS * nv;
  const int64_t e0 = (int64_t)blockIdx.x * ENVS;
  const int ne = (int)min((int64_t)ENVS, N - e0);
  const float* gq = q + e0 * nq;
  const float* gv = v + e0 * nv;
  const float* ga = qdd + e0 * nv;
  for (int i = threadIdx.x; i < ne * nq; i += THREADS) sq[i] = gq[i];
  for (int i = threadIdx.x; i < ne * nv; i += THREADS) {
    sv[i] = gv[i];
    sa[i] = ga[i];
  }
  __syncthreads();
  const int lane = threadIdx.x % 32;
  if (lane < ne) {
    float* rq = sq + lane * nq;
    float* rv = sv + lane * nv;
    const float* ra = sa + lane * nv;
    for (int item = threadIdx.x / 32; item < n_free + n_j1; item += WARPS) {
      const int qo = table[2 * item], vo = table[2 * item + 1];
      if (item < n_free)
        free_body(rq, rv, ra, qo, vo, dt, max_lin, max_ang);
      else
        joint(rq, rv, ra, qo, vo, limits + 3 * (item - n_free), dt);
    }
  }
  __syncthreads();
  float* oq = q_out + e0 * nq;
  float* ov = v_out + e0 * nv;
  for (int i = threadIdx.x; i < ne * nq; i += THREADS) oq[i] = sq[i];
  for (int i = threadIdx.x; i < ne * nv; i += THREADS) ov[i] = sv[i];
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (cudaErrorInvalidValue
// for a shape it does not take: a block's rows past SMEM_MAX bytes).
extern "C" int integrate_clamp_f32(const float* q, const float* v,
                                   const float* qdd, float* q_out,
                                   float* v_out, const int* table,
                                   const float* limits, int n_free, int n_j1,
                                   int nq, int nv, int N, float dt,
                                   float max_lin, float max_ang,
                                   void* stream) {
  if (N < 0 || nq < 0 || nv < 0 || n_free < 0 || n_j1 < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ENVS * ((size_t)nq + 2 * (size_t)nv);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (N == 0 || nq + nv == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((N + ENVS - 1) / ENVS);
  integrate_clamp_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      q, v, qdd, q_out, v_out, table, limits, n_free, n_j1, nq, nv, N, dt,
      max_lin, max_ang);
  return (int)cudaGetLastError();
}
