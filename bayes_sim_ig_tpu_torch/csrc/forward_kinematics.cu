// One physics substep's forward kinematics for Hopper (sm_90a): every
// link's world pose, the world-Plücker dof subspaces and the link
// velocities of every env in one launch.
//
// Inputs are contiguous float32, env-first, as the tasks hold their state:
//
//     q      (N, nq)   generalized positions (free joints: pos, quat)
//     v      (N, nv)   velocities (free joints: w, vl in body frame)
//     scale  (N,)      the geometry scale, `scale_stride` floats apart
//                      (0: one value for every env)
//
// and the model's tables, built once per model and device
// (physics/dynamics.py::_structure, "fk_itab" and "fk_ftab"):
//
//     itab int32, by link b (nb rows): parent (nb for a root), the
//                 1-dof joint whose chain ends at b (-1: none), the free
//                 joint of b (-1: none), the bit mask of b's ancestor
//                 dofs (anc_dof's row);
//                 by 1-dof joint j (nj rows): q column, v column, chain
//                 position, the chain's previous joint (0 at position 0),
//                 the parent link of j's link (nb for a root);
//                 by dof m (nv rows): 6 f + k for a free joint f's k-th
//                 dof, else -1;
//                 by free joint f (n_free rows): its link, its q column;
//     ftab float, by link b: the fixed child->parent rotation E^T (9; 0
//                 on rows a joint owns) and offset (3);
//                 by 1-dof joint j: E (9), hat(axis) (9), axis axis^T
//                 (9), offset (3), E^T axis (3), axis (3), revolute (1).
//
// The output is one (24 nb + 12 nv, N) float32 buffer, env-last, whose
// rows are, in this order, the Kinematics fields R_w (nb, 3, 3), p_w
// (nb, 3), v (nb, 6), S_o (nv, 6), Sv_o (nv, 6) and V_o (nb, 6); o is p_w's
// first link.
//
// Entry point (plain C, bound with ctypes): forward_kinematics_f32.
//
// Replaces no TPU kernel: it replaces the plain PyTorch chain of
// physics/dynamics.py::forward_kinematics (the JAX package's function of
// the same name, which XLA fuses), 130-159 small launches a substep on the
// card, two substeps an env step, in every articulated task. That chain is
// its plain version: CPU tensors take it, and the card's tests hold the
// kernel to it.
//
// The arithmetic is the chain's as PyTorch 2.11's kernels round it on the
// card, operation by operation in the same order: each product and sum
// rounded on its own (__fmul_rn, __fadd_rn), so that nvcc contracts
// nothing; the one multiply-add that PyTorch's cross product fuses; the
// sums over a 3-vector's rows left to right from +0, as PyTorch's
// reductions over a non-contiguous axis take them; a one-hot fold (a
// float32 GEMM with a 0/1 matrix) as the gather it is, plus +0 (a -0 comes
// out +0), and the ancestor fold of the link velocities as the sum of the
// ancestor dofs in ascending order from +0; precise sinf and cosf. So its
// result is the chain's bit for bit on an H100 (chip_smoke.py;
// tests/test_torch_fk_kernel.py), and a step stays that of the plain
// reference the benchmark holds it to.
//
// What bounds it on an H100: bytes. An env reads nq + nv + 1 floats and
// writes 24 nb + 12 nv (ShadowHand at 10,000 envs: 41 MB, 12 us at 3.35
// TB/s); its FLOPs, under 15,000 an env in the cells' models, take a fifth
// of that or less (ops/bounds.py). The chain it replaces is bound by its
// launches' latency. This design:
//   - gives each block 8 envs, one a warp; the block stages their rows of
//     q and v in shared memory as the contiguous spans they are;
//   - gives lane l of an env's warp its link l (lane nb holds the virtual
//     root, the identity), its 1-dof joint l and its dof l: a
//     pointer-jumping round reads its ancestor's pose from lane ptr[l] with
//     warp shuffles, so every round reads only the round before, in
//     registers (nb + 1, nj and nv at most 32);
//   - writes each output row of its env into a shared-memory tile, and the
//     block writes the tile out along the env axis (8 envs, 32 contiguous
//     bytes a row), so that the env-last outputs are written coalesced;
//   - needs nothing but the launch: no allocation, no host sync, so it is
//     captured in the step graphs as it is.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ENVS = 8;  // envs a block: one a warp
constexpr int THREADS = 32 * ENVS;
constexpr unsigned FULL = 0xffffffffu;
// A block's tile and inputs fit the 48 KB of dynamic shared memory a launch
// gets without opting in (ShadowHand: 8 x (1,009 + 31 + 30) floats).
constexpr int SMEM_MAX = 48 * 1024;
constexpr int LINK_INTS = 4, JOINT_INTS = 5, FREE_INTS = 2;
constexpr int LINK_FLOATS = 12, JOINT_FLOATS = 37;

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

// A one-hot fold's gather: x plus the fold's +0.
__device__ __forceinline__ float gathered(float x) { return add(x, 0.0f); }

// A sum over three rows: (a + b) + c from +0.
__device__ __forceinline__ float sum3(float a, float b, float c) {
  return add(add(add(a, b), c), 0.0f);
}

// A B, A x and A^T x of row-major 3 x 3 matrices.
__device__ __forceinline__ void mm(const float (&A)[9], const float (&B)[9],
                                   float (&out)[9]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int l = 0; l < 3; ++l)
      out[3 * i + l] = sum3(mul(A[3 * i], B[l]), mul(A[3 * i + 1], B[3 + l]),
                            mul(A[3 * i + 2], B[6 + l]));
}
__device__ __forceinline__ void mv(const float (&A)[9], const float (&x)[3],
                                   float (&out)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out[i] = sum3(mul(A[3 * i], x[0]), mul(A[3 * i + 1], x[1]),
                  mul(A[3 * i + 2], x[2]));
}
__device__ __forceinline__ void mvT(const float (&A)[9], const float (&x)[3],
                                    float (&out)[3]) {
#pragma unroll
  for (int j = 0; j < 3; ++j)
    out[j] = sum3(mul(A[j], x[0]), mul(A[3 + j], x[1]), mul(A[6 + j], x[2]));
}

// a x b as PyTorch's cross product rounds it on the card: a row's second
// product rounded, then one fused multiply-add.
__device__ __forceinline__ void cross(const float (&a)[3], const float (&b)[3],
                                      float (&out)[3]) {
  out[0] = __fmaf_rn(a[1], b[2], -mul(a[2], b[1]));
  out[1] = __fmaf_rn(a[2], b[0], -mul(a[0], b[2]));
  out[2] = __fmaf_rn(a[0], b[1], -mul(a[1], b[0]));
}

// Rotation (body -> world) of the quaternion (w, x, y, z), row-major.
__device__ __forceinline__ void quat_to_rot(const float* qt, float (&R)[9]) {
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

template <int K>
__device__ __forceinline__ void shfl(const float (&x)[K], int src,
                                     float (&out)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) out[k] = __shfl_sync(FULL, x[k], src);
}

struct Sizes {
  int nb, nj, nv, n_free, n_jump, chain_max;
};

// One env, on its warp: qe and ve its rows of q and v, tile its output
// rows (row r at tile[r]).
__device__ void env_kinematics(const float* qe, const float* ve, float scale,
                               float* tile, const int* __restrict__ itab,
                               const float* __restrict__ ftab, Sizes s,
                               int lane) {
  const int nb = s.nb, nj = s.nj, nv = s.nv;
  const int* link_i = itab;
  const int* joint_i = link_i + LINK_INTS * nb;
  const int* dof_i = joint_i + JOINT_INTS * nj;
  const int* free_i = dof_i + nv;
  const float* link_f = ftab;
  const float* joint_f = link_f + LINK_FLOATS * nb;
  const int R_ROW = 0, P_ROW = 9 * nb, VB_ROW = 12 * nb, S_ROW = 18 * nb,
            SV_ROW = 18 * nb + 6 * nv, V_ROW = 18 * nb + 12 * nv;

  // --- each 1-dof joint's local transform within its chain: rotation
  // G = E^T R(a, q) and translation u (lane j). ----------------------- //
  float G[9] = {}, u[3] = {};
  int jpos = 0, jprev = 0;
  float rev = 0.0f;
  const bool joint = lane < nj;
  if (joint) {
    const int* ji = joint_i + JOINT_INTS * lane;
    const float* jf = joint_f + JOINT_FLOATS * lane;
    jpos = ji[2];
    jprev = ji[3];
    rev = jf[36];
    const float q1 = qe[ji[0]];
    const float ang = mul(q1, rev);
    const float sn = sinf(ang), cs = cosf(ang);
    const float omc = sub(1.0f, cs);
    float E[9], Rj[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      E[k] = jf[k];
      const float eye = (k % 4 == 0) ? 1.0f : 0.0f;
      Rj[k] = add(add(mul(cs, eye), mul(sn, jf[9 + k])),
                  mul(omc, jf[18 + k]));
    }
    mm(E, Rj, G);
    const float pris = mul(q1, sub(1.0f, rev));
#pragma unroll
    for (int i = 0; i < 3; ++i)
      u[i] = add(mul(jf[27 + i], scale), mul(jf[30 + i], pris));
  }
  // Joint-chain compose: round p folds every chain joint at position p onto
  // its predecessor's composed (G, u) of round p - 1.
  for (int round = 1; round <= s.chain_max; ++round) {
    float Gp[9], up[3];
    shfl(G, jprev, Gp);
    shfl(u, jprev, up);
    if (joint && jpos == round) {
#pragma unroll
      for (int k = 0; k < 9; ++k) Gp[k] = gathered(Gp[k]);
      float Gn[9], w[3];
      mm(Gp, G, Gn);
      mv(Gp, u, w);
#pragma unroll
      for (int k = 0; k < 9; ++k) G[k] = Gn[k];
#pragma unroll
      for (int i = 0; i < 3; ++i) u[i] = add(gathered(up[i]), w[i]);
    }
  }

  // --- each link's local child->parent transform (lane b; lane nb and
  // beyond the identity): the fixed rows plus the folds of the 1-dof and
  // free rows. ------------------------------------------------------- //
  const bool link = lane < nb;
  float R[9] = {1.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 1.0f};
  float p[3] = {};
  int ptr = lane, lj = -1, lf = -1;
  if (link) {
    const int* li = link_i + LINK_INTS * lane;
    const float* lfl = link_f + LINK_FLOATS * lane;
    ptr = li[0];
    lj = li[1];
    lf = li[2];
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = lfl[k];
#pragma unroll
    for (int i = 0; i < 3; ++i) p[i] = mul(lfl[9 + i], scale);
  }
  if (nj > 0) {
    float g[9], gu[3];
    shfl(G, lj >= 0 ? lj : 0, g);
    shfl(u, lj >= 0 ? lj : 0, gu);
    if (link) {
#pragma unroll
      for (int k = 0; k < 9; ++k)
        R[k] = add(R[k], lj >= 0 ? gathered(g[k]) : 0.0f);
#pragma unroll
      for (int i = 0; i < 3; ++i)
        p[i] = add(p[i], lj >= 0 ? gathered(gu[i]) : 0.0f);
    }
  }
  if (s.n_free > 0 && link) {
    float Rf[9] = {}, rf[3] = {};
    if (lf >= 0) {
      const float* qo = qe + free_i[FREE_INTS * lf + 1];
      quat_to_rot(qo + 3, Rf);
#pragma unroll
      for (int k = 0; k < 9; ++k) Rf[k] = gathered(Rf[k]);
#pragma unroll
      for (int i = 0; i < 3; ++i) rf[i] = gathered(qo[i]);
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = add(R[k], Rf[k]);
#pragma unroll
    for (int i = 0; i < 3; ++i) p[i] = add(p[i], rf[i]);
  }

  // --- pointer jumping: (R1, p1) o (R2, p2) = (R1 R2, p1 + R1 p2); after
  // round k a link's transform covers 2^k ancestors. ------------------ //
  for (int k = 0; k < s.n_jump; ++k) {
    float AR[9], Ap[3], Rn[9], w[3];
    shfl(R, ptr, AR);
    shfl(p, ptr, Ap);
#pragma unroll
    for (int x = 0; x < 9; ++x) AR[x] = gathered(AR[x]);
    mm(AR, R, Rn);
    mv(AR, p, w);
#pragma unroll
    for (int x = 0; x < 9; ++x) R[x] = Rn[x];
#pragma unroll
    for (int i = 0; i < 3; ++i) p[i] = add(gathered(Ap[i]), w[i]);
    ptr = __shfl_sync(FULL, ptr, ptr);
  }
  float o[3], rel[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    o[i] = __shfl_sync(FULL, p[i], 0);
    rel[i] = sub(p[i], o[i]);
  }
  if (link) {
#pragma unroll
    for (int k = 0; k < 9; ++k) tile[R_ROW + 9 * lane + k] = R[k];
#pragma unroll
    for (int i = 0; i < 3; ++i) tile[P_ROW + 3 * lane + i] = p[i];
  }

  // --- world-Plücker dof subspaces about o. A fold's row is the gathered
  // row (the two folds add +0 to each other's rows). ----------------- //
  if (nj > 0) {
    // A joint's axis and anchor through its link's parent pose.
    float Rp[9], pp[3];
    const int par = joint ? joint_i[JOINT_INTS * lane + 4] : lane;
    shfl(R, par, Rp);
    shfl(p, par, pp);
    if (joint) {
      const float* jf = joint_f + JOINT_FLOATS * lane;
      const float axis[3] = {jf[33], jf[34], jf[35]};
      float A[3], aw[3], Ru[3], d[3], mom[3];
#pragma unroll
      for (int k = 0; k < 9; ++k) Rp[k] = gathered(Rp[k]);
      mv(G, axis, A);
      mv(Rp, A, aw);
      mv(Rp, u, Ru);
#pragma unroll
      for (int i = 0; i < 3; ++i)
        d[i] = sub(add(gathered(pp[i]), Ru[i]), o[i]);
      cross(d, aw, mom);
      float* row = tile + S_ROW + 6 * joint_i[JOINT_INTS * lane + 1];
      const float lin = sub(1.0f, rev);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        row[i] = gathered(mul(aw[i], rev));
        row[3 + i] = gathered(add(mul(mom[i], rev), mul(aw[i], lin)));
      }
    }
  }
  if (s.n_free > 0) {
    // Angular dof k of a free joint: [R e_k; (p - o) x R e_k]; linear:
    // [0; R e_k].
    const int df = lane < nv ? dof_i[lane] : -1;
    float Ri[9], ri[3];
    const int src = df >= 0 ? free_i[FREE_INTS * (df / 6)] : 0;
    shfl(R, src, Ri);
    shfl(rel, src, ri);
    if (df >= 0) {
      const int k = df % 6, c = k % 3;
      const float col[3] = {Ri[c], Ri[3 + c], Ri[6 + c]};
      float* row = tile + S_ROW + 6 * lane;
      if (k < 3) {
        float mom[3];
        cross(ri, col, mom);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          row[i] = gathered(col[i]);
          row[3 + i] = gathered(mom[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          row[i] = 0.0f;
          row[3 + i] = gathered(col[i]);
        }
      }
    }
  }
  __syncwarp();
  if (lane < nv) {
#pragma unroll
    for (int c = 0; c < 6; ++c)
      tile[SV_ROW + 6 * lane + c] = mul(tile[S_ROW + 6 * lane + c], ve[lane]);
  }
  __syncwarp();

  // --- link velocities V_b = sum of the ancestor dofs' S_o v, ascending,
  // and the body-frame [w; vl] at each link origin. ------------------- //
  if (link) {
    const unsigned anc = (unsigned)link_i[LINK_INTS * lane + 3];
    float V[6] = {};
    for (int m = 0; m < nv; ++m) {
      if ((anc >> m) & 1u) {
#pragma unroll
        for (int c = 0; c < 6; ++c)
          V[c] = add(V[c], tile[SV_ROW + 6 * m + c]);
      }
    }
    const float w[3] = {V[0], V[1], V[2]};
    float cr[3], vpt[3], wb[3], vb[3];
    cross(w, rel, cr);
#pragma unroll
    for (int i = 0; i < 3; ++i) vpt[i] = add(V[3 + i], cr[i]);
    mvT(R, w, wb);
    mvT(R, vpt, vb);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      tile[VB_ROW + 6 * lane + i] = wb[i];
      tile[VB_ROW + 6 * lane + 3 + i] = vb[i];
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) tile[V_ROW + 6 * lane + c] = V[c];
  }
}

__global__ void __launch_bounds__(THREADS)
forward_kinematics_kernel(const float* __restrict__ q,
                          const float* __restrict__ v,
                          const float* __restrict__ scale, int scale_stride,
                          float* __restrict__ out,
                          const int* __restrict__ itab,
                          const float* __restrict__ ftab, Sizes s, int nq,
                          int N) {
  extern __shared__ float smem[];
  const int rows = 24 * s.nb + 12 * s.nv;
  const int pitch = rows | 1;  // odd: a warp's rows fall in distinct banks
  float* tile = smem;          // [ENVS][pitch]
  float* sq = tile + ENVS * pitch;
  float* sv = sq + ENVS * nq;
  const int64_t e0 = (int64_t)blockIdx.x * ENVS;
  const int ne = (int)min((int64_t)ENVS, (int64_t)N - e0);
  for (int i = threadIdx.x; i < ne * nq; i += THREADS) sq[i] = q[e0 * nq + i];
  for (int i = threadIdx.x; i < ne * s.nv; i += THREADS)
    sv[i] = v[e0 * s.nv + i];
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp < ne)
    env_kinematics(sq + warp * nq, sv + warp * s.nv,
                   scale[(e0 + warp) * scale_stride], tile + warp * pitch,
                   itab, ftab, s, lane);
  __syncthreads();
  for (int i = threadIdx.x; i < rows * ENVS; i += THREADS) {
    const int r = i / ENVS, e = i % ENVS;
    if (e < ne) out[(int64_t)r * N + e0 + e] = tile[e * pitch + r];
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (cudaErrorInvalidValue
// for a model it does not take: nb + 1, nj or nv past 32, or a block's
// tile and rows past SMEM_MAX bytes).
extern "C" int forward_kinematics_f32(const float* q, const float* v,
                                      const float* scale, float* out,
                                      const int* itab, const float* ftab,
                                      int scale_stride, int nb, int nj,
                                      int nv, int nq, int n_free, int n_jump,
                                      int chain_max, int N, void* stream) {
  if (N < 0 || nb < 1 || nb + 1 > 32 || nj < 0 || nj > 32 || nv < 0 ||
      nv > 32 || nq < 0 || n_free < 0 || n_jump < 0 || chain_max < 0 ||
      scale_stride < 0)
    return (int)cudaErrorInvalidValue;
  const int pitch = (24 * nb + 12 * nv) | 1;
  const size_t smem = sizeof(float) * ENVS * ((size_t)pitch + nq + nv);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  const Sizes s = {nb, nj, nv, n_free, n_jump, chain_max};
  const unsigned blocks = (unsigned)((N + ENVS - 1) / ENVS);
  forward_kinematics_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      q, v, scale, scale_stride, out, itab, ftab, s, nq, N);
  return (int)cudaGetLastError();
}
