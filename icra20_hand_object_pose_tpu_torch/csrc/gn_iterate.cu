// The Gauss-Newton tail of an ICP iteration (kernel K4): the correspondence
// gates, `reps` damped point-to-plane solves on the matched pairs, the pose
// updates and the re-posing of the pairs between them, in one launch.
//
// Replaces no TPU kernel. On the TPU this tail is part of the compiled frame
// program, where XLA fuses it into a few loops. The port ran it as about
// 1,140 ATen operators an iteration (three re-linearizations, each with an
// unrolled 6x6 Cholesky, an se3_exp and a pose update), each on a few
// thousand floats: at 25 iterations a tracked frame, three quarters of the
// frame program's kernel nodes, each a microsecond or two of the card's
// time. K4 runs it between one correspondence search (K1) and the next.
//
// For particle b = o * P + p, with the matched model point m, its normal n
// and the squared distance d2 at each scene point s of object o, it computes
// what ops/icp.py `gn_iterate_plain` computes, operation for operation:
//   - w = sw [d2 < maxd2], times the normal test of icp.correspondence_
//     weights (ncos > min_cos where both normals have a norm above 0.5);
//   - m <- m - anchor_o; then `reps` times: H = sum w J J^T, g = sum w r J,
//     wrr = sum w r^2 with r = n . (s - m), J = [m x n, n]; lam = damping
//     (tr H / 6 + 1e-12); x = (H + lam I)^-1 g by Cholesky, a pivot at or
//     below 1e-20 taking lam (the port's floor); x = 0 where sum w <= 6;
//     x *= step_scale; frozen |= |x|^2 < tol2; x = 0 where frozen; E =
//     se3_exp(x) with its small-angle branches; pose <- T(a) E T(-a) pose;
//     m, n <- E m, E n for the next rep;
//   - rmse = sqrt(wrr / max(sum w, 1e-9)) of the last rep, inliers = sum w,
//     support = sum sw [d2 < tau2] / wsum_o.
//
// What bounds it on Hopper: the bytes. Each particle reads its 7 floats a
// pair (m, n, d2) once, and its object's anchored scene (7 floats a point)
// from L2; about 100 FP32 operations a pair and rep. At the tracked scan
// (512 particles x 512 pairs) that is 7.3 MB, 2.2 us at 3.35 TB/s, against
// ~1.2 us of operations at 67 TFLOP/s. In practice one block's latency sets
// the time (about 22 us a launch there on an H100 at 700 W): each rep waits
// on one thread's serial solve, exponential and pose update, about half of
// a block's cycles, and at ~100 registers a thread 5 blocks fit an SM.
//
// Design:
//   - one block per particle, O * P blocks, of kSmallBlock threads up to
//     kSmallNs pairs and kLargeBlock above: the block size, and with it the
//     order of every sum, follows Ns alone, so object o of a library gets
//     bitwise the result of object o run alone, and a repeated launch is
//     bitwise equal;
//   - the block stages its pairs in shared memory once, 10 floats a pair
//     (m, n, s, w; 40 Ns bytes, opted in above 48 KB). Thread t owns pairs
//     t, t + T, t + 2T, ...: it stages them, sums them and re-poses them,
//     so the pairs never leave the SM between reps and no barrier guards
//     them;
//   - each thread sums its pairs' 28 terms (21 of H's lower triangle, 6 of
//     g, wrr; in the first rep also sum w and the support hits) in ascending
//     pair order, then a fixed shuffle tree per warp, then the warps in
//     order: no atomics;
//   - thread 0 solves, updates the pose and the freeze, and hands E to the
//     block through shared memory; every thread re-poses its own pairs;
//   - FP32 with explicit rounding (__fmul_rn, __fadd_rn, __fdiv_rn,
//     __fsqrt_rn: no contraction into FMA) and sinf / cosf: each elementwise
//     step rounds as the plain version's operator does, and only the sums
//     run in another order.
//
// Plain C interface, loaded with ctypes; the launch goes on the caller's
// stream and the function returns its cudaError_t.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kSmallBlock = 128;
constexpr int kLargeBlock = 256;
constexpr int kSmallNs = 512;     // pairs up to which a block is kSmallBlock threads
constexpr int kPairFloats = 10;   // staged per pair: m (3), n (3), s (3), w
constexpr int kSolveTerms = 28;   // 21 H (lower), 6 g, wrr
constexpr int kTerms = 30;        // and, in the first rep, sum w and the hits
constexpr int kMaxWarps = kLargeBlock / 32;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// a0 b0 + a1 b1 + a2 b2, left to right
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0, float b1,
                                      float b2) {
  return add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2));
}

// M v for a 3x3 M, each row summed left to right (utils/se3._matvec)
__device__ __forceinline__ void matvec3(const float (&M)[3][3], float v0, float v1, float v2,
                                        float (&out)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = dot3(M[i][0], M[i][1], M[i][2], v0, v1, v2);
}

// A B for 3x3 matrices (utils/se3._mm)
__device__ __forceinline__ void mm3(const float (&A)[3][3], const float (&B)[3][3],
                                    float (&out)[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      out[i][j] = add(add(mul(A[i][0], B[0][j]), mul(A[i][1], B[1][j])), mul(A[i][2], B[2][j]));
    }
  }
}

// utils/se3.se3_exp of xi = [w, v]: E = [R | t]
__device__ void se3_exp(const float (&xi)[6], float (&R)[3][3], float (&t)[3]) {
  const float w0 = xi[0], w1 = xi[1], w2 = xi[2];
  const float theta2 = dot3(w0, w1, w2, w0, w1, w2);
  const float theta = __fsqrt_rn(fmaxf(theta2, 1e-9f));
  const bool small = theta2 < 1e-8f;
  const float sn = sinf(theta), cs = cosf(theta);
  const float a = small ? sub(1.0f, dvd(theta2, 6.0f)) : dvd(sn, theta);
  const float b = small ? sub(0.5f, dvd(theta2, 24.0f))
                        : dvd(sub(1.0f, cs), fmaxf(theta2, 1e-9f));
  const float c = small ? sub((float)(1.0 / 6.0), dvd(theta2, 120.0f))
                        : dvd(sub(theta, sn), fmaxf(mul(theta2, theta), 1e-9f));
  const float W[3][3] = {{0.0f, -w2, w1}, {w2, 0.0f, -w0}, {-w1, w0, 0.0f}};
  float WW[3][3], V[3][3];
  mm3(W, W, WW);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float I = i == j ? 1.0f : 0.0f;
      R[i][j] = add(add(I, mul(a, W[i][j])), mul(b, WW[i][j]));
      V[i][j] = add(add(I, mul(b, W[i][j])), mul(c, WW[i][j]));
    }
  }
  matvec3(V, xi[3], xi[4], xi[5], t);
}

// ops/icp.cholesky_solve6: x = H^-1 g for the damped H (lower triangle
// read), a pivot at or below 1e-20 taking `floor`
__device__ void cholesky_solve6(const float (&H)[6][6], const float (&g)[6], float floor,
                                float (&x)[6]) {
  float L[6][6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = H[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = sub(s, mul(L[j][k], L[j][k]));
    L[j][j] = __fsqrt_rn(s > 1e-20f ? s : floor);
    const float inv = dvd(1.0f, L[j][j]);
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float t = H[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) t = sub(t, mul(L[i][k], L[j][k]));
      L[i][j] = mul(t, inv);
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = sub(s, mul(L[i][k], y[k]));
    y[i] = dvd(s, L[i][i]);
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s = sub(s, mul(L[k][i], x[k]));
    x[i] = dvd(s, L[i][i]);
  }
}

// The first NT terms of v summed over the block: a shuffle tree per warp,
// then the warps in order, into red[0 .. NT). Every thread calls it.
template <int NT, int T>
__device__ __forceinline__ void block_sum(const float (&v)[kTerms],
                                          float (&warp_sums)[kMaxWarps][kTerms], float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    float x = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x = add(x, __shfl_down_sync(0xffffffffu, x, off));
    if (lane == 0) warp_sums[warp][k] = x;
  }
  __syncthreads();
  if (threadIdx.x < NT) {
    float acc = warp_sums[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < T / 32; ++w) acc = add(acc, warp_sums[w][threadIdx.x]);
    red[threadIdx.x] = acc;
  }
  __syncthreads();
}

// This thread's pairs' terms: 21 of H's lower triangle (row by row), 6 of
// g, wrr, added to v in ascending pair order.
template <int T>
__device__ __forceinline__ void add_pairs(const float* __restrict__ pairs, int Ns,
                                          float (&v)[kTerms]) {
  for (int s = threadIdx.x; s < Ns; s += T) {
    const float mx = pairs[s], my = pairs[Ns + s], mz = pairs[2 * Ns + s];
    const float nx = pairs[3 * Ns + s], ny = pairs[4 * Ns + s], nz = pairs[5 * Ns + s];
    const float sx = pairs[6 * Ns + s], sy = pairs[7 * Ns + s], sz = pairs[8 * Ns + s];
    const float w = pairs[9 * Ns + s];
    const float r = dot3(nx, ny, nz, sub(sx, mx), sub(sy, my), sub(sz, mz));
    const float J[6] = {sub(mul(my, nz), mul(mz, ny)), sub(mul(mz, nx), mul(mx, nz)),
                        sub(mul(mx, ny), mul(my, nx)), nx, ny, nz};
    float wJ[6];
#pragma unroll
    for (int a = 0; a < 6; ++a) wJ[a] = mul(J[a], w);
    int k = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j, ++k) v[k] = add(v[k], mul(wJ[i], J[j]));
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) v[21 + a] = add(v[21 + a], mul(wJ[a], r));
    v[27] = add(v[27], mul(mul(w, r), r));
  }
}

template <int T>
__global__ void __launch_bounds__(T)
gn_iterate_kernel(const float* __restrict__ poses,      // [O*P, 4, 4]
                  const bool* __restrict__ frozen,      // [O*P]
                  const float* __restrict__ matched,    // [O*P, Ns, 3]
                  const float* __restrict__ mnormal,    // [O*P, Ns, 3]
                  const float* __restrict__ d2,         // [O*P, Ns]
                  const float* __restrict__ scene_c,    // [O, Ns, 3] anchored
                  const float* __restrict__ scene_nrm,  // [Gn, Ns, 3]
                  const float* __restrict__ scene_w,    // [O, Ns]
                  const float* __restrict__ anchor,     // [O, 3]
                  const float* __restrict__ wsum,       // [O]
                  float* __restrict__ poses_out,        // [O*P, 4, 4]
                  bool* __restrict__ frozen_out,        // [O*P]
                  float* __restrict__ rmse_out,         // [O*P]
                  float* __restrict__ inliers_out,      // [O*P]
                  float* __restrict__ support_out,      // [O*P]
                  int P, int per_nrm, int Ns, int reps, float maxd2, float min_cos,
                  float damping, float step_scale, float tol2, float tau2) {
  extern __shared__ float pairs[];  // [kPairFloats][Ns]
  __shared__ float warp_sums[kMaxWarps][kTerms];
  __shared__ float red[kTerms];
  __shared__ float E[12];           // the increment: R row by row, then t

  const int b = blockIdx.x;
  const int o = b / P;
  const float ax = anchor[3 * o], ay = anchor[3 * o + 1], az = anchor[3 * o + 2];

  // stage the pairs, gated and anchored, and sum w and the support hits
  float v[kTerms];
#pragma unroll
  for (int k = 0; k < kTerms; ++k) v[k] = 0.0f;
  const size_t pb = (size_t)b * Ns, so = (size_t)o * Ns, sn = (size_t)(o / per_nrm) * Ns;
  for (int s = threadIdx.x; s < Ns; s += T) {
    const float m0 = matched[3 * (pb + s)], m1 = matched[3 * (pb + s) + 1],
                m2 = matched[3 * (pb + s) + 2];
    const float n0 = mnormal[3 * (pb + s)], n1 = mnormal[3 * (pb + s) + 1],
                n2 = mnormal[3 * (pb + s) + 2];
    const float q0 = scene_nrm[3 * (sn + s)], q1 = scene_nrm[3 * (sn + s) + 1],
                q2 = scene_nrm[3 * (sn + s) + 2];
    const float dd = d2[pb + s], sw = scene_w[so + s];
    float w = mul(sw, dd < maxd2 ? 1.0f : 0.0f);
    const float ncos = dot3(q0, q1, q2, n0, n1, n2);
    const bool have_n = dot3(q0, q1, q2, q0, q1, q2) > 0.5f && dot3(n0, n1, n2, n0, n1, n2) > 0.5f;
    w = mul(w, have_n ? (ncos > min_cos ? 1.0f : 0.0f) : 1.0f);
    pairs[s] = sub(m0, ax);
    pairs[Ns + s] = sub(m1, ay);
    pairs[2 * Ns + s] = sub(m2, az);
    pairs[3 * Ns + s] = n0;
    pairs[4 * Ns + s] = n1;
    pairs[5 * Ns + s] = n2;
    pairs[6 * Ns + s] = scene_c[3 * (so + s)];
    pairs[7 * Ns + s] = scene_c[3 * (so + s) + 1];
    pairs[8 * Ns + s] = scene_c[3 * (so + s) + 2];
    pairs[9 * Ns + s] = w;
    v[28] = add(v[28], w);
    v[29] = add(v[29], mul(dd < tau2 ? 1.0f : 0.0f, sw));
  }

  // thread 0's state: the pose, the freeze, and the first rep's sums
  float R[3][3], t[3], wtot = 0.0f, hits = 0.0f, rmse = 0.0f;
  bool fz = false;
  if (threadIdx.x == 0) {
    const float* T0 = poses + (size_t)b * 16;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) R[i][j] = T0[4 * i + j];
      t[i] = T0[4 * i + 3];
    }
    fz = frozen[b];
  }

  for (int rep = 0; rep < reps; ++rep) {
    if (rep > 0) {
#pragma unroll
      for (int k = 0; k < kSolveTerms; ++k) v[k] = 0.0f;
    }
    add_pairs<T>(pairs, Ns, v);
    if (rep == 0) {
      block_sum<kTerms, T>(v, warp_sums, red);
    } else {
      block_sum<kSolveTerms, T>(v, warp_sums, red);
    }
    if (threadIdx.x == 0) {
      if (rep == 0) {
        wtot = red[28];
        hits = red[29];
      }
      float H[6][6], g[6], x[6];
      int k = 0;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int j = 0; j <= i; ++j, ++k) H[i][j] = red[k];
      }
#pragma unroll
      for (int a = 0; a < 6; ++a) g[a] = red[21 + a];
      float tr = H[0][0];
#pragma unroll
      for (int a = 1; a < 6; ++a) tr = add(tr, H[a][a]);
      const float lam = mul(add(dvd(tr, 6.0f), 1e-12f), damping);
#pragma unroll
      for (int a = 0; a < 6; ++a) H[a][a] = add(H[a][a], lam);
      cholesky_solve6(H, g, lam, x);
      rmse = __fsqrt_rn(dvd(red[27], fmaxf(wtot, 1e-9f)));
      // zero inliers: the system is pure damping, freeze instead
      const bool live = wtot > 6.0f;
      float step = 0.0f;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        x[a] = mul(live ? x[a] : 0.0f, step_scale);
        step = a == 0 ? mul(x[0], x[0]) : add(step, mul(x[a], x[a]));
      }
      fz = fz || step < tol2;
#pragma unroll
      for (int a = 0; a < 6; ++a) x[a] = fz ? 0.0f : x[a];
      float ER[3][3], Et[3], Rn[3][3], d[3];
      se3_exp(x, ER, Et);
      // Trans(a) E Trans(-a) pose
      mm3(ER, R, Rn);
      matvec3(ER, sub(t[0], ax), sub(t[1], ay), sub(t[2], az), d);
      t[0] = add(add(d[0], ax), Et[0]);
      t[1] = add(add(d[1], ay), Et[1]);
      t[2] = add(add(d[2], az), Et[2]);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          R[i][j] = Rn[i][j];
          E[3 * i + j] = ER[i][j];
        }
        E[9 + i] = Et[i];
      }
    }
    if (rep + 1 == reps) break;
    __syncthreads();
    // re-pose this thread's pairs by the increment
    float ER[3][3], Et[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) ER[i][j] = E[3 * i + j];
      Et[i] = E[9 + i];
    }
    for (int s = threadIdx.x; s < Ns; s += T) {
      float m[3], n[3];
      matvec3(ER, pairs[s], pairs[Ns + s], pairs[2 * Ns + s], m);
      matvec3(ER, pairs[3 * Ns + s], pairs[4 * Ns + s], pairs[5 * Ns + s], n);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        pairs[i * Ns + s] = add(m[i], Et[i]);
        pairs[(3 + i) * Ns + s] = n[i];
      }
    }
  }

  if (threadIdx.x == 0) {
    float* T1 = poses_out + (size_t)b * 16;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) T1[4 * i + j] = R[i][j];
      T1[4 * i + 3] = t[i];
    }
    T1[12] = 0.0f;
    T1[13] = 0.0f;
    T1[14] = 0.0f;
    T1[15] = 1.0f;
    frozen_out[b] = fz;
    rmse_out[b] = rmse;
    inliers_out[b] = wtot;
    support_out[b] = dvd(hits, wsum[o]);
  }
}

// The dynamic shared memory each device's kernel was opted in to, so that
// the attribute is set once per size (in an eager warm-up, before a CUDA
// graph captures the launch) and not on every launch.
size_t g_opted[2][kMaxDevices];

template <int T, int I>
cudaError_t launch_t(int O, int P, int Gn, int Ns, int reps, cudaStream_t st,
                     const float* poses, const bool* frozen, const float* matched,
                     const float* mnormal, const float* d2, const float* scene_c,
                     const float* scene_nrm, const float* scene_w, const float* anchor,
                     const float* wsum, float* poses_out, bool* frozen_out, float* rmse,
                     float* inliers, float* support, float maxd2, float min_cos,
                     float damping, float step_scale, float tol2, float tau2) {
  const size_t smem = (size_t)kPairFloats * Ns * sizeof(float);
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (g_opted[I][dev] < smem) {
      err = cudaFuncSetAttribute(gn_iterate_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      g_opted[I][dev] = smem;
    }
  }
  gn_iterate_kernel<T><<<O * P, T, smem, st>>>(
      poses, frozen, matched, mnormal, d2, scene_c, scene_nrm, scene_w, anchor, wsum,
      poses_out, frozen_out, rmse, inliers, support, P, O / Gn, Ns, reps, maxd2, min_cos,
      damping, step_scale, tol2, tau2);
  return cudaGetLastError();
}

}  // namespace

// K4 over O objects of P particles each, Ns scene points an object: one
// block per particle. `scene_nrm` holds Gn normal blocks, Gn a divisor of O
// (1: one scene's normals for all objects); `scene_c`, `scene_w`, `anchor`
// and `wsum` one block per object. `tau2` <= 0 gives a support of 0.
extern "C" int gn_iterate_launch(const float* poses, const bool* frozen, const float* matched,
                                 const float* mnormal, const float* d2, const float* scene_c,
                                 const float* scene_nrm, const float* scene_w,
                                 const float* anchor, const float* wsum, float* poses_out,
                                 bool* frozen_out, float* rmse, float* inliers, float* support,
                                 int O, int P, int Gn, int Ns, int reps, float maxd2,
                                 float min_cos, float damping, float step_scale, float tol2,
                                 float tau2, void* stream) {
  if (O <= 0 || P <= 0 || Ns <= 0 || Gn <= 0 || O % Gn != 0 || reps < 1 ||
      (long long)O * P > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  if (Ns <= kSmallNs) {
    return (int)launch_t<kSmallBlock, 0>(O, P, Gn, Ns, reps, st, poses, frozen, matched,
                                         mnormal, d2, scene_c, scene_nrm, scene_w, anchor,
                                         wsum, poses_out, frozen_out, rmse, inliers, support,
                                         maxd2, min_cos, damping, step_scale, tol2, tau2);
  }
  return (int)launch_t<kLargeBlock, 1>(O, P, Gn, Ns, reps, st, poses, frozen, matched, mnormal,
                                       d2, scene_c, scene_nrm, scene_w, anchor, wsum,
                                       poses_out, frozen_out, rmse, inliers, support, maxd2,
                                       min_cos, damping, step_scale, tol2, tau2);
}
