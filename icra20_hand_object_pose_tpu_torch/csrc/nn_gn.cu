// Fused nearest-neighbour search + correspondence gates + point-to-plane
// normal equations (kernel K3).
//
// Replaces the Pallas kernel `knn_pallas.nn_gn_batched`
// (icra20_hand_object_pose_tpu/ops/knn_pallas.py, `_make_gn_kernel`). For
// every particle p it matches each anchored scene point s to the nearest
// point of the anchored posed model cloud (exact FP32, first minimal index,
// as kernel K1), gates the match exactly as the port's
// `icp.correspondence_weights` does (d2 < maxd2, the normal test with its
// > 0.5 norm guards, the scene weight), and sums over the scene
//
//   H = sum w J J^T (6x6), g = sum w r J (6), wsum = sum w,
//   hits = sum sw [d2 < tau2], wrr = sum w r^2,
//
// with r = n . (s - m) and J = [m x n, n] at the matched point m, normal n.
//
// What bounds it on Hopper: the search, as in K1: about 9 FP32 operations
// per (scene, model) pair on the CUDA cores against a few MB of input. The
// per-point epilogue (gates, J, 30 products) is ~100 operations per scene
// point, small beside Nm pairs per point.
//
// Design (not the TPU's block design):
//   - the search is K1's: one block per (particle, tile of kQueryTile scene
//     points), one thread per scene point, model tiles staged in shared
//     memory, explicitly rounded distance arithmetic, strict `<`;
//   - the matched point and normal are read by index in FP32 (the TPU used
//     a one-hot double-bf16 matrix product);
//   - each thread forms its 30 terms (21 upper-triangle entries of w J J^T,
//     6 of w r J, w r^2, the support hit and w) with FP32 multiplies on the
//     CUDA cores, multiplying by w directly (the TPU contracted sqrt(w)-
//     scaled rows on its matrix unit at HIGHEST precision);
//   - the block sums them over warp shuffles, then across its warps through
//     shared memory, and writes one [30] partial per (particle, scene tile);
//   - a second small kernel sums the partials over the scene tiles in tile
//     order and scatters them into H, g, wsum, hits and wrr. No atomics: the
//     result is bitwise reproducible run to run.
//
// Scene padding rows (far coordinates, weight 0) give w = 0 and finite
// terms, so they add exact zeros. Plain C interface, loaded with ctypes; both
// launches go on the caller's stream and the function returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kQueryTile = 128;  // threads per block, one scene point each
constexpr int kRefTile = 256;    // model points staged per shared tile
constexpr int kWarps = kQueryTile / 32;
constexpr int kTerms = 30;       // 21 H (upper), 6 g, wrr, hits, wsum
constexpr int kFinishThreads = 256;

__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                   __fmul_rn(a2, b2));
}

__global__ void __launch_bounds__(kQueryTile)
nn_gn_kernel(const float* __restrict__ scene,      // [Ns, 3] anchored
             const float* __restrict__ scene_nrm,  // [Ns, 3]
             const float* __restrict__ scene_w,    // [Ns]
             const float* __restrict__ ref,        // [P, Nm, 3] anchored
             const float* __restrict__ ref_nrm,    // [P, Nm, 3]
             float* __restrict__ partial,          // [P, n_tiles, kTerms]
             int Ns, int Nm, float maxd2, float min_cos, float tau2) {
  __shared__ float tile[3 * kRefTile];
  __shared__ float warp_sums[kWarps][kTerms];

  const int p = blockIdx.x;
  const int s = blockIdx.y * kQueryTile + threadIdx.x;
  const bool active = s < Ns;
  const int sq = active ? s : 0;
  const float qx = scene[3 * sq + 0], qy = scene[3 * sq + 1],
              qz = scene[3 * sq + 2];
  const float* rp = ref + (size_t)p * Nm * 3;

  float best = INFINITY;
  int best_i = 0;
  for (int j0 = 0; j0 < Nm; j0 += kRefTile) {
    const int n = min(kRefTile, Nm - j0);
    __syncthreads();  // the previous tile is no longer read
    for (int k = threadIdx.x; k < 3 * n; k += kQueryTile) {
      tile[k] = rp[(size_t)j0 * 3 + k];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float dx = __fsub_rn(tile[3 * j + 0], qx);
      const float dy = __fsub_rn(tile[3 * j + 1], qy);
      const float dz = __fsub_rn(tile[3 * j + 2], qz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      if (d < best) {
        best = d;
        best_i = j0 + j;
      }
    }
  }

  float v[kTerms];
#pragma unroll
  for (int k = 0; k < kTerms; ++k) v[k] = 0.0f;
  if (active) {
    const size_t src = ((size_t)p * Nm + best_i) * 3;
    const float m0 = rp[(size_t)best_i * 3 + 0], m1 = rp[(size_t)best_i * 3 + 1],
                m2 = rp[(size_t)best_i * 3 + 2];
    const float n0 = ref_nrm[src + 0], n1 = ref_nrm[src + 1],
                n2 = ref_nrm[src + 2];
    const float sn0 = scene_nrm[3 * s + 0], sn1 = scene_nrm[3 * s + 1],
                sn2 = scene_nrm[3 * s + 2];
    const float sw = scene_w[s];
    // gates, as icp.correspondence_weights
    float w = __fmul_rn(sw, best < maxd2 ? 1.0f : 0.0f);
    const float ncos = dot3(sn0, sn1, sn2, n0, n1, n2);
    const bool have_n = dot3(sn0, sn1, sn2, sn0, sn1, sn2) > 0.5f &&
                        dot3(n0, n1, n2, n0, n1, n2) > 0.5f;
    w = __fmul_rn(w, have_n ? (ncos > min_cos ? 1.0f : 0.0f) : 1.0f);
    // point-to-plane residual and Jacobian row
    const float r = dot3(n0, n1, n2, __fsub_rn(qx, m0), __fsub_rn(qy, m1),
                         __fsub_rn(qz, m2));
    const float J[6] = {
        __fsub_rn(__fmul_rn(m1, n2), __fmul_rn(m2, n1)),
        __fsub_rn(__fmul_rn(m2, n0), __fmul_rn(m0, n2)),
        __fsub_rn(__fmul_rn(m0, n1), __fmul_rn(m1, n0)),
        n0, n1, n2};
    float wJ[6];
#pragma unroll
    for (int a = 0; a < 6; ++a) wJ[a] = __fmul_rn(J[a], w);
    int k = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int b = a; b < 6; ++b) v[k++] = __fmul_rn(wJ[a], J[b]);
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) v[21 + a] = __fmul_rn(wJ[a], r);
    v[27] = __fmul_rn(__fmul_rn(w, r), r);
    v[28] = __fmul_rn(sw, best < tau2 ? 1.0f : 0.0f);
    v[29] = w;
  }

  // block sum: warp shuffles, then the warps in order through shared memory
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kTerms; ++k) {
    float x = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, off));
    }
    if (lane == 0) warp_sums[warp][k] = x;
  }
  __syncthreads();
  if (threadIdx.x < kTerms) {
    float acc = warp_sums[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) acc = __fadd_rn(acc, warp_sums[w][threadIdx.x]);
    partial[((size_t)p * gridDim.y + blockIdx.y) * kTerms + threadIdx.x] = acc;
  }
}

// (row, column) of upper-triangle term k of H, in the order nn_gn_kernel
// writes them
__constant__ unsigned char kRow[21] = {0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1,
                                       2, 2, 2, 2, 3, 3, 3, 4, 4, 5};
__constant__ unsigned char kCol[21] = {0, 1, 2, 3, 4, 5, 1, 2, 3, 4, 5,
                                       2, 3, 4, 5, 3, 4, 5, 4, 5, 5};

__global__ void __launch_bounds__(kFinishThreads)
gn_finish_kernel(const float* __restrict__ partial,  // [P, n_tiles, kTerms]
                 float* __restrict__ H,              // [P, 6, 6]
                 float* __restrict__ g,              // [P, 6]
                 float* __restrict__ wsum,           // [P]
                 float* __restrict__ hits,           // [P]
                 float* __restrict__ wrr,            // [P]
                 int P, int n_tiles) {
  const int i = blockIdx.x * kFinishThreads + threadIdx.x;
  if (i >= P * kTerms) return;
  const int p = i / kTerms;
  const int k = i - p * kTerms;
  const float* src = partial + (size_t)p * n_tiles * kTerms + k;
  float acc = src[0];
  for (int t = 1; t < n_tiles; ++t) acc = __fadd_rn(acc, src[(size_t)t * kTerms]);
  if (k < 21) {
    const int r = kRow[k], c = kCol[k];
    H[(size_t)p * 36 + r * 6 + c] = acc;
    H[(size_t)p * 36 + c * 6 + r] = acc;
  } else if (k < 27) {
    g[(size_t)p * 6 + (k - 21)] = acc;
  } else if (k == 27) {
    wrr[p] = acc;
  } else if (k == 28) {
    hits[p] = acc;
  } else {
    wsum[p] = acc;
  }
}

}  // namespace

// Scene points per block: the wrapper sizes the partials buffer with it.
extern "C" int nn_gn_query_tile() { return kQueryTile; }

extern "C" int nn_gn_launch(const float* scene, const float* scene_nrm,
                            const float* scene_w, const float* ref,
                            const float* ref_nrm, float* partial, float* H,
                            float* g, float* wsum, float* hits, float* wrr,
                            int P, int Ns, int Nm, float maxd2, float min_cos,
                            float tau2, void* stream) {
  if (P <= 0 || Ns <= 0 || Nm <= 0) return (int)cudaErrorInvalidValue;
  const int n_tiles = (Ns + kQueryTile - 1) / kQueryTile;
  cudaStream_t st = (cudaStream_t)stream;
  nn_gn_kernel<<<dim3(P, n_tiles), kQueryTile, 0, st>>>(
      scene, scene_nrm, scene_w, ref, ref_nrm, partial, Ns, Nm, maxd2, min_cos,
      tau2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = P * kTerms;
  gn_finish_kernel<<<(n + kFinishThreads - 1) / kFinishThreads, kFinishThreads,
                     0, st>>>(partial, H, g, wsum, hits, wrr, P, n_tiles);
  return (int)cudaGetLastError();
}
