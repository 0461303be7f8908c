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
// What bounds it on Hopper: the search, as in K1: about 10 issued
// instructions per (scene, model) pair on the CUDA cores (nn_search.cuh)
// against a few MB of input. The per-point epilogue (gates, J, 30 products)
// is ~100 operations per scene point, small beside Nm pairs per point.
//
// Design (one launch, no atomics on the sums):
//   - the search is nn_search.cuh's: each thread owns Q scene points, the
//     block's S groups of 128 threads split the model cloud and merge in
//     group order; the staged model tiles carry the normals too;
//   - the scene comes in G blocks of Ns points (points, normals, weights),
//     G a divisor of P: particle p is matched against scene p / (P / G). G ==
//     1 is one scene for all particles; G > 1 is a library of objects, each
//     with its own anchored scene and weights, in one launch. A particle
//     reads and sums its own group's scene only, so its sums do not depend
//     on what the other groups hold;
//   - grid (scene_split, P): block t of particle p takes scene tile t (Q *
//     128 points) of every chunk of scene_split * Q * 128 points, so a scene
//     larger than the grid covers is walked in chunks, in order;
//   - group 0 forms the 30 terms of its points (21 upper-triangle entries
//     of w J J^T, 6 of w r J, w r^2, the support hit and w) with FP32
//     multiplies, reading the matched point and normal by index from the
//     staged tiles (the TPU used a one-hot double-bf16 product), multiplying
//     by w directly (the TPU contracted sqrt(w)-scaled rows on its matrix
//     unit), and adds them to 30 running sums per thread, point by point;
//   - the block sums them over warp shuffles, then across its warps in
//     warp order. With one block per particle it writes H (both triangles),
//     g, wsum, hits and wrr. With scene_split > 1 each block writes its 30
//     sums to `partial` and counts itself in `arrived[p]`; the last block
//     of the particle adds the sums in block order, writes the result and
//     resets the count (one atomic on a counter per block, none on the
//     sums). A thread-block cluster with a distributed-shared-memory reduce
//     costs 1.5-1.7 us more per launch at this grid (scripts/cluster_cost.cu
//     on an H100), more than this reduce does. Every sum runs in a fixed
//     order: the result is bitwise reproducible.
//
// Scene padding rows (far coordinates, weight 0) give w = 0 and finite
// terms, so they add exact zeros. Plain C interface, loaded with ctypes; the
// launch goes on the caller's stream and the function returns its
// cudaError_t.

#include "nn_search.cuh"

namespace {

using namespace nn_search;

constexpr int kMaxWarps = kMaxBlock / 32;
constexpr int kTerms = 30;  // 21 H (upper), 6 g, wrr, hits, wsum

// (row, column) of upper-triangle term k of H, in the order add_terms
// writes them
__constant__ unsigned char kRow[21] = {0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1,
                                       2, 2, 2, 2, 3, 3, 3, 4, 4, 5};
__constant__ unsigned char kCol[21] = {0, 1, 2, 3, 4, 5, 1, 2, 3, 4, 5,
                                       2, 3, 4, 5, 3, 4, 5, 4, 5, 5};

__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                   __fmul_rn(a2, b2));
}

// Adds a scene point's 30 terms, matched to model point m (normal n) at
// squared distance `best`, to v; sn is the scene point's normal and weight.
__device__ __forceinline__ void add_terms(float (&v)[kTerms], const float (&m)[3],
                                          const float (&n)[3], const float (&sn)[4],
                                          float qx, float qy, float qz, float best,
                                          float maxd2, float min_cos, float tau2) {
  const float m0 = m[0], m1 = m[1], m2 = m[2];
  const float n0 = n[0], n1 = n[1], n2 = n[2];
  const float sn0 = sn[0], sn1 = sn[1], sn2 = sn[2], sw = sn[3];
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
    for (int b = a; b < 6; ++b, ++k) v[k] = __fadd_rn(v[k], __fmul_rn(wJ[a], J[b]));
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) v[21 + a] = __fadd_rn(v[21 + a], __fmul_rn(wJ[a], r));
  v[27] = __fadd_rn(v[27], __fmul_rn(__fmul_rn(w, r), r));
  v[28] = __fadd_rn(v[28], __fmul_rn(sw, best < tau2 ? 1.0f : 0.0f));
  v[29] = __fadd_rn(v[29], w);
}

// Sum of term k (threadIdx.x < kTerms) over the first `nwarps` warps of the
// block (group 0, which holds the terms): warp shuffles, then the warps in
// order. Every thread of the block calls it.
__device__ __forceinline__ float block_sum(float (&v)[kTerms],
                                           float (&warp_sums)[kMaxWarps][kTerms], int nwarps) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (warp < nwarps) {
#pragma unroll
    for (int k = 0; k < kTerms; ++k) {
      float x = v[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, off));
      }
      if (lane == 0) warp_sums[warp][k] = x;
    }
  }
  __syncthreads();
  float acc = 0.0f;
  if (threadIdx.x < kTerms) {
    acc = warp_sums[0][threadIdx.x];
    for (int w = 1; w < nwarps; ++w) acc = __fadd_rn(acc, warp_sums[w][threadIdx.x]);
  }
  return acc;
}

__device__ __forceinline__ void store_term(int k, float acc, int p, float* H, float* g,
                                           float* wsum, float* hits, float* wrr) {
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

template <int Q>
__global__ void __launch_bounds__(kMaxBlock)
nn_gn_kernel(const float* __restrict__ scene_all,  // [G, Ns, 3] anchored
             const float* __restrict__ nrm_all,    // [G, Ns, 3]
             const float* __restrict__ w_all,      // [G, Ns]
             const float* __restrict__ ref,        // [P, Nm, 3] anchored
             const float* __restrict__ ref_nrm,    // [P, Nm, 3]
             float* __restrict__ H,                // [P, 6, 6]
             float* __restrict__ g,                // [P, 6]
             float* __restrict__ wsum,             // [P]
             float* __restrict__ hits,             // [P]
             float* __restrict__ wrr,              // [P]
             float* __restrict__ partial,          // [P, scene_split, kTerms]
             unsigned int* __restrict__ arrived,   // [P], zero between launches
             int per_scene, int Ns, int Nm, int S, int scene_split, float maxd2,
             float min_cos, float tau2) {
  extern __shared__ float4 smem4[];
  const Staging st = staging(reinterpret_cast<float*>(smem4), Nm, S, true);
  __shared__ float warp_sums[kMaxWarps][kTerms];
  __shared__ bool last;

  const int p = blockIdx.y;
  const int t = blockIdx.x;
  const Lane ln = this_lane<kWidth>(S);
  const float* rp = ref + (size_t)p * Nm * 3;
  const float* rnp = ref_nrm + (size_t)p * Nm * 3;
  const size_t grp = (size_t)(p / per_scene) * Ns;  // this particle's scene block
  const float* scene = scene_all + grp * 3;
  const float* scene_nrm = nrm_all + grp * 3;
  const float* scene_w = w_all + grp;

  float v[kTerms];
#pragma unroll
  for (int k = 0; k < kTerms; ++k) v[k] = 0.0f;
  for (int c0 = 0; c0 < Ns; c0 += scene_split * Q * kWidth) {
    const int s0 = c0 + t * Q * kWidth + ln.l;
    Queries<Q> q;
    Best<Q> b;
    load_queries<Q>(scene, s0, Ns, ln, q);
    float sn[Q][4];  // normal and weight, loaded before the search needs them
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      const int s = min(s0 + k * kWidth, Ns - 1);
      sn[k][0] = scene_nrm[3 * s + 0];
      sn[k][1] = scene_nrm[3 * s + 1];
      sn[k][2] = scene_nrm[3 * s + 2];
      sn[k][3] = scene_w[s];
    }
    sweep<Q>(rp, rnp, Nm, ln, st, q, b);
    merge_groups<Q>(b, st.merge, ln);
    if (ln.g != 0) continue;
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      const int s = s0 + k * kWidth;
      if (s < Ns) {
        float m[3], n[3];
        fetch_match(st, rp, rnp, b.idx[k], m, n);
        add_terms(v, m, n, sn[k], q.x[k], q.y[k], q.z[k], b.d2[k], maxd2, min_cos, tau2);
      }
    }
  }

  const float acc = block_sum(v, warp_sums, kWidth / 32);
  if (scene_split == 1) {
    if (threadIdx.x < kTerms) store_term(threadIdx.x, acc, p, H, g, wsum, hits, wrr);
    return;
  }
  // The particle's blocks leave their sums in `partial`; the last to arrive
  // adds them in block order and resets the particle's count.
  float* mine = partial + (size_t)p * scene_split * kTerms;
  if (threadIdx.x < kTerms) mine[t * kTerms + threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();  // cumulative: the block's sums, seen through the barrier
    last = atomicAdd(&arrived[p], 1u) == (unsigned int)scene_split - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (threadIdx.x < kTerms) {
    float sum = __ldcg(mine + threadIdx.x);
    for (int o = 1; o < scene_split; ++o) {
      sum = __fadd_rn(sum, __ldcg(mine + o * kTerms + threadIdx.x));
    }
    store_term(threadIdx.x, sum, p, H, g, wsum, hits, wrr);
  }
  if (threadIdx.x == 0) arrived[p] = 0;
}

template <int Q>
cudaError_t launch_q(int P, int S, int scene_split, cudaStream_t st, const float* scene,
                     const float* scene_nrm, const float* scene_w, const float* ref,
                     const float* ref_nrm, float* H, float* g, float* wsum, float* hits,
                     float* wrr, float* partial, unsigned int* arrived, int per_scene, int Ns,
                     int Nm, float maxd2, float min_cos, float tau2) {
  nn_gn_kernel<Q><<<dim3(scene_split, P), kWidth * S, smem_bytes(Nm, Q, kWidth, S, true), st>>>(
      scene, scene_nrm, scene_w, ref, ref_nrm, H, g, wsum, hits, wrr, partial, arrived,
      per_scene, Ns, Nm, S, scene_split, maxd2, min_cos, tau2);
  return cudaGetLastError();
}

}  // namespace

// K3 with `q` scene points per thread, blocks of `S` groups of 128 threads
// that split the model cloud, and the scene split over `scene_split` blocks
// per particle. `scene`, `scene_nrm` and `scene_w` hold G scene blocks of Ns
// points, G a divisor of P (see the design notes). With scene_split > 1,
// `partial` holds P * scene_split * 30 floats and `arrived` P counters that
// are zero before the launch (the kernel leaves them zero).
extern "C" int nn_gn_launch(const float* scene, const float* scene_nrm,
                            const float* scene_w, const float* ref,
                            const float* ref_nrm, float* H, float* g, float* wsum,
                            float* hits, float* wrr, float* partial, unsigned int* arrived,
                            int P, int G, int Ns, int Nm, int q, int S, int scene_split,
                            float maxd2, float min_cos, float tau2, void* stream) {
  if (P <= 0 || P > 65535 || Ns <= 0 || Nm <= 0 || G <= 0 || P % G != 0 || bad_plan(q, S) ||
      scene_split < 1 ||
      (scene_split > 1 && (partial == nullptr || arrived == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const int per_scene = P / G;  // particles that share a scene block
  switch (q) {
    case 1:
      return (int)launch_q<1>(P, S, scene_split, st, scene, scene_nrm, scene_w, ref, ref_nrm,
                              H, g, wsum, hits, wrr, partial, arrived, per_scene, Ns, Nm, maxd2,
                              min_cos, tau2);
    case 2:
      return (int)launch_q<2>(P, S, scene_split, st, scene, scene_nrm, scene_w, ref, ref_nrm,
                              H, g, wsum, hits, wrr, partial, arrived, per_scene, Ns, Nm, maxd2,
                              min_cos, tau2);
    default:
      return (int)launch_q<4>(P, S, scene_split, st, scene, scene_nrm, scene_w, ref, ref_nrm,
                              H, g, wsum, hits, wrr, partial, arrived, per_scene, Ns, Nm, maxd2,
                              min_cos, tau2);
  }
}
