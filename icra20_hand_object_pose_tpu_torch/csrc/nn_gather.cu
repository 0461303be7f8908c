// Nearest-neighbour search, with (K1) or without (K2) the correspondence
// gather.
//
// K1 replaces the Pallas kernel `knn_pallas.nn_gather_batched`
// (icra20_hand_object_pose_tpu/ops/knn_pallas.py, `_make_gather_kernel`);
// K2 replaces `knn_pallas.nn_batched` (`_make_kernel`). For every particle p
// and query point s both find the reference point with the smallest exact
// FP32 squared distance and return that distance and the first minimal
// index; K1 also returns the matched point and normal at that index.
//
// What bounds them on Hopper: issued instructions on the CUDA cores, about
// 10 per (query, ref) pair for the exact, uncontracted arithmetic, and the
// latency of too few warps where the grid is small (see nn_search.cuh),
// against a few MB of input.
//
// Design: the search core of nn_search.cuh. Grid (tiles, P): each block
// takes Q * W queries of particle p; its S groups of W threads split the
// reference cloud and merge in group order. The [P, Ns, Nm] distance matrix
// never exists in device memory. K1 only: group 0 reads the matched point
// and normal at the winning index from the staged tiles, or the normal from
// global memory beyond kStagedNormals points (the TPU used a one-hot
// product). K2 is the same kernel with the gather compiled out, so the two
// cannot drift apart in arithmetic or tie order.
//
// The query batch Pq is any divisor of P: particle p reads query block
// p / (P / Pq). Pq == 1 is one query shared by all particles, Pq == P a query
// per particle, and anything between is one query (scene) per group of
// P / Pq consecutive particles: a library of objects searched in one launch.
// Plain C interface, loaded with ctypes; the launch goes on the caller's
// stream and the function returns its cudaError_t.

#include "nn_search.cuh"

namespace {

using namespace nn_search;

// K1 stages the normals beside the points (its gather then reads both from
// shared memory) up to this many reference points: the explorer and in-scan
// shapes gain, where few blocks leave the gather's latency exposed; the
// polish shape (Nm = 1024 over 576 blocks) loses more to staging twice the
// bytes than it saves.
constexpr int kStagedNormals = 256;

template <int Q, int W, bool kGather>
__global__ void __launch_bounds__(kMaxBlock)
nn_kernel(const float* __restrict__ query,      // [Pq, Ns, 3]
          const float* __restrict__ ref_pts,    // [P, Nm, 3]
          const float* __restrict__ ref_nrm,    // [P, Nm, 3] (K1 only)
          float* __restrict__ matched,          // [P, Ns, 3] (K1 only)
          float* __restrict__ mnormal,          // [P, Ns, 3] (K1 only)
          float* __restrict__ d2_out,           // [P, Ns]
          int* __restrict__ idx_out,            // [P, Ns]
          int per_query, int Ns, int Nm, int S, int stage_normals) {
  extern __shared__ float4 smem4[];
  const Staging st = staging(reinterpret_cast<float*>(smem4), Nm, S, stage_normals != 0);

  const int p = blockIdx.y;
  const Lane ln = this_lane<W>(S);
  const int s0 = blockIdx.x * Q * W + ln.l;
  const float* ref = ref_pts + (size_t)p * Nm * 3;
  const float* nrm = kGather ? ref_nrm + (size_t)p * Nm * 3 : nullptr;

  Queries<Q> q;
  Best<Q> b;
  load_queries<Q>(query + (size_t)(p / per_query) * Ns * 3, s0, Ns, ln, q);
  sweep<Q>(ref, st.nrm != nullptr ? nrm : nullptr, Nm, ln, st, q, b);
  merge_groups<Q>(b, st.merge, ln);
  if (ln.g != 0) return;

#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const int s = s0 + k * W;
    if (s >= Ns) continue;
    const size_t out = (size_t)p * Ns + s;
    d2_out[out] = b.d2[k];
    idx_out[out] = b.idx[k];
    if constexpr (kGather) {
      float m[3], n[3];
      fetch_match(st, ref, nrm, b.idx[k], m, n);
      matched[out * 3 + 0] = m[0];
      matched[out * 3 + 1] = m[1];
      matched[out * 3 + 2] = m[2];
      mnormal[out * 3 + 0] = n[0];
      mnormal[out * 3 + 1] = n[1];
      mnormal[out * 3 + 2] = n[2];
    }
  }
}

template <int Q, int W, bool kGather>
cudaError_t launch_q(int P, int Ns, int Nm, int S, cudaStream_t st,
                     const float* query, const float* ref_pts, const float* ref_nrm,
                     float* matched, float* mnormal, float* d2, int* idx, int per_query) {
  const dim3 grid((Ns + Q * W - 1) / (Q * W), P);
  const bool normals = kGather && Nm <= kStagedNormals;
  nn_kernel<Q, W, kGather><<<grid, W * S, smem_bytes(Nm, Q, W, S, normals), st>>>(
      query, ref_pts, ref_nrm, matched, mnormal, d2, idx, per_query, Ns, Nm, S, normals ? 1 : 0);
  return cudaGetLastError();
}

template <int W, bool kGather>
cudaError_t launch_w(int q, int P, int Ns, int Nm, int S, cudaStream_t st, const float* query,
                     const float* ref_pts, const float* ref_nrm, float* matched,
                     float* mnormal, float* d2, int* idx, int per_query) {
  switch (q) {
    case 1:
      return launch_q<1, W, kGather>(P, Ns, Nm, S, st, query, ref_pts, ref_nrm, matched,
                                     mnormal, d2, idx, per_query);
    case 2:
      return launch_q<2, W, kGather>(P, Ns, Nm, S, st, query, ref_pts, ref_nrm, matched,
                                     mnormal, d2, idx, per_query);
    default:
      return launch_q<4, W, kGather>(P, Ns, Nm, S, st, query, ref_pts, ref_nrm, matched,
                                     mnormal, d2, idx, per_query);
  }
}

template <bool kGather>
int launch_nn(const float* query, const float* ref_pts, const float* ref_nrm,
              float* matched, float* mnormal, float* d2, int* idx, int P, int Pq,
              int Ns, int Nm, int q, int width, int S, void* stream) {
  if (P <= 0 || P > 65535 || Ns <= 0 || Nm <= 0 || Pq <= 0 || P % Pq != 0 || bad_plan(q, S) ||
      (width != 64 && width != kWidth)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const int per_query = P / Pq;  // particles that share a query block
  return (int)(width == 64 ? launch_w<64, kGather>(q, P, Ns, Nm, S, st, query, ref_pts,
                                                   ref_nrm, matched, mnormal, d2, idx, per_query)
                           : launch_w<kWidth, kGather>(q, P, Ns, Nm, S, st, query, ref_pts,
                                                       ref_nrm, matched, mnormal, d2, idx,
                                                       per_query));
}

}  // namespace

// K1: search + gather over Pq query blocks (Pq a divisor of P), with `q`
// queries per thread, groups of `width`
// threads (64 or 128) and the reference cloud split over `S` groups of a
// block.
extern "C" int nn_gather_launch(const float* query, const float* ref_pts,
                                const float* ref_nrm, float* matched,
                                float* mnormal, float* d2, int* idx, int P,
                                int Pq, int Ns, int Nm, int q, int width, int S,
                                void* stream) {
  return launch_nn<true>(query, ref_pts, ref_nrm, matched, mnormal, d2, idx, P, Pq, Ns,
                         Nm, q, width, S, stream);
}

// K2: search only.
extern "C" int nn_launch(const float* query, const float* ref_pts, float* d2,
                         int* idx, int P, int Pq, int Ns, int Nm, int q, int width, int S,
                         void* stream) {
  return launch_nn<false>(query, ref_pts, nullptr, nullptr, nullptr, d2, idx, P, Pq, Ns,
                          Nm, q, width, S, stream);
}
