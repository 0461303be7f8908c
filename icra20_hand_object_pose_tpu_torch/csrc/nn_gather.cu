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
// never exists in device memory. K1 only: the reference cloud is the model
// cloud of particle p's object (o = p / pts_div, at o * obj_stride) in the
// model frame, with the particle's pose: the block reads the pose into
// registers once and poses each point (and normal) as it stages the tile
// (nn_search.cuh's posing), so no posed cloud is written or read; group 0
// reads the matched point and normal at the winning index from the staged
// tiles, or poses the normal from global memory beyond kStagedNormals points
// (the TPU used a one-hot product on clouds posed in XLA). K2 is the same
// kernel with the posing and the gather compiled out, on posed clouds [P,
// Nm, 3], so the two cannot drift apart in arithmetic or tie order.
//
// The query batch Pq is any divisor of P: particle p reads query block
// p / (P / Pq). Pq == 1 is one query shared by all particles, Pq == P a query
// per particle, and anything between is one query (scene) per group of
// P / Pq consecutive particles: a library of objects searched in one launch.
// K1's model clouds come likewise, one per pts_div consecutive particles.
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
          const float* __restrict__ poses,      // [P, 4, 4] (K1 only)
          const float* __restrict__ ref_pts,    // K1: model clouds [Nm, 3] at
                                                // o * ref_stride; K2: [P, Nm, 3]
          const float* __restrict__ ref_nrm,    // K1 only, as ref_pts
          float* __restrict__ matched,          // [P, Ns, 3] (K1 only)
          float* __restrict__ mnormal,          // [P, Ns, 3] (K1 only)
          float* __restrict__ d2_out,           // [P, Ns]
          int* __restrict__ idx_out,            // [P, Ns]
          long long ref_stride, int ref_div, int per_query, int Ns, int Nm, int S,
          int stage_normals) {
  extern __shared__ float4 smem4[];
  const Staging st = staging(reinterpret_cast<float*>(smem4), Nm, S, stage_normals != 0);

  const int p = blockIdx.y;
  const Lane ln = this_lane<W>(S);
  const int s0 = blockIdx.x * Q * W + ln.l;
  const long long at = (p / ref_div) * ref_stride;  // this particle's reference cloud
  const float* ref = ref_pts + at;
  const float* nrm = kGather ? ref_nrm + at : nullptr;
  Pose pose{};
  if constexpr (kGather) pose = load_pose(poses + (size_t)p * 16);

  Queries<Q> q;
  Best<Q> b;
  load_queries<Q>(query + (size_t)(p / per_query) * Ns * 3, s0, Ns, ln, q);
  sweep<Q, kGather>(ref, st.nrm != nullptr ? nrm : nullptr, Nm, ln, st, q, b, pose);
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
      fetch_match<true>(st, ref, nrm, b.idx[k], m, n, pose);
      matched[out * 3 + 0] = m[0];
      matched[out * 3 + 1] = m[1];
      matched[out * 3 + 2] = m[2];
      mnormal[out * 3 + 0] = n[0];
      mnormal[out * 3 + 1] = n[1];
      mnormal[out * 3 + 2] = n[2];
    }
  }
}

// The arguments every launch passes on to nn_kernel.
struct Args {
  const float *query, *poses, *ref_pts, *ref_nrm;
  float *matched, *mnormal, *d2;
  int* idx;
  long long ref_stride;
  int ref_div, per_query, P, Ns, Nm, S;
};

template <int Q, int W, bool kGather>
cudaError_t launch_q(const Args& a, cudaStream_t st) {
  const dim3 grid((a.Ns + Q * W - 1) / (Q * W), a.P);
  const bool normals = kGather && a.Nm <= kStagedNormals;
  nn_kernel<Q, W, kGather><<<grid, W * a.S, smem_bytes(a.Nm, Q, W, a.S, normals), st>>>(
      a.query, a.poses, a.ref_pts, a.ref_nrm, a.matched, a.mnormal, a.d2, a.idx, a.ref_stride,
      a.ref_div, a.per_query, a.Ns, a.Nm, a.S, normals ? 1 : 0);
  return cudaGetLastError();
}

template <int W, bool kGather>
cudaError_t launch_w(int q, const Args& a, cudaStream_t st) {
  switch (q) {
    case 1:
      return launch_q<1, W, kGather>(a, st);
    case 2:
      return launch_q<2, W, kGather>(a, st);
    default:
      return launch_q<4, W, kGather>(a, st);
  }
}

template <bool kGather>
int launch_nn(const Args& a, int Pq, int q, int width, void* stream) {
  if (a.P <= 0 || a.P > 65535 || a.Ns <= 0 || a.Nm <= 0 || Pq <= 0 || a.P % Pq != 0 ||
      a.ref_div <= 0 || a.P % a.ref_div != 0 || bad_plan(q, a.S) ||
      (width != 64 && width != kWidth)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(width == 64 ? launch_w<64, kGather>(q, a, st)
                           : launch_w<kWidth, kGather>(q, a, st));
}

}  // namespace

// K1: posing + search + gather over Pq query blocks (Pq a divisor of P)
// and P / pts_div model clouds (object o's at obj_stride * o), with `q`
// queries per thread, groups of `width` threads (64 or 128) and the
// reference cloud split over `S` groups of a block.
extern "C" int nn_gather_launch(const float* query, const float* poses,
                                const float* model_pts, const float* model_nrm,
                                float* matched, float* mnormal, float* d2, int* idx,
                                long long obj_stride, int P, int Pq, int Ns, int Nm,
                                int pts_div, int q, int width, int S, void* stream) {
  const Args a{query, poses, model_pts, model_nrm, matched, mnormal, d2, idx, obj_stride,
               pts_div, Pq > 0 ? P / Pq : 0, P, Ns, Nm, S};
  return launch_nn<true>(a, Pq, q, width, stream);
}

// K2: search only, on posed clouds.
extern "C" int nn_launch(const float* query, const float* ref_pts, float* d2,
                         int* idx, int P, int Pq, int Ns, int Nm, int q, int width, int S,
                         void* stream) {
  const Args a{query, nullptr, ref_pts, nullptr, nullptr, nullptr, d2, idx,
               (long long)Nm * 3, 1, Pq > 0 ? P / Pq : 0, P, Ns, Nm, S};
  return launch_nn<false>(a, Pq, q, width, stream);
}
