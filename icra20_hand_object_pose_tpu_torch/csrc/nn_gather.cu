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
// What bounds them on Hopper: FP32 work on the CUDA cores. Each (query, ref)
// pair costs 3 subtractions, 3 multiplies, 2 adds and a compare (about 9
// operations), while a point is about 16 bytes (12 of coordinates, plus its
// share of the gathered normal) read once per block. At the in-scan shape
// (P=512, Ns=512, Nm=256) that is 67M pairs against a few MB of input, far
// above the card's bytes-per-operation line.
//
// Design:
//   - one block per (particle, tile of kQueryTile queries); one thread owns
//     one query and keeps its running (min d2, argmin) in registers;
//   - the block walks the reference cloud in tiles of kRefTile points that
//     it stages in shared memory, so the [P, Ns, Nm] distance matrix never
//     exists in device memory;
//   - distances are dx*dx + dy*dy + dz*dz with explicitly rounded multiplies
//     and adds (no FMA contraction), the same operations as the plain
//     PyTorch version, so both give bitwise-equal d2;
//   - indices are scanned in increasing order with a strict `<`, so the
//     first minimal index wins, as in `torch.argmin` and `jnp.argmin`;
//   - the ragged last tile is bounded by Nm, no padding sentinel;
//   - K1 only: after the search, the matched point and normal are read from
//     global memory at the winning index (no one-hot product). K2 is the
//     same kernel with the gather compiled out (template flag).
//
// The query is either shared by all particles (Pq == 1) or per particle
// (Pq == P). Plain C interface, loaded with ctypes; the launch goes on the
// caller's stream and the function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kQueryTile = 128;  // threads per block, one query each
constexpr int kRefTile = 256;    // reference points staged per shared tile

template <bool kGather>
__global__ void __launch_bounds__(kQueryTile)
nn_kernel(const float* __restrict__ query,      // [Pq, Ns, 3]
          const float* __restrict__ ref_pts,    // [P, Nm, 3]
          const float* __restrict__ ref_nrm,    // [P, Nm, 3] (K1 only)
          float* __restrict__ matched,          // [P, Ns, 3] (K1 only)
          float* __restrict__ mnormal,          // [P, Ns, 3] (K1 only)
          float* __restrict__ d2_out,           // [P, Ns]
          int* __restrict__ idx_out,            // [P, Ns]
          int shared_query, int Ns, int Nm) {
  __shared__ float tile[3 * kRefTile];

  const int p = blockIdx.x;
  const int s = blockIdx.y * kQueryTile + threadIdx.x;
  const bool active = s < Ns;

  const float* q = query + ((shared_query ? 0 : (size_t)p * Ns) + (active ? s : 0)) * 3;
  const float qx = q[0], qy = q[1], qz = q[2];
  const float* ref = ref_pts + (size_t)p * Nm * 3;

  float best = INFINITY;
  int best_i = 0;
  for (int j0 = 0; j0 < Nm; j0 += kRefTile) {
    const int n = min(kRefTile, Nm - j0);
    __syncthreads();  // the previous tile is no longer read
    for (int k = threadIdx.x; k < 3 * n; k += kQueryTile) {
      tile[k] = ref[(size_t)j0 * 3 + k];
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
  if (!active) return;

  const size_t out = (size_t)p * Ns + s;
  d2_out[out] = best;
  idx_out[out] = best_i;
  if constexpr (kGather) {
    const size_t src = ((size_t)p * Nm + best_i) * 3;
    matched[out * 3 + 0] = ref_pts[src + 0];
    matched[out * 3 + 1] = ref_pts[src + 1];
    matched[out * 3 + 2] = ref_pts[src + 2];
    mnormal[out * 3 + 0] = ref_nrm[src + 0];
    mnormal[out * 3 + 1] = ref_nrm[src + 1];
    mnormal[out * 3 + 2] = ref_nrm[src + 2];
  }
}

bool bad_shape(int P, int Pq, int Ns, int Nm) {
  return P <= 0 || Ns <= 0 || Nm <= 0 || (Pq != 1 && Pq != P);
}

}  // namespace

// K1: search + gather.
extern "C" int nn_gather_launch(const float* query, const float* ref_pts,
                                const float* ref_nrm, float* matched,
                                float* mnormal, float* d2, int* idx, int P,
                                int Pq, int Ns, int Nm, void* stream) {
  if (bad_shape(P, Pq, Ns, Nm)) return (int)cudaErrorInvalidValue;
  const dim3 grid(P, (Ns + kQueryTile - 1) / kQueryTile);
  nn_kernel<true><<<grid, kQueryTile, 0, (cudaStream_t)stream>>>(
      query, ref_pts, ref_nrm, matched, mnormal, d2, idx, Pq == 1 ? 1 : 0, Ns,
      Nm);
  return (int)cudaGetLastError();
}

// K2: search only.
extern "C" int nn_launch(const float* query, const float* ref_pts, float* d2,
                         int* idx, int P, int Pq, int Ns, int Nm, void* stream) {
  if (bad_shape(P, Pq, Ns, Nm)) return (int)cudaErrorInvalidValue;
  const dim3 grid(P, (Ns + kQueryTile - 1) / kQueryTile);
  nn_kernel<false><<<grid, kQueryTile, 0, (cudaStream_t)stream>>>(
      query, ref_pts, nullptr, nullptr, nullptr, d2, idx, Pq == 1 ? 1 : 0, Ns,
      Nm);
  return (int)cudaGetLastError();
}
