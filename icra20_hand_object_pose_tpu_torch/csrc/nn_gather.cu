// Fused nearest-neighbour search + correspondence gather (kernel K1).
//
// Replaces the Pallas kernel `knn_pallas.nn_gather_batched`
// (icra20_hand_object_pose_tpu/ops/knn_pallas.py, `_make_gather_kernel`).
// For every particle p and query point s it finds the reference point with
// the smallest exact FP32 squared distance and returns that distance, the
// first minimal index, and the matched point and normal at that index.
//
// What bounds it on Hopper: FP32 work on the CUDA cores. Each (query, ref)
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
//   - after the search, the matched point and normal are read from global
//     memory at the winning index (no one-hot product).
//
// The query is either shared by all particles (Pq == 1) or per particle
// (Pq == P). Plain C interface, loaded with ctypes; the launch goes on the
// caller's stream and the function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kQueryTile = 128;  // threads per block, one query each
constexpr int kRefTile = 256;    // reference points staged per shared tile

__global__ void __launch_bounds__(kQueryTile)
nn_gather_kernel(const float* __restrict__ query,      // [Pq, Ns, 3]
                 const float* __restrict__ ref_pts,    // [P, Nm, 3]
                 const float* __restrict__ ref_nrm,    // [P, Nm, 3]
                 float* __restrict__ matched,          // [P, Ns, 3]
                 float* __restrict__ mnormal,          // [P, Ns, 3]
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
  const size_t src = ((size_t)p * Nm + best_i) * 3;
  d2_out[out] = best;
  idx_out[out] = best_i;
  matched[out * 3 + 0] = ref_pts[src + 0];
  matched[out * 3 + 1] = ref_pts[src + 1];
  matched[out * 3 + 2] = ref_pts[src + 2];
  mnormal[out * 3 + 0] = ref_nrm[src + 0];
  mnormal[out * 3 + 1] = ref_nrm[src + 1];
  mnormal[out * 3 + 2] = ref_nrm[src + 2];
}

}  // namespace

extern "C" int nn_gather_launch(const float* query, const float* ref_pts,
                                const float* ref_nrm, float* matched,
                                float* mnormal, float* d2, int* idx, int P,
                                int Pq, int Ns, int Nm, void* stream) {
  if (P <= 0 || Ns <= 0 || Nm <= 0 || (Pq != 1 && Pq != P)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(P, (Ns + kQueryTile - 1) / kQueryTile);
  nn_gather_kernel<<<grid, kQueryTile, 0, (cudaStream_t)stream>>>(
      query, ref_pts, ref_nrm, matched, mnormal, d2, idx, Pq == 1 ? 1 : 0, Ns,
      Nm);
  return (int)cudaGetLastError();
}
