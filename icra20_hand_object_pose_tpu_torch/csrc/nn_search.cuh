// The nearest-neighbour search core shared by K1/K2 (nn_gather.cu) and K3
// (nn_gn.cu): one copy of the distance arithmetic, the tie order, and the
// merge of a reference cloud split over the thread groups of a block.
//
// What bounds the search on Hopper: issued instructions on the CUDA cores,
// and at the small grids of the main path the latency of too few warps. A
// (query, ref) pair costs 3 subtractions, 3 multiplies and 2 adds with
// explicit rounding (__fsub_rn/__fmul_rn/__fadd_rn, no FMA contraction), so
// d2 is bitwise the plain PyTorch version's and the poses are bitwise stable
// across machines. A strict `<` with a select of d2 and of the index adds 3
// more: about 11 instructions per pair, 33.5 T lane-instructions/s on 132
// SMs at 1.98 GHz.
//
// Design:
//   - a block is S groups of W threads (K1/K2: 64 or 128, K3: 128). Each
//     thread owns Q queries, strided by W, so that the per-query loads and
//     stores stay coalesced; the Q running minima live in registers and give Q
//     independent chains;
//   - the S groups take the same queries and split the reference cloud into
//     S contiguous ranges: S times the warps for a query tile, which hides
//     latency where the grid is small (a split over the blocks of a
//     thread-block cluster cost more in its launch and barriers than it
//     gave, at every main-path shape). The block stages each group's range
//     (in steps where it exceeds kBlockTile points in all) in shared memory
//     as x, y, z triples, 16-byte aligned: a group of 8 points is six
//     broadcast 128-bit loads, issued before their first use, feeding Q
//     distance evaluations each;
//   - the running minimum takes one min per pair (fminf); the index is not
//     selected per pair but per group of kGroup consecutive points: a group
//     whose minimum is strictly below the minimum before it records its
//     first index. After the sweep, the recorded group is evaluated again
//     (kGroup independent evaluations) with the same arithmetic and its
//     first point at the minimum is the index: the first minimal index over
//     increasing j, as a strict `<` per pair and torch.argmin give, with
//     about 9.7 instructions a pair instead of 11;
//   - group 0 merges the other groups' (d2, idx) through shared memory in
//     group order, lexicographically: the first minimal index still wins,
//     with no atomics and no second launch.
//
// Posing (K1 only, a compile-time switch of the functions below): the
// reference cloud comes in the model frame with the particle's pose, and each
// point is posed where it is read, as the tile is staged and where a match
// or a resolve reads the global cloud, with the arithmetic and rounding of
// se3.transform_points / rotate_vectors: the posed floats are bitwise
// theirs, and no [P, Nm, 3] posed cloud is written to device memory.
//
// The launch plan (Q, S, and K3's scene split) is chosen in Python
// (ops/knn_cuda.py, `nn_plan` / `gn_plan`) and passed to the C entry points.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace nn_search {

constexpr int kWidth = 128;       // threads per group, at most (K3's width)
constexpr int kBlockTile = 1024;  // reference points a block stages per step, at most
constexpr int kGroup = 8;         // points per index group
constexpr int kMaxGroups = 4;     // groups per block, at most
constexpr int kMaxBlock = kWidth * kMaxGroups;

template <int Q>
struct Queries {
  float x[Q], y[Q], z[Q];
};

template <int Q>
struct Best {
  float d2[Q];
  int idx[Q];
};

// This thread's place in its block: lane l of group g, of S groups of W
// threads (W a compile-time constant of the kernel).
struct Lane {
  int g, l, S, W;
};

template <int W>
__device__ __forceinline__ Lane this_lane(int S) {
  return Lane{(int)threadIdx.x / W, (int)threadIdx.x % W, S, W};
}

// A particle's pose: the first three rows of its [4, 4] matrix, row i at
// r[4 i .. 4 i + 3] (rotation, then translation).
struct Pose {
  float r[12];
};

__device__ __forceinline__ Pose load_pose(const float* __restrict__ T) {
  Pose pose;
#pragma unroll
  for (int i = 0; i < 12; ++i) pose.r[i] = T[i];
  return pose;
}

// The 3 floats at v posed into o: se3._rotate_fma's ((r0 x + r1 y) + r2 z),
// then + t for a point (kPoint), every product and sum rounded on its own.
// Without kPosed, a copy.
template <bool kPosed, bool kPoint>
__device__ __forceinline__ void read_posed(const Pose& pose, const float* v, float (&o)[3]) {
  const float x = v[0], y = v[1], z = v[2];
  if constexpr (!kPosed) {
    o[0] = x, o[1] = y, o[2] = z;
    return;
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float* r = pose.r + 4 * i;
      const float rv = __fadd_rn(__fadd_rn(__fmul_rn(r[0], x), __fmul_rn(r[1], y)),
                                 __fmul_rn(r[2], z));
      o[i] = kPoint ? __fadd_rn(rv, r[3]) : rv;
    }
  }
}

// Squared distance, rounded step by step as the plain version computes it.
__device__ __forceinline__ float dist2(float rx, float ry, float rz, float qx, float qy,
                                       float qz) {
  const float dx = __fsub_rn(rx, qx);
  const float dy = __fsub_rn(ry, qy);
  const float dz = __fsub_rn(rz, qz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// Loads this thread's Q queries s0 + k * W from `q` ([Ns, 3]); a query
// past Ns reads query 0 (its result is never stored).
template <int Q>
__device__ __forceinline__ void load_queries(const float* __restrict__ q, int s0, int Ns,
                                             const Lane& ln, Queries<Q>& out) {
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const int s = s0 + k * ln.W;
    const float* p = q + (size_t)(s < Ns ? s : 0) * 3;
    out.x[k] = p[0];
    out.y[k] = p[1];
    out.z[k] = p[2];
  }
}

// Points of each group's range, and of each group's tile in shared memory.
__host__ __device__ __forceinline__ int range_len(int Nm, int S) { return (Nm + S - 1) / S; }
// A group's tile: its whole range where the block's S tiles fit
// kBlockTile points (every main-path shape), else steps of kBlockTile / S;
// a multiple of 4 points, so that every tile and every group of kGroup
// points in it starts on 16 bytes.
__host__ __device__ __forceinline__ int tile_len(int Nm, int S) {
  const int per = range_len(Nm, S);
  const int n = per < kBlockTile / S ? per : kBlockTile / S;
  return (n + 3) / 4 * 4;
}

// The kGroup staged points t[0, 3 kGroup) (x, y, z each; t on 16 bytes),
// reference indices [jg, jg + kGroup): the running minima take them in, and
// a query whose minimum drops records jg.
template <int Q>
__device__ __forceinline__ void visit_group(const float* t, int jg, const Queries<Q>& q,
                                            Best<Q>& b) {
  // the group's 3 * kGroup floats as 16-byte loads, all issued before use
  float r[3 * kGroup];
#pragma unroll
  for (int i = 0; i < 3 * kGroup / 4; ++i) {
    const float4 v = reinterpret_cast<const float4*>(t)[i];
    r[4 * i + 0] = v.x;
    r[4 * i + 1] = v.y;
    r[4 * i + 2] = v.z;
    r[4 * i + 3] = v.w;
  }
  float before[Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) before[k] = b.d2[k];
#pragma unroll
  for (int jj = 0; jj < kGroup; ++jj) {
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      b.d2[k] = fminf(b.d2[k], dist2(r[3 * jj], r[3 * jj + 1], r[3 * jj + 2], q.x[k], q.y[k],
                                     q.z[k]));
    }
  }
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    if (b.d2[k] < before[k]) b.idx[k] = jg;
  }
}

// visit_group for the m < kGroup points at the end of a range, one by one.
template <int Q>
__device__ __forceinline__ void visit_tail(const float* t, int m, int jg, const Queries<Q>& q,
                                           Best<Q>& b) {
  float before[Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) before[k] = b.d2[k];
#pragma unroll 1
  for (int jj = 0; jj < m; ++jj) {
    const float rx = t[3 * jj + 0], ry = t[3 * jj + 1], rz = t[3 * jj + 2];
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      b.d2[k] = fminf(b.d2[k], dist2(rx, ry, rz, q.x[k], q.y[k], q.z[k]));
    }
  }
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    if (b.d2[k] < before[k]) b.idx[k] = jg;
  }
}

// Resolves query k's recorded group [lo, lo + kGroup) (cut at `end`) to its
// first point at the minimum: kGroup independent evaluations of the same
// arithmetic on the points pts[3 (j - base) ...] (posed by `pose` where
// kPosed), then the lowest match.
template <int Q, bool kPosed = false>
__device__ __forceinline__ int resolve(const float* pts, int base, int lo, int end,
                                       const Queries<Q>& q, int k, float best,
                                       const Pose& pose = Pose{}) {
  int found = lo;
#pragma unroll
  for (int jj = kGroup - 1; jj >= 0; --jj) {
    const int j = lo + jj;
    float r[3];  // always a valid point
    read_posed<kPosed, true>(pose, pts + 3 * (max(base, min(j, end - 1)) - base), r);
    const bool hit = dist2(r[0], r[1], r[2], q.x[k], q.y[k], q.z[k]) == best;
    found = hit & (j < end) ? j : found;  // no branch: every load is issued
  }
  return found;
}

// The block's dynamic shared memory: the S groups' point tiles, then (where
// the normals are staged) their normal tiles, then the merge buffer.
struct Staging {
  float* pts;    // 3 * S * T floats
  float* nrm;    // 3 * S * T floats, or nullptr
  float* merge;  // (S - 1) * Q * W floats and as many ints
  int per, T;    // points per group's range, per tile
};

__device__ __forceinline__ Staging staging(float* smem, int Nm, int S, bool normals) {
  const int T = tile_len(Nm, S);
  float* nrm = normals ? smem + 3 * S * T : nullptr;
  return Staging{smem, nrm, smem + (normals ? 6 : 3) * S * T, range_len(Nm, S), T};
}

inline size_t smem_bytes(int Nm, int q, int W, int S, bool normals) {
  return (size_t)(normals ? 6 : 3) * S * tile_len(Nm, S) * sizeof(float) +
         (size_t)(S - 1) * q * W * (sizeof(float) + sizeof(int));
}

// Sweeps this thread's group's range of `ref` ([Nm, 3]) for its queries and
// resolves each query to its first minimal index in the range; stages
// `nrm` ([Nm, 3]) beside the points when it is given. With kPosed, `ref`
// and `nrm` are in the model frame and are staged (and read) posed by
// `pose`. Every thread of the block calls it (it syncs).
template <int Q, bool kPosed = false>
__device__ __forceinline__ void sweep(const float* __restrict__ ref,
                                      const float* __restrict__ nrm, int Nm, const Lane& ln,
                                      const Staging& st, const Queries<Q>& q, Best<Q>& b,
                                      const Pose& pose = Pose{}) {
  const int per = st.per, T = st.T;
  const int begin = min(Nm, ln.g * per);
  const int end = min(Nm, begin + per);
  const float* tile = st.pts + 3 * ln.g * T;
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    b.d2[k] = INFINITY;
    b.idx[k] = begin;
  }
  for (int t0 = 0; t0 < per; t0 += T) {
    __syncthreads();  // the previous tiles are no longer read
    // group h's tile holds its points [t0, t0 + T): 3T consecutive floats
    for (int h = 0; h < ln.S; ++h) {
      const int j0 = min(Nm, h * per) + t0;
      const int m = max(0, min(T, min(Nm, (h + 1) * per) - j0));
      if constexpr (kPosed) {  // a point (and its normal) a thread, posed
        for (int i = threadIdx.x; i < m; i += blockDim.x) {
          float v[3];
          read_posed<true, true>(pose, ref + (size_t)(j0 + i) * 3, v);
          float* dst = st.pts + 3 * (h * T + i);
          dst[0] = v[0], dst[1] = v[1], dst[2] = v[2];
          if (nrm != nullptr) {
            read_posed<true, false>(pose, nrm + (size_t)(j0 + i) * 3, v);
            dst = st.nrm + 3 * (h * T + i);
            dst[0] = v[0], dst[1] = v[1], dst[2] = v[2];
          }
        }
      } else {  // a float a thread
        for (int i = threadIdx.x; i < 3 * m; i += blockDim.x) {
          st.pts[3 * h * T + i] = ref[(size_t)j0 * 3 + i];
          if (nrm != nullptr) st.nrm[3 * h * T + i] = nrm[(size_t)j0 * 3 + i];
        }
      }
    }
    __syncthreads();
    const int j0 = begin + t0;
    const int n = max(0, min(T, end - j0));
    const int full = n - n % kGroup;
#pragma unroll 2
    for (int g = 0; g < full; g += kGroup) visit_group<Q>(tile + 3 * g, j0 + g, q, b);
    if (full < n) visit_tail<Q>(tile + 3 * full, n - full, j0 + full, q, b);
  }
  // The recorded group ends at `end` at the latest; its points are still
  // staged when the range fits one tile.
  if (per <= T) {
#pragma unroll
    for (int k = 0; k < Q; ++k) b.idx[k] = resolve<Q>(tile, begin, b.idx[k], end, q, k, b.d2[k]);
  } else {
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      b.idx[k] = resolve<Q, kPosed>(ref, 0, b.idx[k], end, q, k, b.d2[k], pose);
    }
  }
}

// Reference point j and its normal: the point from the tiles when every
// range fits one tile (it is then still staged after the sweep), else from
// `ref`; the normal likewise from the normal tiles where they were staged,
// else from `nrm`. What is read from `ref` or `nrm` is posed by `pose`
// where kPosed, as the tiles were. The same floats either way.
template <bool kPosed = false>
__device__ __forceinline__ void fetch_match(const Staging& st, const float* __restrict__ ref,
                                            const float* __restrict__ nrm, int j,
                                            float (&m)[3], float (&n)[3],
                                            const Pose& pose = Pose{}) {
  const float* staged_n = nullptr;
  if (st.per <= st.T) {
    int h = 0;  // j's group, without a division (S <= kMaxGroups)
#pragma unroll
    for (int o = 1; o < kMaxGroups; ++o) h += j >= o * st.per ? 1 : 0;
    const int at = 3 * (h * st.T + j - h * st.per);
    m[0] = st.pts[at], m[1] = st.pts[at + 1], m[2] = st.pts[at + 2];
    if (st.nrm != nullptr) staged_n = st.nrm + at;
  } else {
    read_posed<kPosed, true>(pose, ref + (size_t)j * 3, m);
  }
  if (staged_n != nullptr) {
    n[0] = staged_n[0], n[1] = staged_n[1], n[2] = staged_n[2];
  } else {
    read_posed<kPosed, false>(pose, nrm + (size_t)j * 3, n);
  }
}

// Merges the (d2, idx) of groups 1..S-1 into group 0's `b`, in group order,
// lexicographically on (d2, idx). `buf` is Staging::merge.
// Every thread of the block calls it (it syncs).
template <int Q>
__device__ __forceinline__ void merge_groups(Best<Q>& b, float* buf, const Lane& ln) {
  if (ln.S == 1) return;
  const int n = (ln.S - 1) * Q * ln.W;
  int* buf_idx = reinterpret_cast<int*>(buf + n);
  if (ln.g > 0) {
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      const int at = ((ln.g - 1) * Q + k) * ln.W + ln.l;
      buf[at] = b.d2[k];
      buf_idx[at] = b.idx[k];
    }
  }
  __syncthreads();
  if (ln.g != 0) return;
  for (int o = 1; o < ln.S; ++o) {
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      const int at = ((o - 1) * Q + k) * ln.W + ln.l;
      const float d = buf[at];
      const int i = buf_idx[at];
      if (d < b.d2[k] || (d == b.d2[k] && i < b.idx[k])) {
        b.d2[k] = d;
        b.idx[k] = i;
      }
    }
  }
}

// The launch-plan limits every entry point checks: q in {1, 2, 4} and
// 1 <= S <= kMaxGroups (the shared memory then stays within 48 KB).
inline bool bad_plan(int q, int S) {
  return (q != 1 && q != 2 && q != 4) || S < 1 || S > kMaxGroups;
}

}  // namespace nn_search
