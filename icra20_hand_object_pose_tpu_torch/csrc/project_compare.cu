// Point-mode projective scoring of pose hypotheses (kernel K6): each
// particle's pose applied to its object's render samples and normals, every
// sample projected, culled, looked up in the encoded observed image and the
// hand image, classified and reduced, in one launch, one block per particle.
// No [O, P, N] tensor is ever written.
//
// Replaces no TPU kernel. On the TPU `score.compare_points` is XLA inside the
// frame program (its image lookups one-hot matrix products, "mxu"). The port
// ran it as 200-300 ATen operators a call on [O, P, N] tensors, several of
// them int64 indices: the posing, four corner lookups of a dozen index and
// mask operations each, the edge-aware combine and the classification, and
// under the "take" rule the [(H+1)(W+1), 4] quad table built anew each call.
// A tracked frame scores 18 times, a sweep step 18 times for its library.
//
// For particle b (object o = b / pts_div) with pose T and samples (x_s, n_s)
// it computes what `score.compare_points` computes on se3.transform_points(T,
// x) and se3.rotate_vectors(T, n), sample for sample:
//   - posing as `se3._rotate_fma` runs it, ((r0 x + r1 y) + r2 z) + t, each
//     product and sum rounded alone; facing = n.p < 0, its three products
//     summed as ATen's CUDA reduction sums a last axis of 3, (a0 + a2) + a1;
//   - in_front = z > 1e-6; u = x / z * fx + cx, v likewise; ui = rint(u),
//     vi = rint(v) (half to even, as torch.round); inb = the pixel in the
//     image. A sample outside in_front, inb or facing counts nowhere;
//   - the lookup rule (template argument):
//       kTake:  enc and hand read at the pixel; sub-pixel corners outside
//               the image read _FAR, as `score.pack_quad`'s border does (the
//               table itself is never built); hand occludes where hand <
//               z - margin;
//       kImage: ("mxu", "image") a read outside the image is 0.0;
//       kPatch: ("mxu", "patch") a read outside the image or outside the
//               sample's [size, size] patch at (pv0, pu0) is 0.0;
//     under both "mxu" rules the hand occludes where 0 < hand < z - margin;
//   - sub-pixel (template argument): `score._edge_aware_combine` of the 2x2
//     cell at floor(u), floor(v): the nearest corner's value is e_ref, and
//     the valid corners within edge_tau of it weigh in bilinearly; else
//     e_ref = enc at the pixel, valid where 0 < e_ref < 0.5 _FAR;
//   - a visible sample (culled, not behind the hand, in the sample mask)
//     counts where the lookup is valid, matches where |z - d| < tau
//     (support 1 - |z - d| inv_tau, with inv_tau = 1 / tau rounded to
//     FP32 once: ATen's CUDA division by a Python scalar),
//     is wrong-side where z - d < -tau, and is a ghost where e_ref >= 0.5
//     _FAR; fitness = (support - pen wrong - inv_pen ghost) / max(counted +
//     ghost, 1, floor x the unmasked counted + ghost), or -pen where nothing
//     counted; coverage = matches / max(visible - neutral no-evidence,
//     1, floor x the unmasked visible).
//
// What bounds it on Hopper: neither the bytes nor the operations. A call
// reads each object's samples and normals (24 B a sample, L1- and
// L2-resident across the object's particles), one pose a particle and 16 B
// out; the two VGA images of an object, 2.4 MB, stay in the 50 MB L2 for a
// library of 8. About 60 FP32 operations a sample: the finisher's 512 x 2048
// samples are 63 MFLOP, ~1 us at 67 TFLOP/s, and ~3 us of bytes if every
// lookup came from HBM. What sets its time is the latency of up to five
// dependent scattered reads a sample (hand, then four corners, or one
// pixel), from L2.
//
// Design:
//   - the posing is in the kernel: the pose is read once a block into
//     registers and each sample is posed, projected and looked up in one
//     pass, so the posed clouds, the indices and the masks never reach
//     device memory;
//   - one block per particle, O * P blocks, of kSmallBlock threads up to
//     kSmallN samples and kLargeBlock above: thread t owns samples t, t + T,
//     ..., and every one of them is independent, so a warp keeps many
//     lookups in flight and the resident blocks of an SM hide the L2's
//     latency;
//   - every count is an exact integer; the support's sum runs in one fixed
//     order set by N alone (each thread in sample order, a fixed shuffle
//     tree per warp, then the warps in order; no atomics): a repeated launch
//     is bitwise equal, and object o of a library gets the bits of object o
//     alone;
//   - FP32 with explicit rounding (__fmul_rn, __fadd_rn, __fsub_rn,
//     __fdiv_rn: no contraction into FMA): each elementwise step rounds as
//     the plain version's operator does on the card, and only the support's
//     sum runs in another order.
//
// Plain C interface, loaded with ctypes; the launch goes on the caller's
// stream and the function returns its cudaError_t.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSmallBlock = 128;
constexpr int kLargeBlock = 256;
constexpr int kSmallN = 512;       // samples up to which a block is kSmallBlock threads
constexpr int kCounts = 9;         // the integer counts a block reduces
constexpr float kFar = 1e9f;       // score._FAR
constexpr float kHalfFar = 5e8f;   // 0.5 * score._FAR
constexpr float kNoEvidence = -1.5f;  // 0.5 * (score._NEAR + score._NEUTRAL)

enum Rule { kTake = 0, kImage = 1, kPatch = 2 };

struct Params {
  const float* poses;     // [rows, 4, 4]
  const float* pts;       // object o's samples at pts + o * obj_stride, [N, 3]
  const float* nrm;       // its normals, the same layout
  const float* enc;       // [rows / img_div, H, W] score.encode_observed
  const float* hand;      // [rows / hand_div, H, W] hand depth (kTake) or
                          // score.hand_table (kImage, kPatch), or null
  const uint8_t* mask;    // sample mask of object o at mask + o * mask_stride, or null
  const int64_t* pv0;     // [rows / patch_div, N] patch origins (kPatch)
  const int64_t* pu0;
  float* fitness;         // [rows] each particle's, as compare_points gives it
  float* coverage;
  float* support;
  float* counted;         // counted + ghost samples
  long long obj_stride, mask_stride;
  int N, H, W, pts_div, img_div, hand_div, mask_div, patch_div, size, exempt;
  float fx, fy, cx, cy, tau, inv_tau, edge_tau, pen, inv_pen, margin, count_floor;
};

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// One read of an image at (v, u) under the rule: _FAR (kTake) or 0.0 (the
// "mxu" rules) outside the image, and under kPatch outside the patch.
template <int R>
__device__ __forceinline__ float read(const Params& p, const float* img, int v, int u,
                                      int pv, int pu) {
  bool ok = v >= 0 && v < p.H && u >= 0 && u < p.W;
  if (R == kPatch) {
    ok = ok && v - pv >= 0 && v - pv < p.size && u - pu >= 0 && u - pu < p.size;
  }
  if (!ok) {
    return R == kTake ? kFar : 0.0f;
  }
  return img[v * p.W + u];
}

template <int R, bool Sub, int T>
__global__ void __launch_bounds__(T) project_compare_kernel(Params p) {
  constexpr int kWarps = T / 32;
  __shared__ int red_i[kWarps][kCounts];
  __shared__ float red_f[kWarps];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* Tm = p.poses + (size_t)b * 16;
  const float r00 = Tm[0], r01 = Tm[1], r02 = Tm[2], t0 = Tm[3];
  const float r10 = Tm[4], r11 = Tm[5], r12 = Tm[6], t1 = Tm[7];
  const float r20 = Tm[8], r21 = Tm[9], r22 = Tm[10], t2 = Tm[11];
  const int o = b / p.pts_div;
  const float* pts = p.pts + o * p.obj_stride;
  const float* nrm = p.nrm + o * p.obj_stride;
  const float* enc = p.enc + (size_t)(b / p.img_div) * p.H * p.W;
  const float* hand = p.hand != nullptr ? p.hand + (size_t)(b / p.hand_div) * p.H * p.W
                                        : nullptr;
  const uint8_t* mask = p.mask != nullptr ? p.mask + (b / p.mask_div) * p.mask_stride
                                          : nullptr;
  const int64_t* pv0 = R == kPatch ? p.pv0 + (size_t)(b / p.patch_div) * p.N : nullptr;
  const int64_t* pu0 = R == kPatch ? p.pu0 + (size_t)(b / p.patch_div) * p.N : nullptr;
  const float neg_tau = -p.tau;

  // visible (vis) and, before the sample mask, visible0: counted, ghost,
  // and vis's matches, wrong-side samples and neutral no-evidence samples
  int n_vis = 0, n_cnt = 0, n_ghost = 0, n_match = 0, n_wrong = 0, n_noev = 0;
  int n_vis0 = 0, n_cnt0 = 0, n_ghost0 = 0;
  float sup = 0.0f;
  for (int s = tid; s < p.N; s += T) {
    const float x = pts[3 * s], y = pts[3 * s + 1], zz = pts[3 * s + 2];
    const float z = add(add(add(mul(r20, x), mul(r21, y)), mul(r22, zz)), t2);
    if (!(z > 1e-6f)) {
      continue;
    }
    const float px = add(add(add(mul(r00, x), mul(r01, y)), mul(r02, zz)), t0);
    const float py = add(add(add(mul(r10, x), mul(r11, y)), mul(r12, zz)), t1);
    const float u = add(mul(__fdiv_rn(px, z), p.fx), p.cx);
    const float v = add(mul(__fdiv_rn(py, z), p.fy), p.cy);
    const float ur = rintf(u);
    const float vr = rintf(v);
    if (!(ur >= 0.0f && ur < (float)p.W && vr >= 0.0f && vr < (float)p.H)) {
      continue;
    }
    const float a = nrm[3 * s], c = nrm[3 * s + 1], e = nrm[3 * s + 2];
    const float nx = add(add(mul(r00, a), mul(r01, c)), mul(r02, e));
    const float ny = add(add(mul(r10, a), mul(r11, c)), mul(r12, e));
    const float nz = add(add(mul(r20, a), mul(r21, c)), mul(r22, e));
    if (!(add(add(mul(nx, px), mul(nz, z)), mul(ny, py)) < 0.0f)) {
      continue;                 // back-facing
    }
    const int ui = (int)ur, vi = (int)vr;
    const int pv = R == kPatch ? (int)pv0[s] : 0;
    const int pu = R == kPatch ? (int)pu0[s] : 0;
    if (hand != nullptr) {
      const float zm = sub(z, p.margin);
      if (R == kTake) {
        if (hand[vi * p.W + ui] < zm) {
          continue;
        }
      } else {
        const float dh = read<R>(p, hand, vi, ui, pv, pu);
        if (dh > 0.0f && dh < zm) {
          continue;
        }
      }
    }
    float e_ref, d_obs;
    bool v_obs;
    if (Sub) {
      const float u0 = floorf(u), v0 = floorf(v);
      const float au = sub(u, u0), av = sub(v, v0);
      const float bu = sub(1.0f, au), bv = sub(1.0f, av);
      const int iu = (int)u0, iv = (int)v0;
      const float d[4] = {read<R>(p, enc, iv, iu, pv, pu), read<R>(p, enc, iv, iu + 1, pv, pu),
                          read<R>(p, enc, iv + 1, iu, pv, pu),
                          read<R>(p, enc, iv + 1, iu + 1, pv, pu)};
      const float w[4] = {mul(bu, bv), mul(au, bv), mul(bu, av), mul(au, av)};
      const int k_ref = (av >= 0.5f ? 2 : 0) + (au >= 0.5f ? 1 : 0);
      const float d_ref = d[k_ref];
      float num = 0.0f, den = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (d[k] > 0.0f && d[k] < kHalfFar && fabsf(sub(d[k], d_ref)) < p.edge_tau) {
          num = add(num, mul(w[k], d[k]));
          den = add(den, w[k]);
        }
      }
      e_ref = d_ref;
      v_obs = d_ref > 0.0f && d_ref < kHalfFar && den > 1e-6f;
      d_obs = v_obs ? __fdiv_rn(num, fmaxf(den, 1e-6f)) : 0.0f;
    } else {
      e_ref = R == kTake ? enc[vi * p.W + ui] : read<R>(p, enc, vi, ui, pv, pu);
      v_obs = e_ref > 0.0f && e_ref < kHalfFar;
      d_obs = e_ref;
    }
    const bool ghost = e_ref >= kHalfFar;
    ++n_vis0;
    n_cnt0 += v_obs;
    n_ghost0 += ghost;
    if (mask != nullptr && !mask[s]) {
      continue;
    }
    ++n_vis;
    n_ghost += ghost;
    n_noev += e_ref < kNoEvidence;
    if (v_obs) {
      const float diff = sub(z, d_obs);
      const float ad = fabsf(diff);
      ++n_cnt;
      if (ad < p.tau) {
        ++n_match;
        sup = add(sup, sub(1.0f, mul(ad, p.inv_tau)));
      }
      n_wrong += diff < neg_tau;
    }
  }

  // the block's sums in a fixed order, and the particle's scores
  int cnt[kCounts] = {n_vis, n_cnt, n_ghost, n_match, n_wrong, n_noev, n_vis0, n_cnt0,
                      n_ghost0};
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < kCounts; ++k) {
      cnt[k] += __shfl_down_sync(0xffffffffu, cnt[k], off);
    }
    sup = add(sup, __shfl_down_sync(0xffffffffu, sup, off));
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kCounts; ++k) {
      red_i[warp][k] = cnt[k];
    }
    red_f[warp] = sup;
  }
  __syncthreads();
  if (tid == 0) {
    int tot[kCounts] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
    float s = 0.0f;
    for (int k = 0; k < kWarps; ++k) {
#pragma unroll
      for (int j = 0; j < kCounts; ++j) {
        tot[j] += red_i[k][j];
      }
      s = add(s, red_f[k]);
    }
    const float ghost = (float)tot[2];
    const float n_counted = add((float)tot[1], ghost);
    float n_den = fmaxf(n_counted, 1.0f);
    float n_vis_f = (float)tot[0];
    if (p.exempt) {
      n_vis_f = sub(n_vis_f, (float)tot[5]);
    }
    n_vis_f = fmaxf(n_vis_f, 1.0f);
    if (p.mask != nullptr) {
      n_den = fmaxf(n_den, mul(p.count_floor, add((float)tot[7], (float)tot[8])));
      n_vis_f = fmaxf(n_vis_f, mul(p.count_floor, (float)tot[6]));
    }
    const float f = __fdiv_rn(sub(sub(s, mul(p.pen, (float)tot[4])), mul(p.inv_pen, ghost)),
                              n_den);
    p.fitness[b] = n_counted > 0.0f ? f : -p.pen;
    p.coverage[b] = __fdiv_rn((float)tot[3], n_vis_f);
    p.support[b] = s;
    p.counted[b] = n_counted;
  }
}

template <int R, bool Sub>
void launch(const Params& p, int rows, cudaStream_t stream) {
  if (p.N <= kSmallN) {
    project_compare_kernel<R, Sub, kSmallBlock><<<rows, kSmallBlock, 0, stream>>>(p);
  } else {
    project_compare_kernel<R, Sub, kLargeBlock><<<rows, kLargeBlock, 0, stream>>>(p);
  }
}

}  // namespace

extern "C" int project_compare_launch(
    const float* poses, const float* pts, const float* nrm, const float* enc,
    const float* hand, const uint8_t* mask, const int64_t* pv0, const int64_t* pu0,
    float* fitness, float* coverage, float* support, float* counted, long long obj_stride,
    long long mask_stride, int rows, int N, int H, int W, int rule, int subpixel, int pts_div,
    int img_div, int hand_div, int mask_div, int patch_div, int size, int exempt, float fx,
    float fy, float cx, float cy, float tau, float inv_tau, float edge_tau, float pen,
    float inv_pen, float margin, float count_floor, void* stream) {
  if (rows <= 0 || N <= 0 || H <= 0 || W <= 0 || rule < kTake || rule > kPatch ||
      pts_div <= 0 || img_div <= 0 || hand_div <= 0 || mask_div <= 0 || patch_div <= 0 ||
      rows % pts_div != 0 || rows % img_div != 0 || rows % hand_div != 0 ||
      rows % mask_div != 0 || rows % patch_div != 0 ||
      (rule == kPatch && (pv0 == nullptr || pu0 == nullptr || size <= 0))) {
    return (int)cudaErrorInvalidValue;
  }
  Params p{poses,   pts,      nrm,      enc,     hand,    mask,       pv0,       pu0,
           fitness, coverage, support,  counted, obj_stride, mask_stride, N,      H,
           W,       pts_div,  img_div,  hand_div, mask_div, patch_div, size,      exempt,
           fx,      fy,       cx,       cy,      tau,     inv_tau,    edge_tau,  pen,
           inv_pen, margin,   count_floor};
  cudaStream_t s = (cudaStream_t)stream;
  if (rule == kTake) {
    subpixel ? launch<kTake, true>(p, rows, s) : launch<kTake, false>(p, rows, s);
  } else if (rule == kImage) {
    subpixel ? launch<kImage, true>(p, rows, s) : launch<kImage, false>(p, rows, s);
  } else {
    subpixel ? launch<kPatch, true>(p, rows, s) : launch<kPatch, false>(p, rows, s);
  }
  return (int)cudaGetLastError();
}
