// Render-and-compare scoring of pose hypotheses (kernel K5): each particle's
// camera-frame surface samples splatted into a z-buffer, the buffer min-
// filtered, and every rendered pixel compared with the observed depth, in one
// launch, one block per particle. No [P, H, W] image is ever written.
//
// Replaces no TPU kernel. On the TPU the pixel-mode scorer is XLA: a batched
// splat (`render.splat_depth_batched`: a scatter-min and a separable min-
// pool) and a per-pixel compare (`score.compare_depth`) over whole [P, H, W]
// images. The port ran the same pair as ATen operators, which at VGA
// materialize about seven [512, 480, 640] buffers of 634 MB each a call, for
// an object that covers 2-5% of the frame.
//
// For particle b (object o = b / img_div) with samples x_s = (x, y, z) and
// weights w_s it computes what `ops/knn_cuda.splat_compare_plain` (the ATen
// pair) computes, to the pixel:
//   - a sample renders where z > 1e-6 and w > 0, at ui = rint(x / z * fx +
//     cx), vi = rint(y / z * fy + cy) (half to even), with no FMA
//     contraction in the projection, if -r <= ui < W + r and -r <= vi < H + r
//     (the ring of samples just outside the frame reaches into it);
//   - the rendered depth R(v, u) is the least z of the samples within r of
//     (v, u) in both axes (the scatter-min, then the (2r+1)^2 min-filter),
//     +inf where none is;
//   - a pixel is visible where R is finite and the hand does not lie in
//     front of it (hand < R - occlusion_margin); a visible pixel with a valid
//     observation counts, matches where |R - obs| < tau (support 1 - |R -
//     obs| / tau) and is wrong-side where R - obs < -tau; a visible pixel
//     without one is a ghost where observed_enc >= 0.5 * _FAR (no return
//     near the silhouette);
//   - fitness = (support - pen * wrong - inv_pen * ghost) / max(counted +
//     ghost, 1), or -pen where nothing counted (the empty render); coverage
//     = matches / max(valid observed pixels of image o, 1).
//
// Design:
//   - the footprint: a first pass projects every sample and reduces the
//     bounding box of those that render; plus r, clipped to the frame, it
//     holds every pixel R can be finite at. Outside it nothing is read;
//   - the footprint in tiles of kTileH x kTileW pixels. Per tile the block
//     clears a z-buffer of the tile plus an r halo in shared memory,
//     re-projects every sample and keeps those that land in it with an
//     atomicMin on the depth's bit pattern (depths are positive, so the
//     bits order as the floats do, and the minimum does not depend on the
//     order the samples arrive in), filters it (rows, then columns) and
//     compares the tile's pixels. Any footprint takes the same path;
//   - every count is an exact integer. The support's sum runs in a fixed
//     order: each thread adds its pixels tile by tile, then a fixed shuffle
//     tree per warp, then the warps in order. The footprint is the
//     particle's own, so a particle's result depends on its inputs and the
//     shapes alone: a repeated launch is bitwise equal, and object o of a
//     library gets the bits of object o alone;
//   - FP32 with explicit rounding (__fdiv_rn, __fmul_rn, __fadd_rn,
//     __fsub_rn): each elementwise step rounds as the plain version's
//     operator does, and only the support's sum runs in another order.
//
// What bounds it on Hopper: not the bytes (each sample is read once per tile
// from L1 or L2; the points of a VGA call, 512 x 2048 samples, are 12.6 MB,
// 3.8 us at 3.35 TB/s) but a block's latency: a tile costs three barriers, a
// pass over the samples and the filter, and a VGA footprint of an object at
// half a metre is a few dozen tiles.
//
// Plain C interface, loaded with ctypes; the launch goes on the caller's
// stream and the function returns its cudaError_t.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileH = 32;
constexpr int kTileW = 32;
constexpr int kMaxRadius = 16;
constexpr unsigned kInfBits = 0x7f800000u;  // +inf: nothing rendered
constexpr float kGhostAt = 5e8f;            // 0.5 * score._FAR

struct Params {
  const float* pts;       // [rows, Nr, 3] camera-frame samples
  const float* w;         // [rows / w_div, Nr] weights (0 disables a sample)
  const float* obs;       // [rows / img_div, H, W] observed depth
  const uint8_t* valid;   // [rows / img_div, H, W] observation valid
  const float* enc;       // [rows / img_div, H, W] score.encode_observed
  const float* hand;      // [rows / hand_div, H, W] hand depth, or null
  const int* n_obs;       // [rows / img_div] valid pixels of each image
  float* fitness;         // [rows] each particle's, as compare_depth gives it
  float* coverage;
  float* support;
  float* counted;         // counted + ghost pixels
  int Nr, H, W, r, w_div, img_div, hand_div;
  float fx, fy, cx, cy, tau, pen, inv_pen, margin;
};

// Sample s of `pts` rendered: its pixel (in the r-padded range) and depth.
__device__ __forceinline__ bool project(const Params& p, const float* pts, const float* w,
                                        int s, int& ui, int& vi, float& z) {
  z = pts[3 * s + 2];
  if (!(z > 1e-6f) || !(w[s] > 0.0f)) {
    return false;
  }
  const float u = __fadd_rn(__fmul_rn(__fdiv_rn(pts[3 * s], z), p.fx), p.cx);
  const float v = __fadd_rn(__fmul_rn(__fdiv_rn(pts[3 * s + 1], z), p.fy), p.cy);
  const float ur = rintf(u);   // half to even, as torch.round
  const float vr = rintf(v);
  const float rr = (float)p.r;
  if (!(ur >= -rr && ur < (float)(p.W + p.r) && vr >= -rr && vr < (float)(p.H + p.r))) {
    return false;
  }
  ui = (int)ur;
  vi = (int)vr;
  return true;
}

__global__ void __launch_bounds__(kThreads) splat_compare_kernel(Params p) {
  extern __shared__ unsigned smem[];
  __shared__ int red_i[kWarps][4];
  __shared__ float red_f[kWarps];
  __shared__ int box[4];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r = p.r;
  const float* pts = p.pts + (size_t)b * p.Nr * 3;
  const float* w = p.w + (size_t)(b / p.w_div) * p.Nr;

  // 1. the footprint: the rendering samples' bounding box, plus r, in the frame
  int u0 = INT_MAX, u1 = INT_MIN, v0 = INT_MAX, v1 = INT_MIN;
  for (int s = tid; s < p.Nr; s += kThreads) {
    int ui, vi;
    float z;
    if (project(p, pts, w, s, ui, vi, z)) {
      u0 = min(u0, ui);
      u1 = max(u1, ui);
      v0 = min(v0, vi);
      v1 = max(v1, vi);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    u0 = min(u0, __shfl_xor_sync(0xffffffffu, u0, off));
    u1 = max(u1, __shfl_xor_sync(0xffffffffu, u1, off));
    v0 = min(v0, __shfl_xor_sync(0xffffffffu, v0, off));
    v1 = max(v1, __shfl_xor_sync(0xffffffffu, v1, off));
  }
  if (lane == 0) {
    red_i[warp][0] = u0;
    red_i[warp][1] = u1;
    red_i[warp][2] = v0;
    red_i[warp][3] = v1;
  }
  __syncthreads();
  if (tid == 0) {
    for (int k = 1; k < kWarps; ++k) {
      u0 = min(u0, red_i[k][0]);
      u1 = max(u1, red_i[k][1]);
      v0 = min(v0, red_i[k][2]);
      v1 = max(v1, red_i[k][3]);
    }
    if (u0 > u1) {              // nothing renders: an empty footprint
      box[0] = 0;
      box[1] = -1;
      box[2] = 0;
      box[3] = -1;
    } else {
      box[0] = max(u0 - r, 0);
      box[1] = min(u1 + r, p.W - 1);
      box[2] = max(v0 - r, 0);
      box[3] = min(v1 + r, p.H - 1);
    }
  }
  __syncthreads();
  const int fu0 = box[0], fu1 = box[1], fv0 = box[2], fv1 = box[3];

  // 2. the footprint tile by tile: z-buffer, min-filter, compare
  const size_t img = (size_t)(b / p.img_div) * p.H * p.W;
  const size_t himg = (size_t)(b / p.hand_div) * p.H * p.W;
  const int ZW = kTileW + 2 * r;
  const int ZH = kTileH + 2 * r;
  unsigned* zb = smem;            // [ZH, ZW]: the tile and its halo
  unsigned* hb = smem + ZH * ZW;  // [ZH, kTileW]: minima along the rows
  int n_cnt = 0, n_match = 0, n_wrong = 0, n_ghost = 0;
  float sup = 0.0f;
  for (int ty0 = fv0; ty0 <= fv1; ty0 += kTileH) {
    for (int tx0 = fu0; tx0 <= fu1; tx0 += kTileW) {
      for (int i = tid; i < ZH * ZW; i += kThreads) {
        zb[i] = kInfBits;
      }
      __syncthreads();
      for (int s = tid; s < p.Nr; s += kThreads) {
        int ui, vi;
        float z;
        if (!project(p, pts, w, s, ui, vi, z)) {
          continue;
        }
        const int ly = vi - ty0 + r;
        const int lx = ui - tx0 + r;
        if (ly >= 0 && ly < ZH && lx >= 0 && lx < ZW) {
          atomicMin(&zb[ly * ZW + lx], __float_as_uint(z));
        }
      }
      __syncthreads();
      for (int i = tid; i < ZH * kTileW; i += kThreads) {
        const int y = i / kTileW;
        const int x = i - y * kTileW;
        unsigned m = zb[y * ZW + x];
        for (int k = 1; k <= 2 * r; ++k) {
          m = min(m, zb[y * ZW + x + k]);
        }
        hb[i] = m;
      }
      __syncthreads();
      for (int i = tid; i < kTileH * kTileW; i += kThreads) {
        const int y = i / kTileW;
        const int x = i - y * kTileW;
        const int v = ty0 + y;
        const int u = tx0 + x;
        if (v > fv1 || u > fu1) {
          continue;
        }
        unsigned m = hb[i];
        for (int k = 1; k <= 2 * r; ++k) {
          m = min(m, hb[i + k * kTileW]);
        }
        if (m >= kInfBits) {    // +inf: nothing rendered here
          continue;
        }
        const float R = __uint_as_float(m);
        const size_t px = (size_t)v * p.W + u;
        if (p.hand != nullptr && p.hand[himg + px] < __fsub_rn(R, p.margin)) {
          continue;             // behind the hand
        }
        if (p.valid[img + px]) {
          const float diff = __fsub_rn(R, p.obs[img + px]);
          const float ad = fabsf(diff);
          ++n_cnt;
          if (ad < p.tau) {
            ++n_match;
            sup = __fadd_rn(sup, __fsub_rn(1.0f, __fdiv_rn(ad, p.tau)));
          }
          if (diff < -p.tau) {
            ++n_wrong;
          }
        } else if (p.enc[img + px] >= kGhostAt) {
          ++n_ghost;
        }
      }
      __syncthreads();
    }
  }

  // 3. the block's sums in a fixed order, and the particle's scores
  for (int off = 16; off > 0; off >>= 1) {
    n_cnt += __shfl_down_sync(0xffffffffu, n_cnt, off);
    n_match += __shfl_down_sync(0xffffffffu, n_match, off);
    n_wrong += __shfl_down_sync(0xffffffffu, n_wrong, off);
    n_ghost += __shfl_down_sync(0xffffffffu, n_ghost, off);
    sup = __fadd_rn(sup, __shfl_down_sync(0xffffffffu, sup, off));
  }
  if (lane == 0) {
    red_i[warp][0] = n_cnt;
    red_i[warp][1] = n_match;
    red_i[warp][2] = n_wrong;
    red_i[warp][3] = n_ghost;
    red_f[warp] = sup;
  }
  __syncthreads();
  if (tid == 0) {
    int c = 0, m = 0, wr = 0, g = 0;
    float s = 0.0f;
    for (int k = 0; k < kWarps; ++k) {
      c += red_i[k][0];
      m += red_i[k][1];
      wr += red_i[k][2];
      g += red_i[k][3];
      s = __fadd_rn(s, red_f[k]);
    }
    const float ghost = (float)g;
    const float n_counted = __fadd_rn((float)c, ghost);
    float f = __fsub_rn(__fsub_rn(s, __fmul_rn(p.pen, (float)wr)), __fmul_rn(p.inv_pen, ghost));
    f = __fdiv_rn(f, fmaxf(n_counted, 1.0f));
    p.fitness[b] = n_counted > 0.0f ? f : -p.pen;
    p.coverage[b] = __fdiv_rn((float)m, fmaxf((float)p.n_obs[b / p.img_div], 1.0f));
    p.support[b] = s;
    p.counted[b] = n_counted;
  }
}

// Shared memory a block of radius r takes: the z-buffer and the row minima.
int smem_bytes(int r) {
  return (int)(sizeof(unsigned) *
               ((kTileH + 2 * r) * (kTileW + 2 * r) + (kTileH + 2 * r) * kTileW));
}

}  // namespace

extern "C" int splat_compare_launch(const float* pts, const float* w, const float* obs,
                                    const uint8_t* valid, const float* enc, const float* hand,
                                    const int* n_obs, float* fitness, float* coverage,
                                    float* support, float* counted, int rows, int Nr, int H,
                                    int W, int r, int w_div, int img_div, int hand_div, float fx,
                                    float fy, float cx, float cy, float tau, float pen,
                                    float inv_pen, float margin, void* stream) {
  if (rows <= 0 || Nr <= 0 || H <= 0 || W <= 0 || r < 0 || r > kMaxRadius || w_div <= 0 ||
      img_div <= 0 || hand_div <= 0 || rows % w_div != 0 || rows % img_div != 0 ||
      rows % hand_div != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Params p{pts,     w,       obs, valid, enc, hand,  n_obs,   fitness,  coverage,
           support, counted, Nr,  H,     W,   r,     w_div,   img_div,  hand_div,
           fx,      fy,      cx,  cy,    tau, pen,   inv_pen, margin};
  splat_compare_kernel<<<rows, kThreads, smem_bytes(r), (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
