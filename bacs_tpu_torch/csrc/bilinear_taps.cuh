// Bilinear taps computed per output pixel (K2; the other upsample kernels
// read host-built tables, upsample_stage.cuh).
//
// The half-pixel (align_corners=False) source coordinates of
// `interp_matrix` (bacs_tpu_torch/ops/upsample_tiles.py), clamped to the
// edge: output index o of out_dim reads source indices lo and hi of in_dim
// with weights 1 - wt and wt.  At an edge lo == hi, and both weights land
// on the one source, as `interp_matrix` adds them into one entry.

#pragma once

#include <cuda_bf16.h>
#include <math.h>

namespace bacs_taps {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Source index pair and weight of output row/column `o`, exactly as
// interp_matrix computes them (in double, weight rounded to f32).
__device__ __forceinline__ void src_coord(int o, int out_dim, int in_dim,
                                          int& lo, int& hi, float& wt) {
  double s = (double)in_dim / (double)out_dim;
  double c = ((double)o + 0.5) * s - 0.5;
  c = fmin(fmax(c, 0.0), (double)(in_dim - 1));
  lo = (int)floor(c);
  hi = min(lo + 1, in_dim - 1);
  wt = (float)(c - (double)lo);
}

// The four taps of output pixel (oy, ox) of an [h, w, c] image, as base
// pointers to their channel vectors, and the row and column weights.
template <typename T>
struct Taps {
  const T *p00, *p01, *p10, *p11;
  float wy0, wy, wx0, wx;

  __device__ __forceinline__ Taps(const T* img, int h, int w, int c, int H,
                                  int W, int oy, int ox) {
    int y0, y1, x0, x1;
    src_coord(oy, H, h, y0, y1, wy);
    src_coord(ox, W, w, x0, x1, wx);
    wy0 = 1.f - wy;
    wx0 = 1.f - wx;
    p00 = img + ((size_t)y0 * w + x0) * c;
    p01 = img + ((size_t)y0 * w + x1) * c;
    p10 = img + ((size_t)y1 * w + x0) * c;
    p11 = img + ((size_t)y1 * w + x1) * c;
  }

  // upsampled logit of channel ch: rows first, then columns (the order of
  // the plain version's two einsums)
  __device__ __forceinline__ float operator()(int ch) const {
    const float left = wy0 * to_f32(p00[ch]) + wy * to_f32(p10[ch]);
    const float right = wy0 * to_f32(p01[ch]) + wy * to_f32(p11[ch]);
    return wx0 * left + wx * right;
  }
};

}  // namespace bacs_taps
