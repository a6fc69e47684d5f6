// PLOP's pseudo-labels from the teacher's upsampled logits (K9), forward
// only.
//
// Replaces the TPU kernel `_pseudo_pallas` (bacs_tpu/ops/upsample_ce.py:904,
// kernel body `_pseudo_kernel`, :856).  For the teacher's logits u =
// bilinear_upsample(sem_old) (half-pixel centres, clamped: the weights of
// `interp_matrix`) over its c channels, labels t and per-class thresholds
// thr, per output pixel:
//   p       = softmax(u);
//   ent     = -(1 / (c log(c + 1e-8))) sum_ch p log(p + 1e-8), divided by
//             max_entropy (log of the current class count: the reference
//             normalises twice, bacs_tpu/methods/plop.py:66-67);
//   pseudo  = the first channel of maximal u;
//   valid   = ent < thr[pseudo] (strictly);
//   bg      = t < c (the old classes and the background; the ignore label
//             is not below c);
//   out     = bg ? (valid ? pseudo : ignore_index) : t, int32;
// and per image num = #(valid & bg), den = #bg.  The TPU kernel fixed the
// ignore label at 255; here it is an argument.
//
// Design: `pixel_kernel` of upsample_stage.cuh with `PseudoTerm`: the taps
// and bands of ops/upsample_ce.py:launch_plan, each output row's H-lerped
// source columns staged in shared memory, one thread per output pixel.  The
// label is read first; a pixel whose label is not below c copies it and
// takes no softmax.  Otherwise one pass: the argmax and the softmax
// statistics in chunks of KC (16 for the PLOP step's 16 teacher channels),
// one `ex2.approx` per channel, the exponentials kept in registers where c
// <= KC (taken again per chunk past it), r = 1 / s once, then p = e r and
// the entropy's sum of p log(p + 1e-8), the logarithm one `lg2.approx` per
// channel (times ln 2 once per pixel).  The counts are integers: a block
// sum in shared memory, then one integer atomic per block and count, exact
// in any order.  The three full-resolution f32 tensors of the composed
// version (probabilities, entropy, argmax) never exist.
//
// Bound on the H100 at the PLOP step's shape (teacher bf16 [12, 32, 32,
// 16] -> [12, 512, 512], int32 labels in and out): 25 MB of labels in and
// out (7.5 us at 3.35 TB/s) against, at the ~88 % of pixels below c, 16
// channels x two special-function operations (an exponential and a
// logarithm): bound by the SFU (~0.02 ms).  Measured times are in PERF.md.
//
// Against the plain version (bacs_tpu_torch/ops/upsample_pseudo.py): a
// pixel whose entropy lies within rounding of its threshold, or whose top
// two logits tie within rounding, may take the other branch; everywhere
// else the labels and counts are equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "upsample_stage.cuh"

namespace {

using namespace upsample_stage;

// (num, den) over the block: warp shuffles, then thread 0 over the warp
// sums.  Every thread of the block calls it; the result is valid in thread
// 0.
__device__ __forceinline__ int2 block_sum_int2(int a, int b) {
  __shared__ int2 warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = make_int2(a, b);
  __syncthreads();
  int2 r = make_int2(0, 0);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kThreads / 32; ++i) {
      r.x += warp_sums[i].x;
      r.y += warp_sums[i].y;
    }
  }
  return r;
}

// K9: the pseudo-label or the copied label, int32; per image the counts.
struct PseudoTerm {
  static constexpr bool kLabels = true;
  static constexpr int kMinBlocks = 4;
  struct Acc {
    int num, den;
    float inv_me;
  };
  const float* thresholds;
  const float* max_entropy;
  float ent_scale;
  int ignore_index;
  int32_t* out;
  int* counts;

  __device__ __forceinline__ Acc start() const { return Acc{0, 0, 1.f / *max_entropy}; }
  // a new class or the ignore label is kept as it is
  __device__ __forceinline__ bool softmax(long long t, int c, long long q) const {
    if (t < c) return true;
    out[q] = (int32_t)t;
    return false;
  }
  template <int KC>
  __device__ __forceinline__ void pixel(const Pixel& px, int c, long long q,
                                        const ArgStats& st, const float (&e)[KC],
                                        Acc& acc) const {
    const float r = rcp(st.s);
    float sum = 0.f;  // sum of p log2(p + 1e-8)
    if (c <= KC) {  // the exponentials are in registers
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        if (k < c) {
          const float p = e[k] * r;
          sum = fmaf(p, lg2(p + 1e-8f), sum);
        }
      }
    } else {  // each chunk's exponentials again
      const float mb = st.m * kLog2e;
      for (int c0 = 0; c0 < c; c0 += KC) {
        float v[KC];
        px.chunk(c0, c, v);
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          if (c0 + k < c) {
            const float p = ex2(fmaf(v[k], kLog2e, -mb)) * r;
            sum = fmaf(p, lg2(p + 1e-8f), sum);
          }
        }
      }
    }
    const float ent = sum * kLn2 * ent_scale * acc.inv_me;
    const bool valid = ent < thresholds[st.arg];
    out[q] = valid ? st.arg : ignore_index;
    acc.num += valid ? 1 : 0;
    acc.den += 1;
  }
  __device__ __forceinline__ void flush(Acc& acc, int n) const {
    const int2 r = block_sum_int2(acc.num, acc.den);
    if (threadIdx.x == 0) {
      atomicAdd(counts + 2 * n, r.x);
      atomicAdd(counts + 2 * n + 1, r.y);
    }
  }
};

}  // namespace

// sem [n, h, w, c] contiguous, f32 (sem_is_bf16 == 0) or bf16; labels
// [n, H, W] contiguous int32 (labels_are_i64 == 0) or int64; thresholds f32
// [>= c]; max_entropy one f32 on the device; ent_scale = -1 / (c log(c +
// 1e-8)); tables, band, tile, span, rows: the launch plan of
// ops/upsample_ce.py:launch_plan; out int32 [n, H, W]; counts int32 [n, 2]
// zeroed by the caller, (num, den) per image.  One launch; returns
// cudaGetLastError().
extern "C" int upsample_plop_pseudo(const void* sem, int sem_is_bf16, const void* labels,
                                    int labels_are_i64, int n, int h, int w, int c, int H,
                                    int W, int ignore_index, const void* thresholds,
                                    const void* max_entropy, float ent_scale,
                                    const void* tables, int band, int tile, int span,
                                    int rows, void* out, void* counts, void* stream) {
  const Plan plan = make_plan(tables, h, w, H, W, band, tile, span, rows);
  const PseudoTerm term{(const float*)thresholds, (const float*)max_entropy, ent_scale,
                        ignore_index, (int32_t*)out, (int*)counts};
  cudaStream_t st = (cudaStream_t)stream;
  if (sem_is_bf16) {
    return labels_are_i64
        ? launch_pixels<__nv_bfloat16, int64_t>(sem, labels, n, h, w, c, H, W, term, plan, st)
        : launch_pixels<__nv_bfloat16, int32_t>(sem, labels, n, h, w, c, H, W, term, plan, st);
  }
  return labels_are_i64
      ? launch_pixels<float, int64_t>(sem, labels, n, h, w, c, H, W, term, plan, st)
      : launch_pixels<float, int32_t>(sem, labels, n, h, w, c, H, W, term, plan, st);
}
