// PLOP's pseudo-labels from the teacher's upsampled logits (K9), forward
// only.
//
// Replaces the TPU kernel `_pseudo_pallas` (bacs_tpu/ops/upsample_ce.py:904,
// kernel body `_pseudo_kernel`, :856).  For the teacher's logits u =
// bilinear_upsample(sem_old) (half-pixel centres, clamped: the taps of
// bilinear_taps.cuh) over its c channels, labels t and per-class
// thresholds thr, per output pixel:
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
// Design: one thread per output pixel, grid-stride within its image (grid
// = (blocks per image, N)); a pixel whose label is not below c is copied.
// Two passes over the channels: an online max, first argmax and rescaled
// exp-sum, then the entropy's sum (one more exponential and a logarithm
// per channel).  The counts are integers: a block sum in shared memory,
// then one integer atomic per block and count, exact in any order.  The
// three full-resolution f32 tensors of the composed version
// (probabilities, entropy, argmax) never exist.
//
// Bound on the H100 at the PLOP step's shape (teacher bf16 [12, 32, 32,
// 16] -> [12, 512, 512], int32 labels in and out): 25 MB of labels in and
// out (7.5 us at 3.35 TB/s) against, at the ~88 % of pixels below c, 16
// channels x two special-function operations (an exponential and a
// logarithm; this kernel takes a second exponential): bound by the SFU
// (~0.02 ms).  Measured times are in PERF.md.
//
// Against the plain version (bacs_tpu_torch/ops/upsample_pseudo.py): a
// pixel whose entropy lies within rounding of its threshold, or whose top
// two logits tie within rounding, may take the other branch; everywhere
// else the labels and counts are equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bilinear_taps.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int block_sum_int(int v) {
  __shared__ int warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kThreads / 32; ++i) r += warp_sums[i];
  }
  __syncthreads();  // warp_sums is reused by the next call
  return r;
}

template <typename T, typename L>
__global__ void pseudo_kernel(const T* __restrict__ sem, const L* __restrict__ labels,
                              int h, int w, int c, int H, int W,
                              const float* __restrict__ thresholds,
                              const float* __restrict__ max_entropy, float ent_scale,
                              int ignore_index, int32_t* __restrict__ out,
                              int* __restrict__ counts) {
  const int n = blockIdx.y;
  const long long hw = (long long)H * W;
  const T* img = sem + (size_t)n * h * w * c;
  const L* lab = labels + (size_t)n * hw;
  int32_t* dst = out + (size_t)n * hw;
  const float inv_me = 1.f / *max_entropy;
  int num = 0, den = 0;
  for (long long p = (long long)blockIdx.x * kThreads + threadIdx.x; p < hw;
       p += (long long)gridDim.x * kThreads) {
    const long long t = (long long)lab[p];
    if (!(t < c)) {  // a new class or ignored: kept as it is
      dst[p] = (int32_t)t;
      continue;
    }
    const bacs_taps::Taps<T> up(img, h, w, c, H, W, (int)(p / W), (int)(p % W));
    float m = -INFINITY, s = 0.f;
    int arg = 0;
    for (int ch = 0; ch < c; ++ch) {
      const float v = up(ch);
      if (v > m) {
        s = s * expf(m - v) + 1.f;
        m = v;
        arg = ch;
      } else {
        s += expf(v - m);
      }
    }
    float acc = 0.f;
    for (int ch = 0; ch < c; ++ch) {
      const float pr = expf(up(ch) - m) / s;
      acc += pr * logf(pr + 1e-8f);
    }
    const float ent = acc * ent_scale * inv_me;
    const bool valid = ent < thresholds[arg];
    dst[p] = valid ? arg : ignore_index;
    num += valid ? 1 : 0;
    den += 1;
  }
  const int bnum = block_sum_int(num);
  const int bden = block_sum_int(den);
  if (threadIdx.x == 0) {
    atomicAdd(counts + 2 * n, bnum);
    atomicAdd(counts + 2 * n + 1, bden);
  }
}

}  // namespace

// sem [n, h, w, c] contiguous, f32 (sem_is_bf16 == 0) or bf16; labels
// [n, H, W] contiguous int32 (labels_are_i64 == 0) or int64; thresholds f32
// [>= c]; max_entropy one f32 on the device; ent_scale = -1 / (c log(c +
// 1e-8)); out int32 [n, H, W]; counts int32 [n, 2] zeroed by the caller,
// (num, den) per image.  One launch; returns cudaGetLastError().
extern "C" int upsample_plop_pseudo(const void* sem, int sem_is_bf16,
                                    const void* labels, int labels_are_i64, int n,
                                    int h, int w, int c, int H, int W,
                                    const void* thresholds, const void* max_entropy,
                                    float ent_scale, int ignore_index, int blocks,
                                    void* out, void* counts, void* stream) {
  if ((long long)n * H * W == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(blocks, n);
  const float* thr = (const float*)thresholds;
  const float* me = (const float*)max_entropy;
  if (sem_is_bf16) {
    if (labels_are_i64) {
      pseudo_kernel<__nv_bfloat16, int64_t><<<grid, kThreads, 0, st>>>(
          (const __nv_bfloat16*)sem, (const int64_t*)labels, h, w, c, H, W, thr, me,
          ent_scale, ignore_index, (int32_t*)out, (int*)counts);
    } else {
      pseudo_kernel<__nv_bfloat16, int32_t><<<grid, kThreads, 0, st>>>(
          (const __nv_bfloat16*)sem, (const int32_t*)labels, h, w, c, H, W, thr, me,
          ent_scale, ignore_index, (int32_t*)out, (int*)counts);
    }
  } else if (labels_are_i64) {
    pseudo_kernel<float, int64_t><<<grid, kThreads, 0, st>>>(
        (const float*)sem, (const int64_t*)labels, h, w, c, H, W, thr, me, ent_scale,
        ignore_index, (int32_t*)out, (int*)counts);
  } else {
    pseudo_kernel<float, int32_t><<<grid, kThreads, 0, st>>>(
        (const float*)sem, (const int32_t*)labels, h, w, c, H, W, thr, me, ent_scale,
        ignore_index, (int32_t*)out, (int*)counts);
  }
  return (int)cudaGetLastError();
}
