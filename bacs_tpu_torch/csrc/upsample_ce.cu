// Fused bilinear upsample + softmax cross-entropy, forward sums and gradient.
//
// Replaces the TPU kernels of the plain upsample+CE (K1):
//   forward  `_ce_sums_per_image_pallas` (bacs_tpu/ops/upsample_ce.py:787,
//            reduced over images by `_ce_sums_pallas`, :118);
//   backward `_dsem_pallas` (upsample_ce.py:125, via `call_dz`/`make_dz_kernel`
//            in bacs_tpu/ops/upsample_tiles.py).
// For logits up = bilinear_upsample(sem) (half-pixel centres, clamped, the
// weights of `interp_matrix`) and labels t with `ignore_index` dropped:
//   forward:  per image, sum over valid pixels of logsumexp(up) - up[t], and
//             the valid count;
//   backward: dsem = K_H^T . ((softmax(up) - onehot(t)) * valid * g) . K_W,
//             g a device scalar (the mean's 1/count, from autograd).
// The [N, H, W, C] full-resolution logits never exist.  A label outside
// [0, C) that is not ignored picks no logit (as the TPU kernel's one-hot).
//
// Design.  Forward: one thread per output pixel (grid-stride within its
// image, grid = (blocks per image, N)), an online max / rescaled exp-sum
// over channels, and a block sum in a fixed order into a [N, blocks, 2]
// scratch; a second launch sums each image's partials in a fixed order.
// No float atomics, so the sums are deterministic.  The TPU grid ran in
// order and carried the sums in scratch; Hopper's blocks run in parallel.
// Backward, in the gather form (deterministic, no atomics), separable as
// the plain version's two einsums:
//   pass 1, one thread per (n, output row oy, source column x): for every
//     output column ox whose taps include x, recompute the softmax at
//     (oy, ox) and add w_x(ox) * (softmax - onehot) * g into 32 channel
//     accumulators in registers -> cols[n, oy, x, :] (f32 scratch);
//   pass 2, one thread per dsem element (n, y, x, c): the sum over the
//     output rows whose taps include y of w_y(oy) * cols[n, oy, x, c].
// Each output pixel's softmax is recomputed by the (at most two) source
// columns it touches, each twice (max/sum, then the terms): about 4x the
// forward's exponentials.  The TPU kernel's row blocks, -1e30 channel
// padding, hoisted W-interp einsum and `W % 128` gate are TPU tiling and are
// not carried over; every shape is taken.
//
// Bound on the H100 at the training shape, sem [16, 32, 32, 21] bf16 and
// labels [16, 512, 512] int32: the forward moves 17.5 MB (5 us at
// 3.35 TB/s) but computes 88 M upsampled logits, each with 4 loads,
// 3 lerps and an exponential, so it is bound by operations (instruction
// issue and the SFU's exponentials), not by device memory.  The backward
// does four times the exponentials.  Measured times are in PERF.md.
//
// Tolerance against the plain version (bacs_tpu_torch/ops/upsample_ce.py):
// sums in another order than the einsums; value rtol 2e-3 and gradient
// rtol 5e-2 of the largest gradient, the tolerances the TPU kernels hold
// against their own fallbacks (scripts/check_kernels_tpu.py:96-97).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bilinear_taps.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;  // channels accumulated in registers (backward)

// Sum of (a, b) over the block in a fixed order: warp shuffles, then
// thread 0 over the warp sums.  Every thread of the block must call it;
// the result is valid in thread 0.
__device__ __forceinline__ float2 block_sum2(float a, float b) {
  __shared__ float2 warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = make_float2(a, b);
  __syncthreads();
  float2 r = make_float2(0.f, 0.f);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kThreads / 32; ++i) {
      r.x += warp_sums[i].x;
      r.y += warp_sums[i].y;
    }
  }
  return r;
}

// Online max and rescaled exp-sum of the c upsampled logits at one pixel.
template <typename T>
__device__ __forceinline__ void softmax_stats(const bacs_taps::Taps<T>& up,
                                              int c, float& m, float& s) {
  m = -INFINITY;
  s = 0.f;
  for (int ch = 0; ch < c; ++ch) {
    const float v = up(ch);
    if (v > m) {
      s = s * expf(m - v) + 1.f;
      m = v;
    } else {
      s += expf(v - m);
    }
  }
}

template <typename T, typename L>
__global__ void ce_partials_kernel(const T* __restrict__ sem,
                                   const L* __restrict__ labels, int h, int w,
                                   int c, int H, int W, int ignore_index,
                                   float2* __restrict__ partials) {
  const int n = blockIdx.y;
  const long long hw = (long long)H * W;
  const T* img = sem + (size_t)n * h * w * c;
  const L* lab = labels + (size_t)n * hw;
  float loss = 0.f, count = 0.f;
  for (long long p = (long long)blockIdx.x * kThreads + threadIdx.x; p < hw;
       p += (long long)gridDim.x * kThreads) {
    const long long t = (long long)lab[p];
    if (t == ignore_index) continue;
    const bacs_taps::Taps<T> up(img, h, w, c, H, W, (int)(p / W), (int)(p % W));
    float m = -INFINITY, s = 0.f, picked = 0.f;
    for (int ch = 0; ch < c; ++ch) {
      const float v = up(ch);
      if (v > m) {
        s = s * expf(m - v) + 1.f;
        m = v;
      } else {
        s += expf(v - m);
      }
      if (ch == t) picked = v;
    }
    loss += m + logf(s) - picked;
    count += 1.f;
  }
  const float2 r = block_sum2(loss, count);
  if (threadIdx.x == 0) partials[(size_t)n * gridDim.x + blockIdx.x] = r;
}

__global__ void ce_reduce_kernel(const float2* __restrict__ partials,
                                 int blocks, float* __restrict__ loss_out,
                                 float* __restrict__ count_out) {
  const int n = blockIdx.x;
  float a = 0.f, b = 0.f;
  for (int i = threadIdx.x; i < blocks; i += kThreads) {
    const float2 v = partials[(size_t)n * blocks + i];
    a += v.x;
    b += v.y;
  }
  const float2 r = block_sum2(a, b);
  if (threadIdx.x == 0) {
    loss_out[n] = r.x;
    count_out[n] = r.y;
  }
}

template <typename T, typename L>
__global__ void ce_grad_cols_kernel(const T* __restrict__ sem,
                                    const L* __restrict__ labels, int n_img,
                                    int h, int w, int c, int H, int W,
                                    int ignore_index, const float* __restrict__ g,
                                    float* __restrict__ cols) {
  const long long total = (long long)n_img * H * w;
  const long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (q >= total) return;
  const int x = (int)(q % w);
  const int oy = (int)((q / w) % H);
  const int n = (int)(q / ((long long)H * w));
  const T* img = sem + (size_t)n * h * w * c;
  const L* lab = labels + ((size_t)n * H + oy) * W;
  const float gv = *g;
  int first, last;
  bacs_taps::support(x, W, w, first, last);
  float* out = cols + (size_t)q * c;
  for (int c0 = 0; c0 < c; c0 += kChunk) {
    float acc[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) acc[k] = 0.f;
    for (int ox = first; ox <= last; ++ox) {
      const float wx = bacs_taps::tap_weight(ox, W, w, x);
      const long long t = (long long)lab[ox];
      if (wx == 0.f || t == ignore_index) continue;
      const bacs_taps::Taps<T> up(img, h, w, c, H, W, oy, ox);
      float m, s;
      softmax_stats(up, c, m, s);
      const float wg = wx * gv;
      const float ws = wg / s;
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const int ch = c0 + k;
        if (ch < c) acc[k] += ws * expf(up(ch) - m) - (ch == t ? wg : 0.f);
      }
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (c0 + k < c) out[c0 + k] = acc[k];
    }
  }
}

template <typename T>
__global__ void ce_grad_rows_kernel(const float* __restrict__ cols, int n_img,
                                    int h, int w, int c, int H,
                                    T* __restrict__ dsem) {
  const long long total = (long long)n_img * h * w * c;
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const int ch = (int)(e % c);
  const int x = (int)((e / c) % w);
  const int y = (int)((e / ((long long)c * w)) % h);
  const int n = (int)(e / ((long long)c * w * h));
  int first, last;
  bacs_taps::support(y, H, h, first, last);
  float acc = 0.f;
  for (int oy = first; oy <= last; ++oy) {
    const float wy = bacs_taps::tap_weight(oy, H, h, y);
    if (wy != 0.f) acc += wy * cols[(((size_t)n * H + oy) * w + x) * c + ch];
  }
  bacs_taps::store(dsem + e, acc);
}

unsigned blocks_for(long long total) {
  return (unsigned)((total + kThreads - 1) / kThreads);
}

template <typename T, typename L>
int launch_sums(const void* sem, const void* labels, int n, int h, int w,
                int c, int H, int W, int ignore_index, void* partials,
                int blocks, void* loss_out, void* count_out, cudaStream_t st) {
  ce_partials_kernel<T, L><<<dim3(blocks, n), kThreads, 0, st>>>(
      (const T*)sem, (const L*)labels, h, w, c, H, W, ignore_index,
      (float2*)partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ce_reduce_kernel<<<n, kThreads, 0, st>>>((const float2*)partials, blocks,
                                           (float*)loss_out, (float*)count_out);
  return (int)cudaGetLastError();
}

template <typename T, typename L>
int launch_grad(const void* sem, const void* labels, int n, int h, int w,
                int c, int H, int W, int ignore_index, const void* g,
                void* cols, void* dsem, cudaStream_t st) {
  ce_grad_cols_kernel<T, L><<<blocks_for((long long)n * H * w), kThreads, 0, st>>>(
      (const T*)sem, (const L*)labels, n, h, w, c, H, W, ignore_index,
      (const float*)g, (float*)cols);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ce_grad_rows_kernel<T><<<blocks_for((long long)n * h * w * c), kThreads, 0, st>>>(
      (const float*)cols, n, h, w, c, H, (T*)dsem);
  return (int)cudaGetLastError();
}

}  // namespace

// sem: [n, h, w, c] contiguous, f32 (sem_is_bf16 == 0) or bf16; labels:
// [n, H, W] contiguous int32 (labels_are_i64 == 0) or int64; partials: f32
// scratch of [n, blocks, 2]; loss_out, count_out: f32 [n].  Two launches;
// returns the first nonzero cudaGetLastError().
extern "C" int upsample_ce_sums(const void* sem, int sem_is_bf16,
                                const void* labels, int labels_are_i64, int n,
                                int h, int w, int c, int H, int W,
                                int ignore_index, void* partials, int blocks,
                                void* loss_out, void* count_out, void* stream) {
  if ((long long)n * H * W == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (sem_is_bf16) {
    return labels_are_i64
        ? launch_sums<__nv_bfloat16, int64_t>(sem, labels, n, h, w, c, H, W,
              ignore_index, partials, blocks, loss_out, count_out, st)
        : launch_sums<__nv_bfloat16, int32_t>(sem, labels, n, h, w, c, H, W,
              ignore_index, partials, blocks, loss_out, count_out, st);
  }
  return labels_are_i64
      ? launch_sums<float, int64_t>(sem, labels, n, h, w, c, H, W,
            ignore_index, partials, blocks, loss_out, count_out, st)
      : launch_sums<float, int32_t>(sem, labels, n, h, w, c, H, W,
            ignore_index, partials, blocks, loss_out, count_out, st);
}

// As upsample_ce_sums, plus g: f32 device scalar; cols: f32 scratch of
// [n, H, w, c]; dsem: [n, h, w, c] in sem's type.  Two launches.
extern "C" int upsample_ce_grad(const void* sem, int sem_is_bf16,
                                const void* labels, int labels_are_i64, int n,
                                int h, int w, int c, int H, int W,
                                int ignore_index, const void* g, void* cols,
                                void* dsem, void* stream) {
  if ((long long)n * h * w * c == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (sem_is_bf16) {
    return labels_are_i64
        ? launch_grad<__nv_bfloat16, int64_t>(sem, labels, n, h, w, c, H, W,
              ignore_index, g, cols, dsem, st)
        : launch_grad<__nv_bfloat16, int32_t>(sem, labels, n, h, w, c, H, W,
              ignore_index, g, cols, dsem, st);
  }
  return labels_are_i64
      ? launch_grad<float, int64_t>(sem, labels, n, h, w, c, H, W,
            ignore_index, g, cols, dsem, st)
      : launch_grad<float, int32_t>(sem, labels, n, h, w, c, H, W,
            ignore_index, g, cols, dsem, st);
}
