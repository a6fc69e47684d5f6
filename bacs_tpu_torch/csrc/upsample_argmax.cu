// Fused bilinear upsample + argmax + max-softmax confidence (serving).
//
// Replaces the TPU kernel `_argmax_conf_pallas` (bacs_tpu/ops/upsample_argmax.py:88,
// pallas_call at :98).  Computes, for every output pixel of
// bilinear_upsample(sem) (half-pixel centres, align_corners=False, source
// coordinates clamped to the edge, the weights of `interp_matrix`):
//   preds = argmax over channels (uint8, first index wins on ties)
//   conf  = max softmax probability = 1 / sum_c exp(up_c - max)   (f16)
// all in f32, without ever storing the [N, H, W, C] full-resolution logits.
//
// Design: one thread per output pixel, a loop over channels.  Each pixel
// reads at most 2x2 source pixels; neighbouring threads of a warp read the
// same few source pixels (8x-16x upsampling), which L1 and L2 serve: the
// input is [16, 32, 32, 21] bf16 = 0.7 MB at the serving shape.  The loop
// keeps an online max / rescaled exp-sum, so each channel is read once.
// The TPU kernel's row blocks, -1e30 channel padding and interpolation
// matmuls are TPU tiling choices and are not carried over.
//
// Bound on the H100: device memory moves only the 3 output bytes per
// pixel (12.6 MB for 16 x 512 x 512, about 4 us at 3.35 TB/s); the
// per-pixel work (4 loads, ~7 FMAs and one expf per channel) is larger, so
// the kernel is bound by instruction issue and L1 traffic, not by HBM.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, [16, 32, 32, 21] bf16 ->
// 512^2: 0.18 ms, against 2.86 ms for the plain version (PERF.md).
//
// Tolerance against the plain version (bacs_tpu_torch/ops/upsample_argmax.py,
// argmax_conf_plain): preds equal wherever the top-2 margin of the upsampled
// logits exceeds 1e-4 (the two sum the interpolation terms in another order),
// confidence within 1e-3 (f16 rounding).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bilinear_taps.cuh"

namespace {

template <typename T>
__global__ void upsample_argmax_conf_kernel(const T* __restrict__ sem, int n,
                                            int h, int w, int c, int H, int W,
                                            uint8_t* __restrict__ preds,
                                            __half* __restrict__ conf) {
  const long long total = (long long)n * H * W;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= total) return;
  const int ox = (int)(p % W);
  const int oy = (int)((p / W) % H);
  const int b = (int)(p / ((long long)H * W));
  const bacs_taps::Taps<T> up(sem + (size_t)b * h * w * c, h, w, c, H, W, oy, ox);

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
  preds[p] = (uint8_t)arg;
  conf[p] = __float2half_rn(1.f / s);
}

}  // namespace

// sem: [n, h, w, c] contiguous, f32 (sem_is_bf16 == 0) or bf16;
// preds: uint8 [n, H, W]; conf: f16 [n, H, W].  Returns cudaGetLastError().
extern "C" int upsample_argmax_conf(const void* sem, int sem_is_bf16, int n,
                                    int h, int w, int c, int H, int W,
                                    void* preds, void* conf, void* stream) {
  const long long total = (long long)n * H * W;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  if (sem_is_bf16) {
    upsample_argmax_conf_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        (const __nv_bfloat16*)sem, n, h, w, c, H, W, (uint8_t*)preds,
        (__half*)conf);
  } else {
    upsample_argmax_conf_kernel<float><<<blocks, threads, 0, st>>>(
        (const float*)sem, n, h, w, c, H, W, (uint8_t*)preds, (__half*)conf);
  }
  return (int)cudaGetLastError();
}
