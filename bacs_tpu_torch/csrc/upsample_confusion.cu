// Fused bilinear upsample + argmax + confusion-matrix accumulation (eval).
//
// Replaces the TPU kernel `_conf_pallas` (bacs_tpu/ops/upsample_confusion.py:88,
// pallas_call at :100; K2).  For every output pixel of
// bilinear_upsample(sem) (half-pixel centres, clamped, the weights of
// `interp_matrix`): pred = argmax over channels (first index wins, as
// jnp.argmax), clipped to [0, num_classes); target t = label; pixels with t
// outside [0, num_classes) are dropped; conf[t, pred] += 1 (rows are
// targets, columns predictions).  Neither the full-resolution logits nor
// the prediction map reaches device memory.
//
// Design: one thread per output pixel (grid-stride loop, so a block sees
// many pixels), the argmax over an in-register channel loop, and a
// num_classes^2 int histogram in shared memory bumped with integer
// atomics; each block then adds its nonzero bins to the int32 output with
// integer atomicAdd.  Integer sums are exact in any order, so the result
// is deterministic although blocks run in parallel (the TPU grid ran in
// order and accumulated the whole matrix in one VMEM block).  A histogram
// above the default 48 KB of shared memory (num_classes > 110, e.g. ADE's
// 150) opts in to the H100's 227 KB per block; num_classes > 241 does not
// fit and the launch fails (the wrapper raises first).  The TPU kernel's
// one-hot matmul on the MXU, row blocks and -1e30 channel padding are not
// carried over.
//
// Bound on the H100 at the eval shape, sem [16, 32, 32, 21] bf16 and
// labels [16, 512, 512] int32: 17.5 MB in, 5.2 us at 3.35 TB/s; the
// separable interpolation (3 f32 ops per source-row column and per output
// pixel, each per channel) and an argmax compare are ~4.2 ops per output
// pixel and channel, ~5.5 us at 67 TFLOP/s.  chip_smoke.py computes the
// bound from its run's data; measured times are in PERF.md.
//
// Tolerance against the plain version (bacs_tpu_torch/ops/upsample_confusion.py):
// equal matrices, except for as many pixels as have a top-2 margin of the
// upsampled logits <= 1e-4 (the two sum the interpolation in other orders).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "bilinear_taps.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;
constexpr size_t kDefaultSharedBytes = 48 * 1024;

template <typename T, typename L>
__global__ void upsample_confusion_kernel(const T* __restrict__ sem,
                                          const L* __restrict__ labels, int n,
                                          int h, int w, int c, int H, int W,
                                          int nc, int* __restrict__ conf) {
  extern __shared__ int hist[];
  for (int i = threadIdx.x; i < nc * nc; i += kThreads) hist[i] = 0;
  __syncthreads();
  const long long hw = (long long)H * W;
  const long long total = (long long)n * hw;
  for (long long p = (long long)blockIdx.x * kThreads + threadIdx.x; p < total;
       p += (long long)gridDim.x * kThreads) {
    const long long t = (long long)labels[p];
    if (t < 0 || t >= nc) continue;
    const int b = (int)(p / hw);
    const long long r = p - (long long)b * hw;
    const bacs_taps::Taps<T> up(sem + (size_t)b * h * w * c, h, w, c, H, W,
                                (int)(r / W), (int)(r % W));
    float m = -INFINITY;
    int arg = 0;
    for (int ch = 0; ch < c; ++ch) {
      const float v = up(ch);
      if (v > m) {
        m = v;
        arg = ch;
      }
    }
    atomicAdd(&hist[t * nc + min(arg, nc - 1)], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nc * nc; i += kThreads) {
    if (hist[i]) atomicAdd(&conf[i], hist[i]);
  }
}

template <typename T, typename L>
int launch(const void* sem, const void* labels, int n, int h, int w, int c,
           int H, int W, int nc, void* conf, cudaStream_t st) {
  const long long total = (long long)n * H * W;
  const unsigned blocks = (unsigned)std::min<long long>(
      (total + kThreads - 1) / kThreads, kMaxBlocks);
  const size_t shared = (size_t)nc * nc * sizeof(int);
  if (shared > kDefaultSharedBytes) {
    // fails (cudaErrorInvalidValue) above the card's opt-in limit
    const cudaError_t err = cudaFuncSetAttribute(
        upsample_confusion_kernel<T, L>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, so no later launch reports it
      return (int)err;
    }
  }
  upsample_confusion_kernel<T, L><<<blocks, kThreads, shared, st>>>(
      (const T*)sem, (const L*)labels, n, h, w, c, H, W, nc, (int*)conf);
  return (int)cudaGetLastError();
}

}  // namespace

// sem: [n, h, w, c] contiguous, f32 (sem_is_bf16 == 0) or bf16; labels:
// [n, H, W] contiguous int32 (labels_are_i64 == 0) or int64; conf: int32
// [nc, nc], added to (the caller zeroes it).  Returns cudaGetLastError().
extern "C" int upsample_confusion(const void* sem, int sem_is_bf16,
                                  const void* labels, int labels_are_i64,
                                  int n, int h, int w, int c, int H, int W,
                                  int nc, void* conf, void* stream) {
  if ((long long)n * H * W == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (sem_is_bf16) {
    return labels_are_i64
        ? launch<__nv_bfloat16, int64_t>(sem, labels, n, h, w, c, H, W, nc, conf, st)
        : launch<__nv_bfloat16, int32_t>(sem, labels, n, h, w, c, H, W, nc, conf, st);
  }
  return labels_are_i64
      ? launch<float, int64_t>(sem, labels, n, h, w, c, H, W, nc, conf, st)
      : launch<float, int32_t>(sem, labels, n, h, w, c, H, W, nc, conf, st);
}
