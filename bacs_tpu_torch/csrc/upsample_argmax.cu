// Fused bilinear upsample + argmax + max-softmax confidence (serving, K10).
//
// Replaces the TPU kernel `_argmax_conf_pallas` (bacs_tpu/ops/upsample_argmax.py:88,
// pallas_call at :98).  Computes, for every output pixel of
// bilinear_upsample(sem) (half-pixel centres, align_corners=False, source
// coordinates clamped to the edge, the weights of `interp_matrix`):
//   preds = argmax over channels (uint8, the first channel that reaches
//           the max, as torch.argmax and jnp.argmax)
//   conf  = max softmax probability = 1 / sum_c exp(up_c - max)   (f16)
// all in f32, without ever storing the [N, H, W, C] full-resolution logits.
//
// Design: `pixel_kernel` of upsample_stage.cuh with `ArgmaxConfTerm`.  The
// taps and the bands of output rows come from the tables that
// ops/upsample_ce.py:launch_plan builds on the host (shared with K1 at the
// same shape); one block per (band of output rows, image) stages each
// output row's H-lerped source columns in shared memory (the whole row),
// and one thread per output pixel W-lerps its channels from the stage into
// registers in chunks of KC (24 for the serving path's 21 channels): the
// chunk's max and its first index, branch-free, then one `ex2.approx` per
// channel, then one reciprocal per pixel.  Past one chunk (up to 256
// channels) a later chunk takes the argmax only on a strict >.  The TPU
// kernel's row blocks, -1e30 channel padding and interpolation matmuls are
// TPU tiling choices and are not carried over.
//
// Bound on the H100 at the serving shape ([16, 32, 32, 21] bf16 -> 512^2):
// device memory moves the 3 output bytes per pixel (12.6 MB, about 4 us at
// 3.35 TB/s); the per-pixel work (a lerp, a max, a compare and an
// exponential per channel, one reciprocal) is larger: bound by the SFU's
// exponentials (~0.022 ms).  Measured times are in PERF.md.
//
// Tolerance against the plain version (bacs_tpu_torch/ops/upsample_argmax.py,
// argmax_conf_plain): preds equal wherever the top-2 margin of the upsampled
// logits exceeds 1e-4 (the two sum the interpolation terms in another order),
// confidence within 1e-3 (f16 rounding, `ex2.approx`, `rcp.approx`).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "upsample_stage.cuh"

namespace {

using namespace upsample_stage;

// K10: the argmax as uint8 and 1 / s as f16; no labels.
struct ArgmaxConfTerm {
  static constexpr bool kLabels = false;
  static constexpr int kMinBlocks = 4;
  struct Acc {};
  uint8_t* preds;
  __half* conf;

  __device__ __forceinline__ Acc start() const { return Acc{}; }
  template <int KC>
  __device__ __forceinline__ void pixel(const Pixel&, int, long long q, const ArgStats& st,
                                        const float (&)[KC], Acc&) const {
    preds[q] = (uint8_t)st.arg;
    conf[q] = __float2half_rn(rcp(st.s));
  }
  __device__ __forceinline__ void flush(Acc&, int) const {}
};

}  // namespace

// sem: [n, h, w, c] contiguous, f32 (sem_is_bf16 == 0) or bf16, c <= 256;
// tables, band, tile, span, rows: the launch plan of
// ops/upsample_ce.py:launch_plan; preds: uint8 [n, H, W]; conf: f16
// [n, H, W].  One launch; returns cudaGetLastError().
extern "C" int upsample_argmax_conf(const void* sem, int sem_is_bf16, int n, int h, int w,
                                    int c, int H, int W, const void* tables, int band,
                                    int tile, int span, int rows, void* preds, void* conf,
                                    void* stream) {
  const Plan plan = make_plan(tables, h, w, H, W, band, tile, span, rows);
  const ArgmaxConfTerm term{(uint8_t*)preds, (__half*)conf};
  cudaStream_t st = (cudaStream_t)stream;
  return sem_is_bf16
      ? launch_pixels<__nv_bfloat16, int32_t>(sem, nullptr, n, h, w, c, H, W, term, plan, st)
      : launch_pixels<float, int32_t>(sem, nullptr, n, h, w, c, H, W, term, plan, st);
}
