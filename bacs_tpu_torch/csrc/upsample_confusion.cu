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
// Design: the staged layout of upsample_stage.cuh (`conf_kernel` below).
// The taps and the bands of output rows come from
// ops/upsample_ce.py:launch_plan; one block per (band of output rows,
// image) stages the H-lerped source columns of two output rows at a time in
// shared memory (`stage_two_rows`: the whole row, the source rows read once
// where the two rows share them; one row where two stages and the
// histogram do not fit, or at a band's odd last row), each column padded to
// 8 floats with NaN, and one thread per output column scans that column in
// both rows together: the W taps read once, each pixel's channels W-lerped
// from the stage in chunks of 8 by 16-byte loads, the chunk's max and
// first index by a tree, a later chunk taking over only on a strict >
// (`argmax_scan2`, no exponential).  The labels are read first, before the
// stage's barriers (the next column's while the current one is scanned); a
// pair of dropped pixels takes no lerp.  The counts are integer bins: an
// nc x nc histogram per block in shared memory beside the stages, one
// atomic per kept pixel, and at the end the block adds its nonzero bins to
// the output with integer atomics.  Where the histogram does not fit beside
// one stage (some 225 classes and more), the pixels add to the output
// itself (L2 integer atomics).  Integer sums are exact in any order, so two
// launches give equal matrices.  Aggregating a warp's increments
// (`__all_sync` for a warp of one bin, `__match_any_sync` groups for a
// mixed one) measured slower on the H100 than one shared-memory atomic per
// pixel, also on logits whose warps mostly fill one bin (PERF.md).  The
// TPU kernel's one-hot matmul on the MXU, row blocks and -1e30 channel
// padding are not carried over.
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
#include <stdint.h>

#include "upsample_stage.cuh"

namespace {

using namespace upsample_stage;

constexpr int KC = 8;  // the channels a chunk of the scan takes

// K2, one block per (band of output rows, image): conf[t, pred] += 1 for
// each pixel whose label t is in [0, nc), the bins in shared memory
// (kShared, after the stages) or the output's.  `staged` output rows are
// staged at once (1 or 2); the stage holds ldc = c rounded up to KC floats
// a column, the padding NaN (no compare selects it), so a pixel reads its
// chunks by 16-byte loads (`PixelVec`).  Each thread scans one column of
// both rows together (two independent chains, one set of W taps).
template <typename T, typename L, bool kShared>
__global__ void __launch_bounds__(kThreads, 4)
conf_kernel(const T* __restrict__ sem, const L* __restrict__ labels, int h, int w, int c,
            int H, int W, int nc, int staged, Plan plan, int* __restrict__ conf) {
  extern __shared__ float stage[];  // [staged, span, ldc], then the histogram
  const int n = blockIdx.y, b = blockIdx.x;
  const int ldc = (c + KC - 1) / KC * KC;
  const T* img = sem + (size_t)n * h * w * c;
  float* stage1 = stage + (staged - 1) * plan.span * ldc;  // the second row's
  int* bins = conf;
  if constexpr (kShared) {
    bins = (int*)(stage + staged * plan.span * ldc);
    for (int i = threadIdx.x; i < nc * nc; i += kThreads) bins[i] = 0;
  }
  const int pad = ldc - c;
  for (int i = threadIdx.x; i < staged * plan.span * pad; i += kThreads) {
    stage[(i / pad) * ldc + c + i % pad] = __int_as_float(0x7fffffff);
  }
  const int oy_end = min(H, (b + 1) * plan.band);
  for (int oy = b * plan.band; oy < oy_end; oy += staged) {
    const bool two = staged == 2 && oy + 1 < oy_end;  // a pixel of the next row
    const float* sb = two ? stage1 : stage;
    const long long row0 = ((long long)n * H + oy) * W, row1 = row0 + W;
    for (int ox0 = 0; ox0 < W; ox0 += plan.tile) {
      const int ox1 = min(W, ox0 + plan.tile);
      const int xs0 = plan.xlo[ox0];
      const int nx = plan.xhi[ox1 - 1] - xs0 + 1;
      // the labels of this thread's first column
      int ox = ox0 + (int)threadIdx.x;
      long long ta = 0, tb = 0;
      if (ox < ox1) {
        ta = labels[row0 + ox];
        if (two) tb = labels[row1 + ox];
      }
      __syncthreads();  // the previous tile is read
      if (two) {
        stage_two_rows(img, w, c, ldc, make_int2(plan.ylo[oy], plan.yhi[oy]), plan.ywt[oy],
                       make_int2(plan.ylo[oy + 1], plan.yhi[oy + 1]), plan.ywt[oy + 1], xs0,
                       nx, stage, stage1);
      } else {
        stage_row(img, w, c, ldc, plan.ylo[oy], plan.yhi[oy], plan.ywt[oy], xs0, nx, stage);
      }
      __syncthreads();
      for (; ox < ox1; ox += kThreads) {
        const long long t0 = ta, t1 = tb;
        const int on = ox + kThreads;  // the next column's labels
        if (on < ox1) {
          ta = labels[row0 + on];
          if (two) tb = labels[row1 + on];
        }
        const bool la = t0 >= 0 && t0 < nc, lb = two && t1 >= 0 && t1 < nc;
        if (!la && !lb) continue;
        const float wx = plan.xwt[ox];
        const int lo = (plan.xlo[ox] - xs0) * ldc, hi = (plan.xhi[ox] - xs0) * ldc;
        const PixelVec pa{(const float4*)(stage + lo), (const float4*)(stage + hi), 1.f - wx,
                          wx};
        const PixelVec pb{(const float4*)(sb + lo), (const float4*)(sb + hi), 1.f - wx, wx};
        int aa, ab;
        argmax_scan2<KC>(pa, pb, c, aa, ab);
        if (la) atomicAdd(bins + (int)t0 * nc + min(aa, nc - 1), 1);
        if (lb) atomicAdd(bins + (int)t1 * nc + min(ab, nc - 1), 1);
      }
    }
  }
  if constexpr (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < nc * nc; i += kThreads) {
      const int v = bins[i];
      if (v) atomicAdd(conf + i, v);
    }
  }
}

template <typename T, typename L, bool kShared>
int launch_at(const void* sem, const void* labels, int n, int h, int w, int c, int H, int W,
              int nc, int staged, const Plan& plan, size_t smem, int* conf, cudaStream_t st) {
  cudaError_t err = allow_smem(conf_kernel<T, L, kShared>, smem);
  if (err != cudaSuccess) return (int)err;
  conf_kernel<T, L, kShared><<<dim3(plan.nb, n), kThreads, smem, st>>>(
      (const T*)sem, (const L*)labels, h, w, c, H, W, nc, staged, plan, conf);
  return (int)cudaGetLastError();
}

template <bool kShared>
int launch_typed(const void* sem, int sem_is_bf16, const void* labels, int labels_are_i64,
                 int n, int h, int w, int c, int H, int W, int nc, int staged,
                 const Plan& plan, size_t smem, int* conf, cudaStream_t st) {
  if (sem_is_bf16) {
    return labels_are_i64
        ? launch_at<__nv_bfloat16, int64_t, kShared>(sem, labels, n, h, w, c, H, W, nc, staged,
                                                      plan, smem, conf, st)
        : launch_at<__nv_bfloat16, int32_t, kShared>(sem, labels, n, h, w, c, H, W, nc, staged,
                                                      plan, smem, conf, st);
  }
  return labels_are_i64
      ? launch_at<float, int64_t, kShared>(sem, labels, n, h, w, c, H, W, nc, staged, plan,
                                           smem, conf, st)
      : launch_at<float, int32_t, kShared>(sem, labels, n, h, w, c, H, W, nc, staged, plan,
                                           smem, conf, st);
}

}  // namespace

// sem: [n, h, w, c] contiguous, f32 (sem_is_bf16 == 0) or bf16; labels:
// [n, H, W] contiguous int32 (labels_are_i64 == 0) or int64; tables, band,
// tile, span, rows: the launch plan of ops/upsample_ce.py:launch_plan;
// conf: int32 [num_classes, num_classes], added to (the caller zeroes it).
// One launch; returns cudaGetLastError() (or cudaErrorInvalidValue for a
// plan whose stage does not fit).
extern "C" int upsample_confusion(const void* sem, int sem_is_bf16, const void* labels,
                                  int labels_are_i64, int n, int h, int w, int c, int H,
                                  int W, int num_classes, const void* tables, int band,
                                  int tile, int span, int rows, void* conf, void* stream) {
  if ((long long)n * H * W == 0) return 0;
  const int ldc = (c + KC - 1) / KC * KC;
  const Plan pl = whole_rows(make_plan(tables, h, w, H, W, band, tile, span, rows), w, W, ldc);
  const size_t stage = (size_t)pl.span * ldc * sizeof(float);
  const size_t hist = (size_t)num_classes * num_classes * sizeof(int);
  if (pl.tile < 1 || stage > kSmemMax) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // two rows a stage wherever they fit beside the histogram; the histogram
  // in shared memory wherever it fits beside one
  const bool shared = stage + hist <= kSmemMax;
  const size_t scratch = shared ? hist : 0;
  const int staged = 2 * stage + scratch <= kSmemMax ? 2 : 1;
  const size_t smem = staged * stage + scratch;
  if (shared) {
    return launch_typed<true>(sem, sem_is_bf16, labels, labels_are_i64, n, h, w, c, H, W,
                              num_classes, staged, pl, smem, (int*)conf, st);
  }
  return launch_typed<false>(sem, sem_is_bf16, labels, labels_are_i64, n, h, w, c, H, W,
                             num_classes, staged, pl, smem, (int*)conf, st);
}
