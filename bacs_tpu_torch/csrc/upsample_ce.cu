// Fused bilinear upsample + a per-pixel softmax loss: forward sums and
// gradient, for five losses that share everything but the per-pixel term.
//
// Replaces the TPU kernels of the upsample+loss family:
//   K1, plain CE: forward `_ce_sums_per_image_pallas` (bacs_tpu/ops/
//       upsample_ce.py:787, reduced over images by `_ce_sums_pallas`, :118),
//       backward `_dsem_pallas` (:125);
//   K8, K1's backward with a per-image cotangent (PLOP's adaptive factor):
//       `_dsem_pallas(per_image=True)` (:125, `make_dz_kernel(per_image_g=
//       True)`, upsample_tiles.py:354-375);
//   K6, MiB's unbiased CE: forward and backward `_uce_pallas` (:543), terms
//       `_uce_terms` (:515);
//   K7, MiB's unbiased KD of an upsampled student/teacher pair: forward and
//       backward `_ukd_pallas` (:695), terms `_ukd_terms` (:658), pair
//       kernels upsample_tiles.py:378-415;
//   K4, class-weighted CE (the dark++ replay term): forward
//       `_wce_sums_pallas` (:233), backward `_dsem_pallas_w` (:243);
//   K3, BACS seen-weighted CE (the incremental step's main loss): forward
//       and backward `_bacs_pallas` (:396), per-pixel terms `_bacs_terms`
//       (:341).
// The TPU kernels are `make_sums_kernel(fn)` / `make_dz_kernel(fn)`
// (bacs_tpu/ops/upsample_tiles.py:334-375) over a per-tile term; here a
// device functor (CeTerm, WceTerm, BacsTerm) gives one output pixel's loss
// sums and its per-channel gradient, and the kernels below are templates
// over it.  For logits up = bilinear_upsample(sem) (half-pixel centres,
// clamped: the weights of `interp_matrix`) and labels t, `ignore_index`
// dropped:
//   K1: per image, sum of logsumexp(up) - up[t], and the valid count;
//       d/dup = softmax - onehot(t).
//   K4: per image, sum of w[t] (logsumexp(up) - up[t]) and of w[t] (w a
//       constant class-weight vector, 0 for a label outside [0, C));
//       d/dup = w[t] (softmax - onehot(t)).
//   K3: per image, sum of l1 + l2, where with p = softmax(up), m_s the
//       pixel's max seen-probability (1 above `threshold`), fm = (1 -
//       [t == 0] m_s)^gamma, lse_fg / lse_old the logsumexp over channels
//       >= 1 / < old_classes (eps 1e-30 inside the log, as the TPU kernel):
//         l1 = t == 0 ? fm (lse - up[0])      : lse - lse_fg
//         l2 = t < old ? (ukd ? lse - lse_old : 0) : lse - up[t]
//       and the hand-derived gradient of `_bacs_terms`:
//         g1 = t == 0 ? fm (p - e0)           : p - s_fg
//         g2 = t < old ? (ukd ? p - s_old : 0) : p - onehot(t)
//       (s_fg, s_old: the softmax restricted to those channels, 0 outside).
//   K6: per image, sum of l = t < old ? lse - lse_old : lse - up[t] (K3's
//       l2 with ukd, its own functor so K3 stays as it is), and the valid
//       count; d/dup = t < old ? p - s_old : p - onehot(t).
//   K7: no labels, every output pixel counts.  Student logits z (c
//       channels), teacher logits u (c_old < c channels, the same taps),
//       q = softmax(alpha u), G = {0} u [c_old, c):
//         T = (q0 lse_G + sum_{1 <= i < c_old} q_i z_i - lse) / c_old,
//         dT/dz = (q0 s_G + q 1[1 <= i < c_old] - p) / c_old,
//       per image the sum of T; the teacher takes no gradient.
// Backward: dsem = K_H^T . (d/dup * valid * g) . K_W, g a device scalar
// (the mean's 1 / count, 1 / sum(w) or 1 / (N H W), from autograd) or, for
// K8, one value per image.  The [N, H, W, C] full-resolution logits never
// exist.
//
// Design.  Forward: one thread per output pixel (grid-stride within its
// image, grid = (blocks per image, N)); the functor makes one online pass
// over the channels (running max, the rescaled exp-sums it needs and the
// logits it picks) and returns the pixel's two sums; a block sum in a fixed
// order goes to a [N, blocks, 2] scratch, and a second launch sums each
// image's partials in a fixed order.  No float atomics, so the sums are
// deterministic.  The TPU grid ran in order and carried the sums in
// scratch; Hopper's blocks run in parallel.  Backward, in the gather form
// (deterministic, no atomics), separable as the plain version's einsums:
//   pass 1, one thread per (n, output row oy, source column x): for every
//     output column ox whose taps include x, the functor recomputes the
//     pixel's statistics and its gradient coefficients, and the thread adds
//     w_x(ox) * g * d/dup into 32 channel accumulators in registers ->
//     cols[n, oy, x, :] (f32 scratch);
//   pass 2, one thread per dsem element (n, y, x, c): the sum over the
//     output rows whose taps include y of w_y(oy) * cols[n, oy, x, c].
// Each output pixel's statistics are recomputed by the (at most two)
// source columns it touches, and its exponentials again per channel chunk:
// about 4x the forward's exponentials.  K3's gradient needs three
// normalisers (all channels, foreground, old classes), kept per pixel as
// three coefficients.  K7 reads its teacher's taps beside the student's
// (pair kernels below, on the same reductions and the same second pass);
// the teacher's softmax weights are recomputed where the student's pass
// needs them, not held in an array that would spill.  The TPU kernels' row
// blocks, -1e30 channel padding,
// hoisted W-interp einsum, `W % 128` gate and fixed ignore label 255 are
// TPU tiling and are not carried over; every shape and ignore label is
// taken.
//
// Bound on the H100 at the training shapes (sem [16, 32, 32, 21] bf16 for
// K1, [16, 32, 32, 17] for K3, [12, 32, 32, 17] for K4, K6, K7 (its teacher
// [12, 32, 32, 16]) and K8; labels [n, 512, 512] int32; K3 also max_seen
// [16, 512, 512] f32): the forward moves
// 17-34 MB (5-10 us at 3.35 TB/s) but computes ~70-90 M upsampled logits,
// each with 4 loads, 3 lerps and an exponential, so it is bound by
// operations (instruction issue and the SFU's exponentials), not by device
// memory.  The backward does four times the exponentials.  Measured times
// are in PERF.md.
//
// Tolerance against the plain versions (bacs_tpu_torch/ops/upsample_ce.py):
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

// Online max m and rescaled exp-sum s of the c upsampled logits at one
// pixel, the logit of label t (0 where t is outside [0, c)), and, where
// the caller asks (old >= 0), the exp-sums over channels >= 1 (s_fg) and
// < old (s_old) and the logit of channel 0, all relative to the same m.
struct Stats {
  float m, s, picked, s_fg, s_old, x0;
};

template <typename T>
__device__ __forceinline__ Stats pixel_stats(const bacs_taps::Taps<T>& up,
                                             int c, long long t, int old) {
  Stats st{-INFINITY, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int ch = 0; ch < c; ++ch) {
    const float v = up(ch);
    if (v > st.m) {
      const float r = expf(st.m - v);
      st.s = st.s * r + 1.f;
      if (old >= 0) {
        st.s_fg = st.s_fg * r + (ch >= 1 ? 1.f : 0.f);
        st.s_old = st.s_old * r + (ch < old ? 1.f : 0.f);
      }
      st.m = v;
    } else {
      const float e = expf(v - st.m);
      st.s += e;
      if (old >= 0) {
        if (ch >= 1) st.s_fg += e;
        if (ch < old) st.s_old += e;
      }
    }
    if (ch == t) st.picked = v;
    if (ch == 0) st.x0 = v;
  }
  return st;
}

// The gradient of one output pixel, d/dup[ch] scaled by the tap weight
// times g: e(ch) * (a + [ch >= 1] a_fg + [ch < old] a_old)
//          - [ch == 0] d0 - [ch == t] dt,  e(ch) = exp(up[ch] - m).
struct PixelGrad {
  float m, a, a_fg, a_old, d0, dt;
  long long t;
  int old;

  __device__ __forceinline__ float operator()(int ch, float v) const {
    float coef = a;
    if (ch >= 1) coef += a_fg;
    if (ch < old) coef += a_old;
    return coef * expf(v - m) - (ch == 0 ? d0 : 0.f) - (ch == t ? dt : 0.f);
  }
};

// K1: plain cross-entropy.
struct CeTerm {
  template <typename T>
  __device__ __forceinline__ float2 value(const bacs_taps::Taps<T>& up, int c,
                                          long long t, long long) const {
    const Stats st = pixel_stats(up, c, t, -1);
    return make_float2(st.m + logf(st.s) - st.picked, 1.f);
  }
  // false where the pixel adds nothing to the gradient
  template <typename T>
  __device__ __forceinline__ bool grad(const bacs_taps::Taps<T>& up, int c,
                                       long long t, long long, float wg,
                                       PixelGrad& pg) const {
    const Stats st = pixel_stats(up, c, t, -1);
    pg = PixelGrad{st.m, wg / st.s, 0.f, 0.f, 0.f, wg, t, 0};
    return true;
  }
};

// K4: class-weighted cross-entropy, weights [c] f32.
struct WceTerm {
  const float* w;

  template <typename T>
  __device__ __forceinline__ float2 value(const bacs_taps::Taps<T>& up, int c,
                                          long long t, long long) const {
    const float wt = (t >= 0 && t < c) ? w[t] : 0.f;
    if (wt == 0.f) return make_float2(0.f, 0.f);
    const Stats st = pixel_stats(up, c, t, -1);
    return make_float2(wt * (st.m + logf(st.s) - st.picked), wt);
  }
  template <typename T>
  __device__ __forceinline__ bool grad(const bacs_taps::Taps<T>& up, int c,
                                       long long t, long long, float wg,
                                       PixelGrad& pg) const {
    const float wp = ((t >= 0 && t < c) ? w[t] : 0.f) * wg;
    if (wp == 0.f) return false;
    const Stats st = pixel_stats(up, c, t, -1);
    pg = PixelGrad{st.m, wp / st.s, 0.f, 0.f, 0.f, wp, t, 0};
    return true;
  }
};

// K3: the BACS seen-weighted terms; max_seen [n, H, W] f32, indexed by the
// pixel's flat index in the batch.
struct BacsTerm {
  const float* max_seen;
  int old;
  int ukd;
  float gamma, threshold;

  __device__ __forceinline__ float focal(long long t, long long q) const {
    if (t != 0) return 1.f;
    const float ms = max_seen[q];
    return powf(1.f - (ms > threshold ? 1.f : ms), gamma);
  }
  template <typename T>
  __device__ __forceinline__ float2 value(const bacs_taps::Taps<T>& up, int c,
                                          long long t, long long q) const {
    constexpr float eps = 1e-30f;
    const Stats st = pixel_stats(up, c, t, old);
    const float lse = st.m + logf(st.s);
    const float l1 = t == 0 ? focal(t, q) * (lse - st.x0)
                            : lse - (st.m + logf(st.s_fg + eps));
    float l2 = lse - st.picked;
    if (t < old) l2 = ukd ? lse - (st.m + logf(st.s_old + eps)) : 0.f;
    return make_float2(l1 + l2, 1.f);
  }
  template <typename T>
  __device__ __forceinline__ bool grad(const bacs_taps::Taps<T>& up, int c,
                                       long long t, long long q, float wg,
                                       PixelGrad& pg) const {
    constexpr float eps = 1e-30f;
    const Stats st = pixel_stats(up, c, t, old);
    pg = PixelGrad{st.m, 0.f, 0.f, 0.f, 0.f, 0.f, t, old};
    const float inv_s = 1.f / st.s;
    if (t == 0) {  // term 1: fm (p - e0)
      const float fm = focal(t, q) * wg;
      pg.a += fm * inv_s;
      pg.d0 += fm;
    } else {  // term 1: p - s_fg
      pg.a += wg * inv_s;
      pg.a_fg -= wg / (st.s_fg + eps);
    }
    if (t >= old) {  // term 2: p - onehot
      pg.a += wg * inv_s;
      pg.dt += wg;
    } else if (ukd) {  // term 2: p - s_old
      pg.a += wg * inv_s;
      pg.a_old -= wg / (st.s_old + eps);
    }
    return true;
  }
};

// K6: MiB's unbiased CE; labels < old score the old classes' mass.
struct UceTerm {
  int old;

  template <typename T>
  __device__ __forceinline__ float2 value(const bacs_taps::Taps<T>& up, int c,
                                          long long t, long long) const {
    constexpr float eps = 1e-30f;
    const Stats st = pixel_stats(up, c, t, old);
    const float lse = st.m + logf(st.s);
    const float l = t < old ? lse - (st.m + logf(st.s_old + eps)) : lse - st.picked;
    return make_float2(l, 1.f);
  }
  template <typename T>
  __device__ __forceinline__ bool grad(const bacs_taps::Taps<T>& up, int c,
                                       long long t, long long, float wg,
                                       PixelGrad& pg) const {
    constexpr float eps = 1e-30f;
    const Stats st = pixel_stats(up, c, t, old);
    pg = PixelGrad{st.m, wg / st.s, 0.f, 0.f, 0.f, 0.f, t, old};
    if (t < old) {  // p - s_old
      pg.a_old = -wg / (st.s_old + eps);
    } else {  // p - onehot
      pg.dt = wg;
    }
    return true;
  }
};

template <typename T, typename L, typename Term>
__global__ void partials_kernel(const T* __restrict__ sem,
                                const L* __restrict__ labels, int h, int w,
                                int c, int H, int W, int ignore_index,
                                Term term, float2* __restrict__ partials) {
  const int n = blockIdx.y;
  const long long hw = (long long)H * W;
  const T* img = sem + (size_t)n * h * w * c;
  const L* lab = labels + (size_t)n * hw;
  float a = 0.f, b = 0.f;
  for (long long p = (long long)blockIdx.x * kThreads + threadIdx.x; p < hw;
       p += (long long)gridDim.x * kThreads) {
    const long long t = (long long)lab[p];
    if (t == ignore_index) continue;
    const bacs_taps::Taps<T> up(img, h, w, c, H, W, (int)(p / W), (int)(p % W));
    const float2 v = term.value(up, c, t, n * hw + p);
    a += v.x;
    b += v.y;
  }
  const float2 r = block_sum2(a, b);
  if (threadIdx.x == 0) partials[(size_t)n * gridDim.x + blockIdx.x] = r;
}

__global__ void reduce_kernel(const float2* __restrict__ partials, int blocks,
                              float* __restrict__ a_out,
                              float* __restrict__ b_out) {
  const int n = blockIdx.x;
  float a = 0.f, b = 0.f;
  for (int i = threadIdx.x; i < blocks; i += kThreads) {
    const float2 v = partials[(size_t)n * blocks + i];
    a += v.x;
    b += v.y;
  }
  const float2 r = block_sum2(a, b);
  if (threadIdx.x == 0) {
    a_out[n] = r.x;
    b_out[n] = r.y;
  }
}

template <typename T, typename L, typename Term>
__global__ void grad_cols_kernel(const T* __restrict__ sem,
                                 const L* __restrict__ labels, int n_img,
                                 int h, int w, int c, int H, int W,
                                 int ignore_index, Term term,
                                 const float* __restrict__ g, int g_stride,
                                 float* __restrict__ cols) {
  const long long total = (long long)n_img * H * w;
  const long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (q >= total) return;
  const int x = (int)(q % w);
  const int oy = (int)((q / w) % H);
  const int n = (int)(q / ((long long)H * w));
  const T* img = sem + (size_t)n * h * w * c;
  const long long row = ((long long)n * H + oy) * W;
  const L* lab = labels + row;
  const float gv = g[(long long)n * g_stride];  // stride 0: one scalar
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
      PixelGrad pg;
      if (!term.grad(up, c, t, row + ox, wx * gv, pg)) continue;
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const int ch = c0 + k;
        if (ch < c) acc[k] += pg(ch, up(ch));
      }
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (c0 + k < c) out[c0 + k] = acc[k];
    }
  }
}

template <typename T>
__global__ void grad_rows_kernel(const float* __restrict__ cols, int n_img,
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

// The arguments every entry point shares.
struct Problem {
  const void* sem;
  int sem_is_bf16;
  const void* labels;
  int labels_are_i64;
  int n, h, w, c, H, W, ignore_index;
};

template <typename T, typename L, typename Term>
int launch_sums(const Problem& pr, Term term, void* partials, int blocks,
                void* a_out, void* b_out, cudaStream_t st) {
  partials_kernel<T, L, Term><<<dim3(blocks, pr.n), kThreads, 0, st>>>(
      (const T*)pr.sem, (const L*)pr.labels, pr.h, pr.w, pr.c, pr.H, pr.W,
      pr.ignore_index, term, (float2*)partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_kernel<<<pr.n, kThreads, 0, st>>>((const float2*)partials, blocks,
                                           (float*)a_out, (float*)b_out);
  return (int)cudaGetLastError();
}

template <typename T, typename L, typename Term>
int launch_grad(const Problem& pr, Term term, const void* g, int g_stride,
                void* cols, void* dsem, cudaStream_t st) {
  grad_cols_kernel<T, L, Term>
      <<<blocks_for((long long)pr.n * pr.H * pr.w), kThreads, 0, st>>>(
          (const T*)pr.sem, (const L*)pr.labels, pr.n, pr.h, pr.w, pr.c, pr.H,
          pr.W, pr.ignore_index, term, (const float*)g, g_stride, (float*)cols);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  grad_rows_kernel<T>
      <<<blocks_for((long long)pr.n * pr.h * pr.w * pr.c), kThreads, 0, st>>>(
          (const float*)cols, pr.n, pr.h, pr.w, pr.c, pr.H, (T*)dsem);
  return (int)cudaGetLastError();
}

template <typename Term>
int sums(const Problem& pr, Term term, void* partials, int blocks, void* a_out,
         void* b_out, void* stream) {
  if ((long long)pr.n * pr.H * pr.W == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (pr.sem_is_bf16) {
    return pr.labels_are_i64
        ? launch_sums<__nv_bfloat16, int64_t>(pr, term, partials, blocks, a_out, b_out, st)
        : launch_sums<__nv_bfloat16, int32_t>(pr, term, partials, blocks, a_out, b_out, st);
  }
  return pr.labels_are_i64
      ? launch_sums<float, int64_t>(pr, term, partials, blocks, a_out, b_out, st)
      : launch_sums<float, int32_t>(pr, term, partials, blocks, a_out, b_out, st);
}

// g_stride 0: g is one scalar; 1: g holds one value per image (K8).
template <typename Term>
int grad(const Problem& pr, Term term, const void* g, void* cols, void* dsem,
         void* stream, int g_stride = 0) {
  if ((long long)pr.n * pr.h * pr.w * pr.c == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (pr.sem_is_bf16) {
    return pr.labels_are_i64
        ? launch_grad<__nv_bfloat16, int64_t>(pr, term, g, g_stride, cols, dsem, st)
        : launch_grad<__nv_bfloat16, int32_t>(pr, term, g, g_stride, cols, dsem, st);
  }
  return pr.labels_are_i64
      ? launch_grad<float, int64_t>(pr, term, g, g_stride, cols, dsem, st)
      : launch_grad<float, int32_t>(pr, term, g, g_stride, cols, dsem, st);
}

// ---- K7: the unbiased KD of a student/teacher pair, no labels.

// One output pixel's K7 statistics: the teacher's running max mo and
// exp-sum so of alpha u; the student's running max m, exp-sum s, exp-sum
// sg over G and sz = sum_{1 <= i < c_old} exp(alpha u_i - mo) z_i.
struct UkdStats {
  float mo, so, m, s, sg, sz;
};

template <typename T>
__device__ __forceinline__ UkdStats ukd_stats(const bacs_taps::Taps<T>& up, int c,
                                              const bacs_taps::Taps<T>& upo,
                                              int c_old, float alpha) {
  UkdStats r{-INFINITY, 0.f, -INFINITY, 0.f, 0.f, 0.f};
  for (int ch = 0; ch < c_old; ++ch) {
    const float v = alpha * upo(ch);
    if (v > r.mo) {
      r.so = r.so * expf(r.mo - v) + 1.f;
      r.mo = v;
    } else {
      r.so += expf(v - r.mo);
    }
  }
  for (int ch = 0; ch < c; ++ch) {
    const float v = up(ch);
    const bool in_g = ch == 0 || ch >= c_old;
    if (v > r.m) {
      const float sc = expf(r.m - v);
      r.s = r.s * sc + 1.f;
      r.sg = r.sg * sc + (in_g ? 1.f : 0.f);
      r.m = v;
    } else {
      const float e = expf(v - r.m);
      r.s += e;
      if (in_g) r.sg += e;
    }
    if (!in_g) r.sz += expf(alpha * upo(ch) - r.mo) * v;  // the teacher's
  }                                                        // channels only
  return r;
}

template <typename T>
__global__ void ukd_partials_kernel(const T* __restrict__ sem,
                                    const T* __restrict__ sem_old, int h, int w,
                                    int c, int c_old, int H, int W, float alpha,
                                    float2* __restrict__ partials) {
  constexpr float eps = 1e-30f;
  const int n = blockIdx.y;
  const long long hw = (long long)H * W;
  const T* img = sem + (size_t)n * h * w * c;
  const T* img_old = sem_old + (size_t)n * h * w * c_old;
  float a = 0.f;
  for (long long p = (long long)blockIdx.x * kThreads + threadIdx.x; p < hw;
       p += (long long)gridDim.x * kThreads) {
    const int oy = (int)(p / W), ox = (int)(p % W);
    const bacs_taps::Taps<T> up(img, h, w, c, H, W, oy, ox);
    const bacs_taps::Taps<T> upo(img_old, h, w, c_old, H, W, oy, ox);
    const UkdStats r = ukd_stats(up, c, upo, c_old, alpha);
    const float q0 = expf(alpha * upo(0) - r.mo) / r.so;
    const float lse_g = r.m + logf(r.sg + eps);
    a += (q0 * lse_g + r.sz / r.so - (r.m + logf(r.s))) / (float)c_old;
  }
  const float2 sum = block_sum2(a, 0.f);
  if (threadIdx.x == 0) partials[(size_t)n * gridDim.x + blockIdx.x] = sum;
}

// Pass 1 of the K7 gradient, as grad_cols_kernel: one thread per (n,
// output row, source column), the student's gradient only.
template <typename T>
__global__ void ukd_grad_cols_kernel(const T* __restrict__ sem,
                                     const T* __restrict__ sem_old, int n_img,
                                     int h, int w, int c, int c_old, int H, int W,
                                     float alpha, const float* __restrict__ g,
                                     float* __restrict__ cols) {
  constexpr float eps = 1e-30f;
  const long long total = (long long)n_img * H * w;
  const long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (q >= total) return;
  const int x = (int)(q % w);
  const int oy = (int)((q / w) % H);
  const int n = (int)(q / ((long long)H * w));
  const T* img = sem + (size_t)n * h * w * c;
  const T* img_old = sem_old + (size_t)n * h * w * c_old;
  const float gv = *g / (float)c_old;
  int first, last;
  bacs_taps::support(x, W, w, first, last);
  float* out = cols + (size_t)q * c;
  for (int c0 = 0; c0 < c; c0 += kChunk) {
    float acc[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) acc[k] = 0.f;
    for (int ox = first; ox <= last; ++ox) {
      const float wx = bacs_taps::tap_weight(ox, W, w, x);
      if (wx == 0.f) continue;
      const bacs_taps::Taps<T> up(img, h, w, c, H, W, oy, ox);
      const bacs_taps::Taps<T> upo(img_old, h, w, c_old, H, W, oy, ox);
      const UkdStats r = ukd_stats(up, c, upo, c_old, alpha);
      const float wg = wx * gv;
      const float inv_so = 1.f / r.so;
      // e(ch) (q0 / (sg + eps) [ch in G] - 1 / s) + q_ch [1 <= ch < c_old]
      const float a_g = wg * expf(alpha * upo(0) - r.mo) * inv_so / (r.sg + eps);
      const float a_all = wg / r.s;
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const int ch = c0 + k;
        if (ch >= c) continue;
        const bool in_g = ch == 0 || ch >= c_old;
        const float e = expf(up(ch) - r.m);
        float d = e * ((in_g ? a_g : 0.f) - a_all);
        if (!in_g) d += wg * expf(alpha * upo(ch) - r.mo) * inv_so;
        acc[k] += d;
      }
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (c0 + k < c) out[c0 + k] = acc[k];
    }
  }
}

template <typename T>
int launch_ukd_sum(const void* sem, const void* sem_old, int n, int h, int w,
                   int c, int c_old, int H, int W, float alpha, void* partials,
                   int blocks, void* t_out, void* b_out, cudaStream_t st) {
  ukd_partials_kernel<T><<<dim3(blocks, n), kThreads, 0, st>>>(
      (const T*)sem, (const T*)sem_old, h, w, c, c_old, H, W, alpha,
      (float2*)partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_kernel<<<n, kThreads, 0, st>>>((const float2*)partials, blocks,
                                        (float*)t_out, (float*)b_out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_ukd_grad(const void* sem, const void* sem_old, int n, int h, int w,
                    int c, int c_old, int H, int W, float alpha, const void* g,
                    void* cols, void* dsem, cudaStream_t st) {
  ukd_grad_cols_kernel<T><<<blocks_for((long long)n * H * w), kThreads, 0, st>>>(
      (const T*)sem, (const T*)sem_old, n, h, w, c, c_old, H, W, alpha,
      (const float*)g, (float*)cols);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  grad_rows_kernel<T><<<blocks_for((long long)n * h * w * c), kThreads, 0, st>>>(
      (const float*)cols, n, h, w, c, H, (T*)dsem);
  return (int)cudaGetLastError();
}

}  // namespace

// Common arguments: sem [n, h, w, c] contiguous, f32 (sem_is_bf16 == 0) or
// bf16; labels [n, H, W] contiguous int32 (labels_are_i64 == 0) or int64.
// Sums: partials f32 scratch of [n, blocks, 2]; a_out, b_out f32 [n].
// Gradients: g f32 device scalar; cols f32 scratch of [n, H, w, c]; dsem
// [n, h, w, c] in sem's type.  Each makes two launches and returns the
// first nonzero cudaGetLastError().

// K1 forward: a_out = per-image NLL sums, b_out = valid counts.
extern "C" int upsample_ce_sums(const void* sem, int sem_is_bf16,
                                const void* labels, int labels_are_i64, int n,
                                int h, int w, int c, int H, int W,
                                int ignore_index, void* partials, int blocks,
                                void* loss_out, void* count_out, void* stream) {
  const Problem pr{sem, sem_is_bf16, labels, labels_are_i64, n, h, w, c, H, W,
                   ignore_index};
  return sums(pr, CeTerm{}, partials, blocks, loss_out, count_out, stream);
}

// K1 backward.
extern "C" int upsample_ce_grad(const void* sem, int sem_is_bf16,
                                const void* labels, int labels_are_i64, int n,
                                int h, int w, int c, int H, int W,
                                int ignore_index, const void* g, void* cols,
                                void* dsem, void* stream) {
  const Problem pr{sem, sem_is_bf16, labels, labels_are_i64, n, h, w, c, H, W,
                   ignore_index};
  return grad(pr, CeTerm{}, g, cols, dsem, stream);
}

// K8: K1 backward with g f32 [n], one cotangent per image.
extern "C" int upsample_ce_grad_per_image(const void* sem, int sem_is_bf16,
                                          const void* labels, int labels_are_i64,
                                          int n, int h, int w, int c, int H, int W,
                                          int ignore_index, const void* g,
                                          void* cols, void* dsem, void* stream) {
  const Problem pr{sem, sem_is_bf16, labels, labels_are_i64, n, h, w, c, H, W,
                   ignore_index};
  return grad(pr, CeTerm{}, g, cols, dsem, stream, 1);
}

// K4 forward, weights f32 [c]: a_out = per-image sums of w[t] NLL, b_out =
// per-image sums of w[t].
extern "C" int upsample_wce_sums(const void* sem, int sem_is_bf16,
                                 const void* labels, int labels_are_i64, int n,
                                 int h, int w, int c, int H, int W,
                                 int ignore_index, const void* weights,
                                 void* partials, int blocks, void* loss_out,
                                 void* wsum_out, void* stream) {
  const Problem pr{sem, sem_is_bf16, labels, labels_are_i64, n, h, w, c, H, W,
                   ignore_index};
  return sums(pr, WceTerm{(const float*)weights}, partials, blocks, loss_out,
              wsum_out, stream);
}

// K4 backward.
extern "C" int upsample_wce_grad(const void* sem, int sem_is_bf16,
                                 const void* labels, int labels_are_i64, int n,
                                 int h, int w, int c, int H, int W,
                                 int ignore_index, const void* weights,
                                 const void* g, void* cols, void* dsem,
                                 void* stream) {
  const Problem pr{sem, sem_is_bf16, labels, labels_are_i64, n, h, w, c, H, W,
                   ignore_index};
  return grad(pr, WceTerm{(const float*)weights}, g, cols, dsem, stream);
}

// K3 forward, max_seen f32 [n, H, W]: a_out = per-image sums of the BACS
// terms, b_out = valid counts.
extern "C" int upsample_bacs_sum(const void* sem, int sem_is_bf16,
                                 const void* labels, int labels_are_i64, int n,
                                 int h, int w, int c, int H, int W,
                                 int ignore_index, const void* max_seen,
                                 int old_classes, int ukd, float gamma,
                                 float threshold, void* partials, int blocks,
                                 void* loss_out, void* count_out,
                                 void* stream) {
  const Problem pr{sem, sem_is_bf16, labels, labels_are_i64, n, h, w, c, H, W,
                   ignore_index};
  const BacsTerm term{(const float*)max_seen, old_classes, ukd, gamma, threshold};
  return sums(pr, term, partials, blocks, loss_out, count_out, stream);
}

// K3 backward.
extern "C" int upsample_bacs_grad(const void* sem, int sem_is_bf16,
                                  const void* labels, int labels_are_i64,
                                  int n, int h, int w, int c, int H, int W,
                                  int ignore_index, const void* max_seen,
                                  int old_classes, int ukd, float gamma,
                                  float threshold, const void* g, void* cols,
                                  void* dsem, void* stream) {
  const Problem pr{sem, sem_is_bf16, labels, labels_are_i64, n, h, w, c, H, W,
                   ignore_index};
  const BacsTerm term{(const float*)max_seen, old_classes, ukd, gamma, threshold};
  return grad(pr, term, g, cols, dsem, stream);
}

// K6 forward: a_out = per-image sums of the unbiased CE, b_out = valid
// counts.
extern "C" int upsample_uce_sums(const void* sem, int sem_is_bf16,
                                 const void* labels, int labels_are_i64, int n,
                                 int h, int w, int c, int H, int W,
                                 int ignore_index, int old_classes,
                                 void* partials, int blocks, void* loss_out,
                                 void* count_out, void* stream) {
  const Problem pr{sem, sem_is_bf16, labels, labels_are_i64, n, h, w, c, H, W,
                   ignore_index};
  return sums(pr, UceTerm{old_classes}, partials, blocks, loss_out, count_out,
              stream);
}

// K6 backward.
extern "C" int upsample_uce_grad(const void* sem, int sem_is_bf16,
                                 const void* labels, int labels_are_i64, int n,
                                 int h, int w, int c, int H, int W,
                                 int ignore_index, int old_classes,
                                 const void* g, void* cols, void* dsem,
                                 void* stream) {
  const Problem pr{sem, sem_is_bf16, labels, labels_are_i64, n, h, w, c, H, W,
                   ignore_index};
  return grad(pr, UceTerm{old_classes}, g, cols, dsem, stream);
}

// K7 forward: sem [n, h, w, c] and sem_old [n, h, w, c_old], both f32 or
// both bf16; t_out = per-image sums of T, b_out f32 [n] scratch (zeros).
extern "C" int upsample_ukd_sum(const void* sem, const void* sem_old,
                                int sem_is_bf16, int n, int h, int w, int c,
                                int c_old, int H, int W, float alpha,
                                void* partials, int blocks, void* t_out,
                                void* b_out, void* stream) {
  if ((long long)n * H * W == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return sem_is_bf16
      ? launch_ukd_sum<__nv_bfloat16>(sem, sem_old, n, h, w, c, c_old, H, W, alpha,
                                      partials, blocks, t_out, b_out, st)
      : launch_ukd_sum<float>(sem, sem_old, n, h, w, c, c_old, H, W, alpha,
                              partials, blocks, t_out, b_out, st);
}

// K7 backward: the student's dsem times the scalar g; cols f32 scratch of
// [n, H, w, c].
extern "C" int upsample_ukd_grad(const void* sem, const void* sem_old,
                                 int sem_is_bf16, int n, int h, int w, int c,
                                 int c_old, int H, int W, float alpha,
                                 const void* g, void* cols, void* dsem,
                                 void* stream) {
  if ((long long)n * h * w * c == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return sem_is_bf16
      ? launch_ukd_grad<__nv_bfloat16>(sem, sem_old, n, h, w, c, c_old, H, W, alpha,
                                       g, cols, dsem, st)
      : launch_ukd_grad<float>(sem, sem_old, n, h, w, c, c_old, H, W, alpha, g,
                               cols, dsem, st);
}
