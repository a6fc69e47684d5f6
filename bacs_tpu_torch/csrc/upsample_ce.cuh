// Fused bilinear upsample + a per-pixel softmax loss: forward sums and
// gradient, for five losses that share everything but the per-pixel term.
//
// This header holds the templates; each loss's C entry points are a source
// of their own, so that nvcc compiles the five in parallel:
// upsample_ce.cu (K1, K8), upsample_wce.cu (K4), upsample_bacs.cu (K3),
// upsample_uce.cu (K6) and upsample_ukd.cu (K7).
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
// (bacs_tpu/ops/upsample_tiles.py:334-375, `call_sums` :423 and `call_dz`
// :448) over a per-tile term; here a device functor (CeTerm, WceTerm,
// BacsTerm, UceTerm) gives one output pixel's loss sums and its gradient
// coefficients from the pixel's softmax statistics, and the two kernels
// below (`sums_kernel`, `grad_bands_kernel`) are templates over it.  For
// logits up = bilinear_upsample(sem) (half-pixel centres, clamped: the
// weights of `interp_matrix`) and labels t, `ignore_index` dropped:
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
// Design (K1, K3, K4, K6, K7, K8).  The taps come from tables the wrapper
// builds on the host with the arithmetic of `interp_matrix`
// (ops/upsample_ce.py:tap_tables): per output row and column its source
// pair lo, hi and weight wt, and per source column the output columns
// whose lo (weight 1 - wt) or hi (weight wt) is that column.  No kernel of
// this family divides in double or calls `floor`.  A block takes one image
// and a band of output rows (grid = (bands, N), bands of about N H / 1024
// rows, so ~1024 blocks).  For each output row it stages in shared memory,
// as f32, the rows-lerped source columns that a tile of output pixels
// reads (`stage_row`, the plain version's first einsum; the forward's tile
// is the whole row where it fits, the backward's 256 pixels); one thread
// per output pixel then lerps its channels along W from the stage (one
// lerp a channel) into registers, in chunks of KC (16, 24 or 32 by c, a
// template parameter, so no work for padding past 24 at the main path's 17
// and 21 channels), takes the chunk's max first (branch-free) and then its
// exponentials (`ex2.approx` after one FFMA), once per channel, with a
// rescale per chunk past the first.  The plan, the stage and the chunked
// statistics are in upsample_stage.cuh, shared with K9 and K10.
//   Forward (`sums_kernel`): the functor turns the statistics into the
//     pixel's two sums; a block sum in a fixed order goes to an [N, bands,
//     2] scratch, and a second launch sums each image's partials in a
//     fixed order.
//   Backward (`grad_bands_kernel`): the functor turns the same statistics
//     into gradient coefficients, and the pixel writes g * d/dup of a
//     chunk, times each of its two W weights, to shared memory (with c <=
//     32 the exponentials are still in registers; past 32 channels each
//     chunk's are taken again).  The block then reduces the tile along W
//     in the gather form, each source column's sum over the output columns
//     of its inverse table in a fixed order, and adds it with the row's
//     two weights into an accumulator of the source rows the band touches
//     (in shared memory where it fits, else in the block's slab of the
//     scratch), one thread per (column, channel).  The band's accumulator
//     goes to an [N, bands, rows, w, c] f32 scratch; a second launch
//     (`band_sum_kernel`) sums, for each dsem element, the at most few
//     bands that touch its source row, in band order, and writes dsem in
//     sem's dtype.
// Each output pixel's statistics and exponentials are computed once (c <=
// 32); no float atomics, so two launches on the same inputs give bit-equal
// sums and dsem, and K8 with every g equal is K1 bit for bit.  The TPU
// kernels' row blocks, -1e30 channel padding, hoisted W-interp einsum,
// `W % 128` gate and fixed ignore label 255 are TPU tiling and are not
// carried over; every shape and ignore label is taken.
// K7 runs the same two templates with a teacher stage (`UkdTerm`, kPair):
// each output row's H-lerped source columns of the student (c floats) and
// the teacher (c_old floats) are staged side by side, (c + c_old) | 1
// floats a column (`stage_ld`, and launch_plan sizes the stage so); no
// labels, every pixel counts.  Each output pixel computes its teacher
// softmax (max mo, exp-sum so, q0) and its student statistics (m, s, s_G
// over G = {0} u [c_old, c), sz = sum q_i z_i) once (`pair_stats`), the
// teacher in chunks of 16 channels where c_old <= 16 (KT, so the main
// path's 16 teacher channels take no padding), its exponentials kept in
// registers for sz and the gradient.  The forward reduces per band as the
// other sums; the backward writes g (q0 s_G [i in G] + q [1 <= i < c_old]
// - p) / c_old times the two W weights into the tile and reduces it as
// the other gradients.  Variants measured (PERF.md section 6): q
// taken again from the stage instead of registers, 12 % slower forward
// and 3 % slower backward; the backward at 2 blocks an SM (123 registers,
// no spills) 10 % slower than at 3 (80, with spills).
//
// Bound on the H100 at the training shapes (sem [16, 32, 32, 21] bf16 for
// K1, [16, 32, 32, 17] for K3, [12, 32, 32, 17] for K4, K6, K7 (its teacher
// [12, 32, 32, 16]) and K8; labels [n, 512, 512] int32; K3 also max_seen
// [16, 512, 512] f32): the forward moves 17-34 MB (5-10 us at 3.35 TB/s)
// but computes ~70-90 M upsampled logits, each with a lerp and an
// exponential, so it is bound by operations (instruction issue and the
// SFU's exponentials, ~0.01-0.02 ms), not by device memory; the backward
// adds per pixel and channel a gradient term, two stores to shared memory
// and two adds of the transposed interpolation.  Measured times, and the
// variants that show where the time goes, are in PERF.md.  K7 at its main
// shape: forward 0.114-0.116 ms, backward 0.229-0.232 ms on an NVIDIA H100
// 80GB HBM3 at 700 W (the first port's pair kernels: 0.2998 and 1.2424).
//
// Tolerance against the plain versions (bacs_tpu_torch/ops/upsample_ce.py):
// sums in another order than the einsums, `ex2.approx`; value rtol 2e-3 and
// gradient rtol 5e-2 of the largest gradient, the tolerances the TPU kernels
// hold against their own fallbacks (scripts/check_kernels_tpu.py:96-97).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "upsample_stage.cuh"

namespace {

// Blocks per SM the family's kernels are built for (the register cap):
// the forwards 4; the backwards 3 (about 80 registers, no spills), K3's 4
// (its three normalisers; measured faster so, the others slower).
constexpr int kSumsMinBlocks = 4;

using namespace upsample_stage;

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

// K7's statistics of one pixel of a student/teacher pair (the student in
// chunks of KC channels, the teacher in chunks of KT), the teacher's
// c_old logits staged after the student's c: the teacher's max mo of alpha
// u and exp-sum so (kept in st.so, its exponentials of the first chunk in
// et), then the student's max m, exp-sum s, exp-sum s_G over G = {0} u
// [c_old, c) (in st.s_fg) and sz = sum_{1 <= i < c_old} exp(alpha u_i - mo)
// z_i; e holds the student's last chunk's exponentials.
template <int KC, int KT>
__device__ __forceinline__ Stats pair_stats(const Pixel& px, int c, int old, float alpha,
                                            float (&e)[KC], float (&et)[KT]) {
  Stats st{-INFINITY, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, -INFINITY};
  float mo = -INFINITY;
  for (int c0 = 0; c0 < old; c0 += KT) {
    float v[KT];
#pragma unroll
    for (int k = 0; k < KT; ++k) v[k] = c0 + k < old ? px(c + c0 + k) * alpha : -INFINITY;
    float cm = v[0];
#pragma unroll
    for (int k = 1; k < KT; ++k) cm = fmaxf(cm, v[k]);
    const float m = fmaxf(mo, cm);
    const float mb = m * kLog2e;
    float so = st.so * ex2(mo * kLog2e - mb);
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      et[k] = ex2(fmaf(v[k], kLog2e, -mb));
      so += et[k];
    }
    mo = m;
    st.so = so;
  }
  const float mob = mo * kLog2e;
  // the teacher's exponentials kept in registers where its channels fit one
  // chunk (measured faster than taking them again from the stage), else
  // taken again per channel
  const bool keep = old <= KT;
  st.q0 = keep ? et[0] : ex2(fmaf(px(c) * alpha, kLog2e, -mob));
  for (int c0 = 0; c0 < c; c0 += KC) {
    float v[KC];
    px.chunk(c0, c, v);
    float cm = v[0];
#pragma unroll
    for (int k = 1; k < KC; ++k) cm = fmaxf(cm, v[k]);
    const float m = fmaxf(st.m, cm);
    const float mb = m * kLog2e;
    const float r = ex2(st.m * kLog2e - mb);  // 0 at the first chunk (st.m = -inf)
    float s = st.s * r, s_g = st.s_fg * r, sz = st.sz;
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int ch = c0 + k;
      e[k] = ex2(fmaf(v[k], kLog2e, -mb));
      s += e[k];
      s_g += ch == 0 || ch >= old ? e[k] : 0.f;
      if (ch >= 1 && ch < old) {
        const float q = keep ? et[k < KT ? k : 0] : ex2(fmaf(px(c + ch) * alpha, kLog2e, -mob));
        sz = fmaf(q, v[k], sz);
      }
    }
    st.m = m;
    st.s = s;
    st.s_fg = s_g;
    st.sz = sz;
  }
  st.mo = mo;
  return st;
}

// The gradient of one output pixel, d/dup[ch] times g, from its channel's
// exponential e = exp(up[ch] - m):
//   e * (a + [ch >= 1] a_fg + [ch < old] a_old) - [ch == 0] d0 - [ch == t] dt.
struct PixelGrad {
  float a, a_fg, a_old, d0, dt;
  long long t;
  int old;

  __device__ __forceinline__ float operator()(int ch, float e) const {
    float coef = a;
    if (ch >= 1) coef += a_fg;
    if (ch < old) coef += a_old;
    return coef * e - (ch == 0 ? d0 : 0.f) - (ch == t ? dt : 0.f);
  }
};

// The per-pixel terms (fast logarithms and divisions: a few per pixel,
// well inside the tolerance).  Each has: kGroups (whether it needs s_fg / s_old),
// groups_old() (the old-class count of s_old), counts(t, c) (false where a
// valid pixel adds nothing: K4's zero weights), value(st, t, q) (the
// pixel's two sums; q its flat index in the batch) and grad(st, t, q, g)
// (its gradient coefficients times g); kGradMinBlocks, the backward's
// blocks per SM.

// K1: plain cross-entropy.
struct CeTerm {
  static constexpr int kGradMinBlocks = 3;
  static constexpr bool kGroups = false;
  static constexpr bool kPair = false;
  __device__ __forceinline__ int groups_old() const { return 0; }
  __device__ __forceinline__ bool counts(long long, int) const { return true; }
  __device__ __forceinline__ float2 value(const Stats& st, long long, long long) const {
    return make_float2(st.m + __logf(st.s) - st.picked, 1.f);
  }
  __device__ __forceinline__ PixelGrad grad(const Stats& st, long long t, long long,
                                            float g) const {
    return PixelGrad{__fdividef(g, st.s), 0.f, 0.f, 0.f, g, t, 0};
  }
};

// K4: class-weighted cross-entropy, weights [c] f32.
struct WceTerm {
  static constexpr int kGradMinBlocks = 3;
  static constexpr bool kGroups = false;
  static constexpr bool kPair = false;
  const float* w;

  __device__ __forceinline__ float weight(long long t, int c) const {
    return (t >= 0 && t < c) ? w[t] : 0.f;
  }
  __device__ __forceinline__ int groups_old() const { return 0; }
  __device__ __forceinline__ bool counts(long long t, int c) const {
    return weight(t, c) != 0.f;
  }
  __device__ __forceinline__ float2 value(const Stats& st, long long t, long long) const {
    const float wt = w[t];  // counts() held t in [0, c)
    return make_float2(wt * (st.m + __logf(st.s) - st.picked), wt);
  }
  __device__ __forceinline__ PixelGrad grad(const Stats& st, long long t, long long,
                                            float g) const {
    const float wp = w[t] * g;
    return PixelGrad{__fdividef(wp, st.s), 0.f, 0.f, 0.f, wp, t, 0};
  }
};

// K3: the BACS seen-weighted terms; max_seen [n, H, W] f32, indexed by the
// pixel's flat index in the batch, read once per background pixel.
struct BacsTerm {
  static constexpr int kGradMinBlocks = 4;
  static constexpr bool kGroups = true;
  static constexpr bool kPair = false;
  const float* max_seen;
  int old;
  int ukd;
  float gamma, threshold;

  __device__ __forceinline__ float focal(long long q) const {
    const float ms = max_seen[q];
    return __powf(1.f - (ms > threshold ? 1.f : ms), gamma);
  }
  __device__ __forceinline__ int groups_old() const { return old; }
  __device__ __forceinline__ bool counts(long long, int) const { return true; }
  __device__ __forceinline__ float2 value(const Stats& st, long long t, long long q) const {
    constexpr float eps = 1e-30f;
    const float lse = st.m + __logf(st.s);
    const float l1 = t == 0 ? focal(q) * (lse - st.x0)
                            : lse - (st.m + __logf(st.s_fg + eps));
    float l2 = lse - st.picked;
    if (t < old) l2 = ukd ? lse - (st.m + __logf(st.s_old + eps)) : 0.f;
    return make_float2(l1 + l2, 1.f);
  }
  __device__ __forceinline__ PixelGrad grad(const Stats& st, long long t, long long q,
                                            float g) const {
    constexpr float eps = 1e-30f;
    PixelGrad pg{0.f, 0.f, 0.f, 0.f, 0.f, t, old};
    const float inv_s = __fdividef(1.f, st.s);
    if (t == 0) {  // term 1: fm (p - e0)
      const float fm = focal(q) * g;
      pg.a += fm * inv_s;
      pg.d0 += fm;
    } else {  // term 1: p - s_fg
      pg.a += g * inv_s;
      pg.a_fg -= __fdividef(g, st.s_fg + eps);
    }
    if (t >= old) {  // term 2: p - onehot
      pg.a += g * inv_s;
      pg.dt += g;
    } else if (ukd) {  // term 2: p - s_old
      pg.a += g * inv_s;
      pg.a_old -= __fdividef(g, st.s_old + eps);
    }
    return pg;
  }
};

// K6: MiB's unbiased CE; labels < old score the old classes' mass.
struct UceTerm {
  static constexpr int kGradMinBlocks = 3;
  static constexpr bool kGroups = true;
  static constexpr bool kPair = false;
  int old;

  __device__ __forceinline__ int groups_old() const { return old; }
  __device__ __forceinline__ bool counts(long long, int) const { return true; }
  __device__ __forceinline__ float2 value(const Stats& st, long long t, long long) const {
    constexpr float eps = 1e-30f;
    const float lse = st.m + __logf(st.s);
    const float l = t < old ? lse - (st.m + __logf(st.s_old + eps)) : lse - st.picked;
    return make_float2(l, 1.f);
  }
  __device__ __forceinline__ PixelGrad grad(const Stats& st, long long t, long long,
                                            float g) const {
    constexpr float eps = 1e-30f;
    PixelGrad pg{__fdividef(g, st.s), 0.f, 0.f, 0.f, 0.f, t, old};
    if (t < old) {  // p - s_old
      pg.a_old = -__fdividef(g, st.s_old + eps);
    } else {  // p - onehot
      pg.dt = g;
    }
    return pg;
  }
};

// K7: MiB's unbiased KD of a student/teacher pair; no labels, every pixel
// counts.  The teacher [n, h, w, old] is staged after the student's
// channels; the gradient is g (q0 s_G [ch in G] + q [1 <= ch < old] - p) /
// old, here e (a_g [ch in G] - a) + a_q [1 <= ch < old] exp(alpha u - mo)
// (a = g / (old s), a_g = g q0 / (old (s_G + eps)), a_q = g / (old so)).
struct UkdTerm {
  static constexpr int kGradMinBlocks = 3;
  static constexpr bool kGroups = false;
  static constexpr bool kPair = true;
  const void* sem_old;
  int old;
  float alpha;

  __device__ __forceinline__ int groups_old() const { return old; }
  __device__ __forceinline__ bool counts(long long, int) const { return true; }
  __device__ __forceinline__ float2 value(const Stats& st, long long, long long) const {
    constexpr float eps = 1e-30f;
    const float inv_so = __fdividef(1.f, st.so);
    const float lse = st.m + __logf(st.s), lse_g = st.m + __logf(st.s_fg + eps);
    const float t = st.q0 * inv_so * lse_g + st.sz * inv_so - lse;
    return make_float2(__fdividef(t, (float)old), 1.f);
  }
  __device__ __forceinline__ PixelGrad grad(const Stats& st, long long, long long,
                                            float g) const {
    constexpr float eps = 1e-30f;
    const float go = __fdividef(g, (float)old);
    const float a_q = __fdividef(go, st.so);
    return PixelGrad{__fdividef(go, st.s), __fdividef(a_q * st.q0, st.s_fg + eps), a_q,
                     0.f, 0.f, -1, old};
  }
  // the gradient of channel ch from its exponential e and the teacher's q
  // = exp(alpha u_ch - mo), with pg from grad()
  static __device__ __forceinline__ float pair_grad(const PixelGrad& pg, int ch, float e,
                                                    float q) {
    const float coef = ch == 0 || ch >= pg.old ? pg.a_fg - pg.a : -pg.a;
    return ch >= 1 && ch < pg.old ? fmaf(coef, e, pg.a_old * q) : coef * e;
  }
};

// The floats a staged source column holds: the student's c channels, and
// K7's teacher's after them; odd, so that threads reading neighbouring
// columns meet no bank conflict.
template <typename Term>
__host__ __device__ __forceinline__ int stage_ld(const Term& term, int c) {
  if constexpr (Term::kPair) {
    return (c + term.old) | 1;
  } else {
    return c | 1;
  }
}

// Stages output row (y0, y1, wy)'s source columns [xs0, xs0 + nx) of image
// n: the student's, then K7's teacher's at channel offset c.
template <typename T, typename Term>
__device__ __forceinline__ void stage_pixels(const T* __restrict__ img, const Term& term, int n,
                                             int h, int w, int c, int ldc, int y0, int y1,
                                             float wy, int xs0, int nx,
                                             float* __restrict__ stage) {
  stage_row(img, w, c, ldc, y0, y1, wy, xs0, nx, stage);
  if constexpr (Term::kPair) {
    const T* old_img = (const T*)term.sem_old + (size_t)n * h * w * term.old;
    stage_row(old_img, w, term.old, ldc, y0, y1, wy, xs0, nx, stage + c);
  }
}

// A pixel's statistics: K7's pair, or the labelled terms' softmax.
template <typename Term, int KC, int KT>
__device__ __forceinline__ Stats term_stats(const Term& term, const Pixel& px, int c,
                                            long long t, int old, float (&e)[KC],
                                            float (&et)[KT]) {
  if constexpr (Term::kPair) {
    return pair_stats<KC, KT>(px, c, old, term.alpha, e, et);
  } else {
    return pixel_stats<Term::kGroups>(px, c, t, old, e);
  }
}

// Forward: one block per (band of output rows, image); per-block sums to
// partials[n, band].  A tile is the whole output row where its stage fits
// (launch_sums), so one stage and two barriers per row.
template <typename T, typename L, typename Term, int KC, int KT>
__global__ void __launch_bounds__(kThreads, kSumsMinBlocks)
sums_kernel(const T* __restrict__ sem, const L* __restrict__ labels, int h, int w,
            int c, int H, int W, int ignore_index, Term term, Plan plan,
            float2* __restrict__ partials) {
  extern __shared__ float stage[];  // [span, ldc]
  const int n = blockIdx.y, b = blockIdx.x;
  const int ldc = stage_ld(term, c);
  const T* img = sem + (size_t)n * h * w * c;
  const int old = term.groups_old();
  const int oy_end = min(H, (b + 1) * plan.band);
  float a = 0.f, bs = 0.f;
  for (int oy = b * plan.band; oy < oy_end; ++oy) {
    const long long row = ((long long)n * H + oy) * W;
    for (int ox0 = 0; ox0 < W; ox0 += plan.tile) {
      const int ox1 = min(W, ox0 + plan.tile);
      const int xs0 = plan.xlo[ox0];
      __syncthreads();  // the previous tile is read
      stage_pixels(img, term, n, h, w, c, ldc, plan.ylo[oy], plan.yhi[oy], plan.ywt[oy],
                   xs0, plan.xhi[ox1 - 1] - xs0 + 1, stage);
      __syncthreads();
      for (int ox = ox0 + threadIdx.x; ox < ox1; ox += kThreads) {
        long long t = -1;  // K7 has no labels
        if constexpr (!Term::kPair) {
          t = (long long)labels[row + ox];
          if (t == ignore_index || !term.counts(t, c)) continue;
        }
        const float wx = plan.xwt[ox];
        const Pixel px{stage + (plan.xlo[ox] - xs0) * ldc,
                       stage + (plan.xhi[ox] - xs0) * ldc, 1.f - wx, wx};
        float e[KC], et[KT];
        const Stats st = term_stats<Term, KC, KT>(term, px, c, t, old, e, et);
        const float2 v = term.value(st, t, row + ox);
        a += v.x;
        bs += v.y;
      }
    }
  }
  const float2 r = block_sum2(a, bs);
  if (threadIdx.x == 0) partials[(size_t)n * gridDim.x + b] = r;
}

// Each image's sums over its bands, in band order.
template <typename Term>
__global__ void sums_reduce_kernel(const float2* __restrict__ partials, int blocks,
                                   float* __restrict__ a_out, float* __restrict__ b_out) {
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

// The floats of shared memory the gradient kernel takes: the gradient
// tile times each pixel's two W weights, [tile, KC + 1] x 2 (an odd
// pitch: no bank conflicts), the stage [span, ldc], and where acc_shared
// the band's accumulator [rows, w, c] (ldc: stage_ld).  The wrapper's plan
// (ops/upsample_ce.py:launch_plan) counts the same at KC = 32.
template <int KC>
size_t grad_smem_floats(const Plan& p, int w, int c, int ldc, bool acc_shared) {
  size_t f = (size_t)p.tile * 2 * (KC + 1) + (size_t)p.span * ldc;
  if (acc_shared) f += (size_t)p.rows * w * c;
  return f;
}

// Backward: one block per (band of output rows, image); the band's share
// of dsem, over the source rows it touches, to its slab of partials
// [n, bands, rows, w, c].
template <typename T, typename L, typename Term, int KC, int KT>
__global__ void __launch_bounds__(kThreads, Term::kGradMinBlocks)
grad_bands_kernel(const T* __restrict__ sem, const L* __restrict__ labels, int h, int w,
                  int c, int H, int W, int ignore_index, Term term,
                  const float* __restrict__ g, int g_stride, Plan plan, int acc_shared,
                  float* __restrict__ partials) {
  extern __shared__ float smem[];
  const int n = blockIdx.y, b = blockIdx.x;
  const int ldc = stage_ld(term, c);
  constexpr int kLdd = KC + 1;
  float* dlo = smem;                        // [tile, kLdd]: (1 - wx) g d/dup
  float* dhi = dlo + plan.tile * kLdd;      // [tile, kLdd]: wx g d/dup
  float* stage = dhi + plan.tile * kLdd;    // [span, ldc]
  const size_t slab_len = (size_t)plan.rows * w * c;
  float* slab = partials + ((size_t)n * gridDim.x + b) * slab_len;
  float* acc = acc_shared ? stage + plan.span * ldc : slab;
  for (size_t i = threadIdx.x; i < slab_len; i += kThreads) acc[i] = 0.f;
  const T* img = sem + (size_t)n * h * w * c;
  const float gv = g[(size_t)n * g_stride];  // stride 0: one scalar
  const int old = term.groups_old();
  const int yb = plan.band_y0[b];
  const int oy_end = min(H, (b + 1) * plan.band);
  for (int oy = b * plan.band; oy < oy_end; ++oy) {
    const long long row = ((long long)n * H + oy) * W;
    const int y0 = plan.ylo[oy], y1 = plan.yhi[oy];
    const float wy = plan.ywt[oy];
    // the H weights of the row's two source rows: interp_matrix's entries
    // (one entry, (1 - wy) + wy, at the clamped edge)
    const float wy_a = y0 == y1 ? (1.f - wy) + wy : 1.f - wy;
    float* acc_a = acc + (size_t)(y0 - yb) * w * c;
    float* acc_b = acc + (size_t)(y1 - yb) * w * c;
    for (int ox0 = 0; ox0 < W; ox0 += plan.tile) {
      const int ox1 = min(W, ox0 + plan.tile);
      const int xs0 = plan.xlo[ox0];
      const int nx = plan.xhi[ox1 - 1] - xs0 + 1;
      // the previous tile's reduction ended in a barrier
      stage_pixels(img, term, n, h, w, c, ldc, y0, y1, wy, xs0, nx, stage);
      __syncthreads();
      const int p = threadIdx.x, ox = ox0 + p;
      Pixel px{stage, stage, 0.f, 0.f};
      float wa = 0.f, wb = 0.f;
      PixelGrad pg{0.f, 0.f, 0.f, 0.f, 0.f, -1, 0};
      Stats st{};
      float e[KC], et[KT];
      bool live = false;
      if (ox < ox1) {
        const float wx = plan.xwt[ox];
        px = Pixel{stage + (plan.xlo[ox] - xs0) * ldc, stage + (plan.xhi[ox] - xs0) * ldc,
                   1.f - wx, wx};
        wa = 1.f - wx;
        wb = wx;
        long long t = -1;  // K7 has no labels: every pixel is live
        if constexpr (!Term::kPair) t = (long long)labels[row + ox];
        if (Term::kPair || (t != ignore_index && term.counts(t, c))) {
          st = term_stats<Term, KC, KT>(term, px, c, t, old, e, et);
          pg = term.grad(st, t, row + ox, gv);
          live = true;
        }
      }
      for (int c0 = 0; c0 < c; c0 += KC) {
        const int cc = min(KC, c - c0);
        if (ox < ox1) {
          if (live && c > KC) {  // this chunk's exponentials again
            float v[KC];
            px.chunk(c0, c, v);
            const float mb = st.m * kLog2e;
#pragma unroll
            for (int k = 0; k < KC; ++k) e[k] = ex2(fmaf(v[k], kLog2e, -mb));
          }
#pragma unroll
          for (int k = 0; k < KC; ++k) {
            if (k < cc) {
              float d;
              if constexpr (Term::kPair) {  // the teacher's exp(alpha u - mo)
                const int ch = c0 + k;
                float q = 0.f;
                if (live && ch >= 1 && ch < old) {
                  q = old <= KT
                          ? et[k < KT ? k : 0]
                          : ex2(fmaf(px(c + ch) * term.alpha, kLog2e, -st.mo * kLog2e));
                }
                d = live ? Term::pair_grad(pg, ch, e[k], q) : 0.f;
              } else {
                d = live ? pg(c0 + k, e[k]) : 0.f;
              }
              dlo[p * kLdd + k] = wa * d;
              dhi[p * kLdd + k] = wb * d;
            }
          }
        }
        __syncthreads();
        // the transposed interpolation of the tile: per (source column,
        // channel), the sum over its output columns in this tile, then
        // into the band's two source rows; item i = xi cc + k, stepped by
        // kThreads without a division per item
        int xi = threadIdx.x / cc, k = threadIdx.x - xi * cc;
        const int dxi = kThreads / cc, dk = kThreads - dxi * cc;
        for (; xi < nx; xi += dxi, k += dk) {
          if (k >= cc) {
            k -= cc;
            ++xi;
            if (xi >= nx) break;
          }
          const int x = xs0 + xi;
          float s = 0.f;
          const int la = max(plan.xlo_first[x], ox0) - ox0;
          const int lb = min(plan.xlo_last[x], ox1 - 1) - ox0;
#pragma unroll 4
          for (int q = la; q <= lb; ++q) s += dlo[q * kLdd + k];
          const int ha = max(plan.xhi_first[x], ox0) - ox0;
          const int hb = min(plan.xhi_last[x], ox1 - 1) - ox0;
#pragma unroll 4
          for (int q = ha; q <= hb; ++q) s += dhi[q * kLdd + k];
          const size_t off = (size_t)x * c + c0 + k;
          acc_a[off] += wy_a * s;
          if (y1 != y0) acc_b[off] += wy * s;
        }
        __syncthreads();
      }
    }
  }
  if (acc_shared) {
    for (size_t i = threadIdx.x; i < slab_len; i += kThreads) slab[i] = acc[i];
  }
}

// dsem[n, y] = the sum, in band order, of the slabs of the bands that
// touch source row y (grid = (w c / kThreads, h, n)).
template <typename T, typename Term>
__global__ void band_sum_kernel(const float* __restrict__ partials, int h, int w, int c,
                                Plan plan, T* __restrict__ dsem) {
  const int wc = w * c;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= wc) return;
  const int y = blockIdx.y, n = blockIdx.z;
  const size_t slab_len = (size_t)plan.rows * wc;
  float s = 0.f;
  for (int b = plan.band_first[y]; b <= plan.band_last[y]; ++b) {
    s += partials[((size_t)n * plan.nb + b) * slab_len + (size_t)(y - plan.band_y0[b]) * wc + i];
  }
  store(dsem + ((size_t)n * h + y) * wc + i, s);
}

// The arguments every entry point shares.
struct Problem {
  const void* sem;
  int sem_is_bf16;
  const void* labels;
  int labels_are_i64;
  int n, h, w, c, H, W, ignore_index;
  Plan plan;
};

Problem make_problem(const void* sem, int sem_is_bf16, const void* labels,
                     int labels_are_i64, int n, int h, int w, int c, int H, int W,
                     int ignore_index, const void* tables, int band, int tile, int span,
                     int rows) {
  return Problem{sem, sem_is_bf16, labels, labels_are_i64, n, h, w, c, H, W,
                 ignore_index, make_plan(tables, h, w, H, W, band, tile, span, rows)};
}

template <typename T, typename L, typename Term, int KC, int KT>
int launch_sums(const Problem& pr, Term term, void* partials, void* a_out, void* b_out,
                cudaStream_t st) {
  const int ldc = stage_ld(term, pr.c);
  const Plan pl = whole_rows(pr.plan, pr.w, pr.W, ldc);
  const size_t smem = (size_t)pl.span * ldc * sizeof(float);
  if (pl.tile < 1 || smem > kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(sums_kernel<T, L, Term, KC, KT>, smem);
  if (err != cudaSuccess) return (int)err;
  sums_kernel<T, L, Term, KC, KT><<<dim3(pl.nb, pr.n), kThreads, smem, st>>>(
      (const T*)pr.sem, (const L*)pr.labels, pr.h, pr.w, pr.c, pr.H, pr.W,
      pr.ignore_index, term, pl, (float2*)partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sums_reduce_kernel<Term><<<pr.n, kThreads, 0, st>>>((const float2*)partials, pl.nb,
                                                      (float*)a_out, (float*)b_out);
  return (int)cudaGetLastError();
}

template <typename T, typename L, typename Term, int KC, int KT>
int launch_grad(const Problem& pr, Term term, const void* g, int g_stride, void* partials,
                void* dsem, cudaStream_t st) {
  const Plan& pl = pr.plan;
  const int ldc = stage_ld(term, pr.c);
  const bool acc_shared =
      grad_smem_floats<KC>(pl, pr.w, pr.c, ldc, true) * sizeof(float) <= kSmemMax;
  const size_t smem =
      grad_smem_floats<KC>(pl, pr.w, pr.c, ldc, acc_shared) * sizeof(float);
  if (pl.tile < 1 || pl.tile > kThreads || smem > kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(grad_bands_kernel<T, L, Term, KC, KT>, smem);
  if (err != cudaSuccess) return (int)err;
  grad_bands_kernel<T, L, Term, KC, KT><<<dim3(pl.nb, pr.n), kThreads, smem, st>>>(
      (const T*)pr.sem, (const L*)pr.labels, pr.h, pr.w, pr.c, pr.H, pr.W,
      pr.ignore_index, term, (const float*)g, g_stride, pl, (int)acc_shared,
      (float*)partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int wc = pr.w * pr.c;
  band_sum_kernel<T, Term><<<dim3((wc + kThreads - 1) / kThreads, pr.h, pr.n), kThreads, 0,
                             st>>>((const float*)partials, pr.h, pr.w, pr.c, pl, (T*)dsem);
  return (int)cudaGetLastError();
}

template <typename Term, int KC, int KT = KC>
int sums_at(const Problem& pr, Term term, void* partials, void* a_out, void* b_out,
            cudaStream_t st) {
  if constexpr (Term::kPair) {  // no labels
    return pr.sem_is_bf16
        ? launch_sums<__nv_bfloat16, int32_t, Term, KC, KT>(pr, term, partials, a_out, b_out, st)
        : launch_sums<float, int32_t, Term, KC, KT>(pr, term, partials, a_out, b_out, st);
  }
  if (pr.sem_is_bf16) {
    return pr.labels_are_i64
        ? launch_sums<__nv_bfloat16, int64_t, Term, KC, KT>(pr, term, partials, a_out, b_out, st)
        : launch_sums<__nv_bfloat16, int32_t, Term, KC, KT>(pr, term, partials, a_out, b_out, st);
  }
  return pr.labels_are_i64
      ? launch_sums<float, int64_t, Term, KC, KT>(pr, term, partials, a_out, b_out, st)
      : launch_sums<float, int32_t, Term, KC, KT>(pr, term, partials, a_out, b_out, st);
}

template <typename Term, int KC, int KT = KC>
int grad_at(const Problem& pr, Term term, const void* g, int g_stride, void* partials,
            void* dsem, cudaStream_t st) {
  if constexpr (Term::kPair) {  // no labels
    return pr.sem_is_bf16
        ? launch_grad<__nv_bfloat16, int32_t, Term, KC, KT>(pr, term, g, g_stride, partials, dsem, st)
        : launch_grad<float, int32_t, Term, KC, KT>(pr, term, g, g_stride, partials, dsem, st);
  }
  if (pr.sem_is_bf16) {
    return pr.labels_are_i64
        ? launch_grad<__nv_bfloat16, int64_t, Term, KC, KT>(pr, term, g, g_stride, partials, dsem, st)
        : launch_grad<__nv_bfloat16, int32_t, Term, KC, KT>(pr, term, g, g_stride, partials, dsem, st);
  }
  return pr.labels_are_i64
      ? launch_grad<float, int64_t, Term, KC, KT>(pr, term, g, g_stride, partials, dsem, st)
      : launch_grad<float, int32_t, Term, KC, KT>(pr, term, g, g_stride, partials, dsem, st);
}

// The chunk width KC of the register arrays, by the channel count: 16, 24
// (the main path's 17 and 21 channels) or 32 (chunks of 32 past it).
template <typename Term>
int sums(const Problem& pr, Term term, void* partials, void* a_out, void* b_out,
         void* stream) {
  if ((long long)pr.n * pr.H * pr.W == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if constexpr (Term::kPair) {  // K7's teacher in chunks of 16 where it fits one
    if (term.old <= 16) {
      if (pr.c <= 16) return sums_at<Term, 16, 16>(pr, term, partials, a_out, b_out, st);
      if (pr.c <= 24) return sums_at<Term, 24, 16>(pr, term, partials, a_out, b_out, st);
      return sums_at<Term, 32, 16>(pr, term, partials, a_out, b_out, st);
    }
  }
  if (pr.c <= 16) return sums_at<Term, 16>(pr, term, partials, a_out, b_out, st);
  if (pr.c <= 24) return sums_at<Term, 24>(pr, term, partials, a_out, b_out, st);
  return sums_at<Term, 32>(pr, term, partials, a_out, b_out, st);
}

// g_stride 0: g is one scalar; 1: g holds one value per image (K8).
template <typename Term>
int grad(const Problem& pr, Term term, const void* g, void* partials, void* dsem,
         void* stream, int g_stride = 0) {
  if ((long long)pr.n * pr.h * pr.w * pr.c == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if constexpr (Term::kPair) {  // K7's teacher in chunks of 16 where it fits one
    if (term.old <= 16) {
      if (pr.c <= 16) return grad_at<Term, 16, 16>(pr, term, g, g_stride, partials, dsem, st);
      if (pr.c <= 24) return grad_at<Term, 24, 16>(pr, term, g, g_stride, partials, dsem, st);
      return grad_at<Term, 32, 16>(pr, term, g, g_stride, partials, dsem, st);
    }
  }
  if (pr.c <= 16) return grad_at<Term, 16>(pr, term, g, g_stride, partials, dsem, st);
  if (pr.c <= 24) return grad_at<Term, 24>(pr, term, g, g_stride, partials, dsem, st);
  return grad_at<Term, 32>(pr, term, g, g_stride, partials, dsem, st);
}

}  // namespace

// Common arguments: sem [n, h, w, c] contiguous, f32 (sem_is_bf16 == 0) or
// bf16; labels [n, H, W] contiguous int32 (labels_are_i64 == 0) or int64;
// tables, band, tile, span, rows: the launch plan of
// ops/upsample_ce.py:launch_plan (the int32 tap tables on the device, see
// Plan).  Sums: partials f32 scratch of [n, bands, 2]; a_out, b_out f32
// [n].  Gradients: g f32 device scalar; partials f32 scratch of [n,
// bands, rows, w, c]; dsem [n, h, w, c] in sem's type.  Each makes two
// launches and returns the first nonzero cudaGetLastError() (or
// cudaErrorInvalidValue for a plan whose shared memory does not fit).
#define PROBLEM                                                                  \
  make_problem(sem, sem_is_bf16, labels, labels_are_i64, n, h, w, c, H, W,      \
               ignore_index, tables, band, tile, span, rows)
