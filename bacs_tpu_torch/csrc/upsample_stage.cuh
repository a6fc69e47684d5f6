// The staged layout of the upsample kernels (K1-K4, K6-K10): the
// host-built launch plan, the stage of one output row's H-lerped source
// columns in shared memory (of two rows at once, `stage_two_rows`), a
// pixel's view of it, the chunked softmax statistics, the argmax-only scan
// (`argmax_scan2`, K2's), and the per-pixel template `pixel_kernel` (K9,
// K10).
//
// A block takes one image and a band of output rows (grid = (bands, N),
// bands from ops/upsample_ce.py:launch_plan).  For each output row it
// stages, as f32, the source columns a tile of output pixels reads, lerped
// along H (`stage_row`: the plain version's first einsum); one thread per
// output pixel then lerps its channels along W from the stage (`Pixel`)
// into registers, in chunks of KC (16, 24 or 32 by c, a template
// parameter), takes the chunk's max first (branch-free) and then its
// exponentials, `ex2.approx` after one FFMA, with one rescale per chunk
// past the first (`fold_chunk`).  The forward-sums and backward-gather
// templates of the loss family are in upsample_ce.cu; `pixel_kernel` below
// writes per-pixel outputs through a functor (ArgmaxConfTerm in
// upsample_argmax.cu, PseudoTerm in upsample_pseudo.cu); K2's kernel, which
// needs the argmax alone, is in upsample_confusion.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace upsample_stage {

constexpr int kThreads = 256;
constexpr size_t kSmemMax = 232448;  // shared memory a block may use on Hopper
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// 2^x on the special-function unit (MUFU.EX2; 0 for -inf).  exp(v - m) is
// ex2(v log2(e) - m log2(e)), one FFMA and one MUFU.
__device__ __forceinline__ float ex2(float x) {
#ifdef __CUDA_ARCH__
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
#else
  return exp2f(x);
#endif
}

// log2(x) on the special-function unit (MUFU.LG2).
__device__ __forceinline__ float lg2(float x) {
#ifdef __CUDA_ARCH__
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
#else
  return log2f(x);
#endif
}

// 1 / x on the special-function unit (MUFU.RCP).
__device__ __forceinline__ float rcp(float x) {
#ifdef __CUDA_ARCH__
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
#else
  return 1.f / x;
#endif
}

// The host-built tap tables (ops/upsample_ce.py:launch_plan), one int32
// buffer in this order: the W axis (lo, hi, wt [W]; lo_first, lo_last,
// hi_first, hi_last [w]: the output columns whose lo / hi is the source
// column, with a nonzero weight, first > last where none), the H axis (lo,
// hi, wt [H]), the bands (band_y0 [bands]: the first source row a band
// touches; band_first, band_last [h]: the bands that touch a source row).
struct Plan {
  const int *xlo, *xhi, *xlo_first, *xlo_last, *xhi_first, *xhi_last;
  const int *ylo, *yhi, *band_y0, *band_first, *band_last;
  const float *xwt, *ywt;
  int band;   // output rows per band
  int tile;   // output pixels per tile (<= kThreads, one a thread)
  int span;   // the most source columns a tile reads
  int rows;   // the most source rows a band touches
  int nb;     // bands
};

inline Plan make_plan(const void* tables, int h, int w, int H, int W, int band, int tile,
                      int span, int rows) {
  Plan p;
  const int* q = (const int*)tables;
  p.xlo = q; q += W;
  p.xhi = q; q += W;
  p.xwt = (const float*)q; q += W;
  p.xlo_first = q; q += w;
  p.xlo_last = q; q += w;
  p.xhi_first = q; q += w;
  p.xhi_last = q; q += w;
  p.ylo = q; q += H;
  p.yhi = q; q += H;
  p.ywt = (const float*)q; q += H;
  p.nb = (H + band - 1) / band;
  p.band_y0 = q; q += p.nb;
  p.band_first = q; q += h;
  p.band_last = q;
  p.band = band;
  p.tile = tile;
  p.span = span;
  p.rows = rows;
  return p;
}

// A forward's tiles: the whole output row where its stage (w source
// columns of ldc floats) fits the default 48 KB, so one stage and two
// barriers per row; else the plan's tiles.
inline Plan whole_rows(Plan p, int w, int W, int ldc) {
  if ((size_t)w * ldc * sizeof(float) <= 48 * 1024) {
    p.tile = W;
    p.span = w;
  }
  return p;
}

// Asks for `bytes` of dynamic shared memory where that is above the 48 KB
// default.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Stages the source columns [xs0, xs0 + nx) of output row (y0, y1, wy),
// lerped along H in f32: stage[xi * ldc + ch].  Every thread calls it.
template <typename T>
__device__ __forceinline__ void stage_row(const T* __restrict__ img, int w, int c,
                                          int ldc, int y0, int y1, float wy, int xs0,
                                          int nx, float* __restrict__ stage) {
  const T* r0 = img + ((size_t)y0 * w + xs0) * c;
  const T* r1 = img + ((size_t)y1 * w + xs0) * c;
  const float wy0 = 1.f - wy;
  const int total = nx * c;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int xi = i / c;
    stage[xi * ldc + (i - xi * c)] = wy0 * to_f32(r0[i]) + wy * to_f32(r1[i]);
  }
}

// stage_row for two output rows in one pass (stage_a, stage_b), the
// source rows read once where the two rows share them (ya == yb).
template <typename T>
__device__ __forceinline__ void stage_two_rows(const T* __restrict__ img, int w, int c,
                                               int ldc, int2 ya, float wa, int2 yb, float wb,
                                               int xs0, int nx, float* __restrict__ stage_a,
                                               float* __restrict__ stage_b) {
  const T* a0 = img + ((size_t)ya.x * w + xs0) * c;
  const T* a1 = img + ((size_t)ya.y * w + xs0) * c;
  const T* b0 = img + ((size_t)yb.x * w + xs0) * c;
  const T* b1 = img + ((size_t)yb.y * w + xs0) * c;
  const bool same = ya.x == yb.x && ya.y == yb.y;
  const float wa0 = 1.f - wa, wb0 = 1.f - wb;
  const int total = nx * c;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int xi = i / c;
    const int o = xi * ldc + (i - xi * c);
    const float r0 = to_f32(a0[i]), r1 = to_f32(a1[i]);
    const float q0 = same ? r0 : to_f32(b0[i]), q1 = same ? r1 : to_f32(b1[i]);
    stage_a[o] = wa0 * r0 + wa * r1;
    stage_b[o] = wb0 * q0 + wb * q1;
  }
}

// One output pixel's view of the stage: its two source columns and their
// W weights.
struct Pixel {
  const float *ra, *rb;
  float wa, wb;

  __device__ __forceinline__ float operator()(int ch) const {
    return wa * ra[ch] + wb * rb[ch];
  }
  // the logits of channels [c0, c0 + KC), -inf past c
  template <int KC>
  __device__ __forceinline__ void chunk(int c0, int c, float (&v)[KC]) const {
#pragma unroll
    for (int k = 0; k < KC; ++k) v[k] = c0 + k < c ? (*this)(c0 + k) : -INFINITY;
  }
};

// A pixel's softmax statistics: max m, exp-sum s relative to m, and where
// the term asks (kGroups) the exp-sums over channels >= 1 (s_fg) and < old
// (s_old); the logit of label t (0 where t is outside [0, c)) and of
// channel 0.
struct Stats {
  float m, s, s_fg, s_old, picked, x0;
  float q0, so, sz, mo;  // K7's teacher: exp(alpha u_0 - mo), its exp-sum, sum q_i z_i
                         // times so, its max of alpha u
};

template <int KC>
__device__ __forceinline__ float chunk_max(const float (&v)[KC]) {
  float cm = v[0];
#pragma unroll
  for (int k = 1; k < KC; ++k) cm = fmaxf(cm, v[k]);
  return cm;
}

// Folds one chunk of KC logits into st: its max first, one rescale of the
// sums, then the chunk's exponentials e (relative to the new max; 0 past c).
template <bool kGroups, int KC>
__device__ __forceinline__ void fold_chunk(const float (&v)[KC], int c0, int old,
                                           Stats& st, float (&e)[KC]) {
  const float m = fmaxf(st.m, chunk_max(v));
  const float mb = m * kLog2e;
  const float r = ex2(st.m * kLog2e - mb);  // 0 at the first chunk (st.m = -inf)
  float s = st.s * r, s_fg = st.s_fg * r, s_old = st.s_old * r;
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    e[k] = ex2(fmaf(v[k], kLog2e, -mb));
    s += e[k];
    if (kGroups) {
      s_fg += c0 + k >= 1 ? e[k] : 0.f;
      s_old += c0 + k < old ? e[k] : 0.f;
    }
  }
  st.m = m;
  st.s = s;
  st.s_fg = s_fg;
  st.s_old = s_old;
}

// The statistics of one pixel over all c channels; e holds the last
// chunk's exponentials (all of them where c <= KC).
template <bool kGroups, int KC>
__device__ __forceinline__ Stats pixel_stats(const Pixel& px, int c, long long t,
                                             int old, float (&e)[KC]) {
  Stats st{-INFINITY, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < c; c0 += KC) {
    float v[KC];
    px.chunk(c0, c, v);
    fold_chunk<kGroups>(v, c0, old, st, e);
  }
  st.picked = (t >= 0 && t < c) ? px((int)t) : 0.f;
  st.x0 = px(0);
  return st;
}

// A pixel's max m, its exp-sum s relative to m, and its argmax: the first
// channel that reaches m, as torch.argmax and jnp.argmax take it.
struct ArgStats {
  float m, s;
  int arg;
};

// The argmax and softmax statistics of one pixel over all c channels, in
// chunks of KC: within a chunk the first k with v[k] == the chunk's max
// (branch-free), across chunks a later one takes over only on a strict >;
// then the chunk's exponentials (fold_chunk).  e holds the last chunk's
// exponentials (all of them where c <= KC).
template <int KC>
__device__ __forceinline__ ArgStats argmax_stats(const Pixel& px, int c, float (&e)[KC]) {
  Stats st{-INFINITY, 0.f, 0.f, 0.f, 0.f, 0.f};
  int arg = 0;
  for (int c0 = 0; c0 < c; c0 += KC) {
    float v[KC];
    px.chunk(c0, c, v);
    const float cm = chunk_max(v);
    int a = 0;
#pragma unroll
    for (int k = KC - 1; k >= 0; --k) a = v[k] == cm ? k : a;
    arg = cm > st.m ? c0 + a : arg;
    fold_chunk<false>(v, c0, 0, st, e);
  }
  return ArgStats{st.m, st.s, arg};
}

// A pixel's view of a stage whose columns hold ldc floats, ldc a multiple
// of KC and 16-byte aligned, the channels past c NaN (no compare selects
// them): its chunks of KC logits by 16-byte shared loads.
struct PixelVec {
  const float4 *ra, *rb;
  float wa, wb;

  template <int KC>
  __device__ __forceinline__ void chunk(int c0, float (&v)[KC]) const {
    static_assert(KC % 4 == 0, "whole 16-byte loads");
#pragma unroll
    for (int q = 0; q < KC / 4; ++q) {
      const float4 a = ra[c0 / 4 + q], b = rb[c0 / 4 + q];
      v[4 * q] = wa * a.x + wb * b.x;
      v[4 * q + 1] = wa * a.y + wb * b.y;
      v[4 * q + 2] = wa * a.z + wb * b.z;
      v[4 * q + 3] = wa * a.w + wb * b.w;
    }
  }
};

// The argmax of a chunk of KC logits, as a tree: (its max, the first k
// that reaches it), a later half taking over only on a strict >.
template <int KC>
__device__ __forceinline__ void chunk_argmax(const float (&v)[KC], float& cm, int& a) {
  float mv[KC];
  int mi[KC];
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    mv[k] = v[k];
    mi[k] = k;
  }
#pragma unroll
  for (int s = 1; s < KC; s *= 2) {
#pragma unroll
    for (int k = 0; k + s < KC; k += 2 * s) {
      mi[k] = mv[k + s] > mv[k] ? mi[k + s] : mi[k];
      mv[k] = fmaxf(mv[k], mv[k + s]);
    }
  }
  cm = mv[0];
  a = mi[0];
}

// The argmax alone of two pixels over all c channels, their chunks of KC
// interleaved (two independent chains): within a chunk its max and the
// first k that reaches it (`chunk_argmax`), across chunks a later one
// taking over only on a strict >, as argmax_stats has it; no exponential.
template <int KC>
__device__ __forceinline__ void argmax_scan2(const PixelVec& pa, const PixelVec& pb, int c,
                                             int& aa, int& ab) {
  float ma = -INFINITY, mb = -INFINITY;
  aa = ab = 0;
  for (int c0 = 0; c0 < c; c0 += KC) {
    float va[KC], vb[KC], ca, cb;
    int ka, kb;
    pa.chunk(c0, va);
    pb.chunk(c0, vb);
    chunk_argmax(va, ca, ka);
    chunk_argmax(vb, cb, kb);
    aa = ca > ma ? c0 + ka : aa;
    ab = cb > mb ? c0 + kb : ab;
    ma = fmaxf(ma, ca);
    mb = fmaxf(mb, cb);
  }
}

// Per-pixel outputs of the bilinear-upsampled logits: one block per (band
// of output rows, image), each output row's H-lerped source columns staged
// (whole rows where they fit, `whole_rows`), one thread per output pixel
// with its argmax and softmax statistics (`argmax_stats`).  The functor
// Term gives what a pixel writes:
//   kLabels: whether the kernel reads a label per pixel (L its type);
//   Acc, start(): a thread's running state (K9's counts);
//   softmax(t, c, q), where kLabels: false where the pixel's label alone
//       decides its output, which it then writes (q the pixel's flat index
//       in the batch);
//   pixel<KC>(px, c, q, st, e, acc): the outputs from the statistics;
//   kMinBlocks: the blocks per SM the kernel is built for;
//   flush(acc, n): every thread at the end (K9's block sums).
template <typename T, typename L, typename Term, int KC>
__global__ void __launch_bounds__(kThreads, Term::kMinBlocks)
pixel_kernel(const T* __restrict__ sem, const L* __restrict__ labels, int h, int w, int c,
             int H, int W, Term term, Plan plan) {
  extern __shared__ float stage[];  // [span, ldc]
  const int n = blockIdx.y, b = blockIdx.x;
  const int ldc = c | 1;  // odd: no bank conflicts between neighbouring columns
  const T* img = sem + (size_t)n * h * w * c;
  typename Term::Acc acc = term.start();
  const int oy_end = min(H, (b + 1) * plan.band);
  for (int oy = b * plan.band; oy < oy_end; ++oy) {
    const long long row = ((long long)n * H + oy) * W;
    for (int ox0 = 0; ox0 < W; ox0 += plan.tile) {
      const int ox1 = min(W, ox0 + plan.tile);
      const int xs0 = plan.xlo[ox0];
      __syncthreads();  // the previous tile is read
      stage_row(img, w, c, ldc, plan.ylo[oy], plan.yhi[oy], plan.ywt[oy], xs0,
                plan.xhi[ox1 - 1] - xs0 + 1, stage);
      __syncthreads();
      for (int ox = ox0 + threadIdx.x; ox < ox1; ox += kThreads) {
        const long long q = row + ox;
        if constexpr (Term::kLabels) {
          if (!term.softmax((long long)labels[q], c, q)) continue;
        }
        const float wx = plan.xwt[ox];
        const Pixel px{stage + (plan.xlo[ox] - xs0) * ldc,
                       stage + (plan.xhi[ox] - xs0) * ldc, 1.f - wx, wx};
        float e[KC];
        const ArgStats st = argmax_stats<KC>(px, c, e);
        term.template pixel<KC>(px, c, q, st, e, acc);
      }
    }
  }
  term.flush(acc, n);
}

template <typename T, typename L, typename Term, int KC>
int launch_pixels_at(const void* sem, const void* labels, int n, int h, int w, int c, int H,
                     int W, Term term, Plan plan, cudaStream_t st) {
  const int ldc = c | 1;
  const Plan pl = whole_rows(plan, w, W, ldc);
  const size_t smem = (size_t)pl.span * ldc * sizeof(float);
  if (pl.tile < 1 || smem > kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(pixel_kernel<T, L, Term, KC>, smem);
  if (err != cudaSuccess) return (int)err;
  pixel_kernel<T, L, Term, KC><<<dim3(pl.nb, n), kThreads, smem, st>>>(
      (const T*)sem, (const L*)labels, h, w, c, H, W, term, pl);
  return (int)cudaGetLastError();
}

// One launch of pixel_kernel, the chunk width KC by the channel count: 16,
// 24 or 32 (chunks of 32 past it), so no work for padding at the main
// path's 16 and 21 channels.  Returns cudaGetLastError() (or
// cudaErrorInvalidValue for a plan whose stage does not fit).
template <typename T, typename L, typename Term>
int launch_pixels(const void* sem, const void* labels, int n, int h, int w, int c, int H,
                  int W, Term term, Plan plan, cudaStream_t st) {
  if ((long long)n * H * W == 0) return 0;
  if (c <= 16) return launch_pixels_at<T, L, Term, 16>(sem, labels, n, h, w, c, H, W, term, plan, st);
  if (c <= 24) return launch_pixels_at<T, L, Term, 24>(sem, labels, n, h, w, c, H, W, term, plan, st);
  return launch_pixels_at<T, L, Term, 32>(sem, labels, n, h, w, c, H, W, term, plan, st);
}

}  // namespace upsample_stage
