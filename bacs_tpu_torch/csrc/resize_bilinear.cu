// Bilinear resize of NHWC tensors, forward and backward, with no atomics:
// the port's ops/interpolate.py:resize_bilinear on the card.
//
// Replaces no TPU kernel: JAX resizes with jax.image.resize, which XLA
// contracts with weight matrices (bacs_tpu/ops/interpolate.py:30-54).  The
// port ran F.interpolate, whose CUDA backward accumulates with float
// atomics in an order that changes from run to run, so two runs of one seed
// on the card differed.  It lies on the full-resolution logits
// (models/base.py), the detector's x16 upsample with aligned corners
// (models/bg_detector.py), every UNet decoder stage (models/unet.py) and
// BACS's teacher distillation (methods/bacs.py).
//
// Semantics are F.interpolate's (mode "bilinear"): per output row oy the
// source row s = (oy + 0.5) * h / H - 0.5 clamped at 0 (half-pixel
// centres) or s = oy * (h - 1) / (H - 1) (aligned corners), taps i0 =
// floor(s) and i1 = min(i0 + 1, h - 1), weights 1 - (s - i0) and s - i0;
// the same per column.  The wrapper computes these tables once per (h, H,
// mode) in f32 as PyTorch does and keeps them on the card.
//
// Forward: one thread per 4 channels of an output pixel (16-byte f32 or
// 8-byte bf16 accesses where C % 4 == 0 and the pointers are aligned; else
// one channel), channels fastest (coalesced), 32-bit index arithmetic (the
// first design, one thread an element with 64-bit divisions, took 0.951 ms
// at the distillation's chunk, 5.9x the bound, H100, chip_smoke.py [45]),
// out = ly0 (lx0 x[i0, j0] + lx1 x[i0, j1]) + ly1 (lx0 x[i1, j0] + lx1
// x[i1, j1]) in f32, rounded to the output's type.
//
// Backward, in gather form and separable, two passes, each a fixed-order
// sum: (A) for each output row, input column and channel, the columns'
// weighted cotangents, t[n, oy, ix, c] = sum over the output columns ox
// that tap ix (in order of ox, the first tap before the second) of w * g;
// t is f32 [n, H, w, C] scratch; (B) for each input element the rows'
// weighted t, the same way.  The lists of (output index, weight) per input
// index are the tables' transpose (CSR, built by the wrapper).  Every sum
// runs in one thread in one order, so two launches give the same bits.
//
// Bound on the H100, at BACS's teacher distillation, [2, 32, 32, 256] f32
// -> [2, 512, 512, 256] (a chunk; 16 images a step): device-memory bytes.
// Forward 2.1 MB read + 536.9 MB written, 0.161 ms at 3.35 TB/s; backward
// 536.9 MB read + 2.1 MB written, 0.161 ms (pass A's scratch, 33.6 MB, is
// the kernel's own).  The work per element (4 multiply-adds forward, 2
// backward per tap) is far below the f32 rate.  chip_smoke.py computes each
// run's bounds from its shapes.  Tolerance against F.interpolate on the
// card: forward rtol 1e-6, gradient rtol 1e-5 (other summation order).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRowBlocks = 65535;

// V consecutive channels of one pixel: one 16-byte (f32) or 8-byte (bf16)
// access where V = 4, else one element
template <int V>
__device__ __forceinline__ void load_v(const float* p, long long i, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p + i);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = p[i];
  }
}
template <int V>
__device__ __forceinline__ void load_v(const __nv_bfloat16* p, long long i, float (&v)[V]) {
  if constexpr (V == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p + i);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
    v[0] = __bfloat162float(p[i]);
  }
}
template <int V>
__device__ __forceinline__ void store_v(float* p, long long i, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p + i) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[i] = v[0];
  }
}
template <int V>
__device__ __forceinline__ void store_v(__nv_bfloat16* p, long long i, const float (&v)[V]) {
  if constexpr (V == 4) {
    uint2 t;
    *reinterpret_cast<__nv_bfloat162*>(&t.x) = __floats2bfloat162_rn(v[0], v[1]);
    *reinterpret_cast<__nv_bfloat162*>(&t.y) = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p + i) = t;
  } else {
    p[i] = __float2bfloat16_rn(v[0]);
  }
}

// x [n, h, w, C] -> out [n, H, W, C]; a thread takes V channels of one
// output pixel; grid (chunks of a row's W * C / V groups, rows n * H).
// ytab/xtab: int32 [2, H] / [2, W] (i0, i1); ylam/xlam: f32 [2, H] / [2, W].
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) resize_fwd_kernel(
    const T* __restrict__ x, int h, int w, int C, int H, int W, int rows,
    const int* __restrict__ ytab, const float* __restrict__ ylam,
    const int* __restrict__ xtab, const float* __restrict__ xlam, T* __restrict__ out) {
  const int groups = C / V;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= W * groups) return;
  const int ox = e / groups;
  const int c = (e - ox * groups) * V;
  const int j0 = xtab[ox], j1 = xtab[W + ox];
  const float lx0 = xlam[ox], lx1 = xlam[W + ox];
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const int n = r / H;
    const int oy = r - n * H;
    const int i0 = ytab[oy], i1 = ytab[H + oy];
    const float ly0 = ylam[oy], ly1 = ylam[H + oy];
    const long long b0 = ((long long)n * h + i0) * w, b1 = ((long long)n * h + i1) * w;
    float a[V], b[V], cc[V], d[V], o[V];
    load_v<V>(x, (b0 + j0) * C + c, a);
    load_v<V>(x, (b0 + j1) * C + c, b);
    load_v<V>(x, (b1 + j0) * C + c, cc);
    load_v<V>(x, (b1 + j1) * C + c, d);
#pragma unroll
    for (int v = 0; v < V; ++v)
      o[v] = ly0 * (lx0 * a[v] + lx1 * b[v]) + ly1 * (lx0 * cc[v] + lx1 * d[v]);
    store_v<V>(out, ((long long)r * W + ox) * C + c, o);
  }
}

// Pass A: t[n, oy, ix, c] = sum_k xw[k] g[n, oy, xsrc[k], c] over k in
// [xoff[ix], xoff[ix + 1]); grid (chunks of w * C / V, rows n * H).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) resize_grad_cols_kernel(
    const T* __restrict__ g, int w, int C, int W, int rows,
    const int* __restrict__ xoff, const int* __restrict__ xsrc, const float* __restrict__ xw,
    float* __restrict__ t) {
  const int groups = C / V;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= w * groups) return;
  const int ix = e / groups;
  const int c = (e - ix * groups) * V;
  const int k0 = xoff[ix], k1 = xoff[ix + 1];
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const long long base = (long long)r * W;
    float acc[V] = {}, gv[V];
    for (int k = k0; k < k1; ++k) {
      const float wk = xw[k];
      load_v<V>(g, (base + xsrc[k]) * C + c, gv);
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] += wk * gv[v];
    }
    store_v<V>(t, ((long long)r * w + ix) * C + c, acc);
  }
}

// Pass B: dx[n, iy, ix, c] = sum_k yw[k] t[n, ysrc[k], ix, c] over k in
// [yoff[iy], yoff[iy + 1]); grid (chunks of w * C / V, rows n * h).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) resize_grad_rows_kernel(
    const float* __restrict__ t, int h, int w, int C, int H, int rows,
    const int* __restrict__ yoff, const int* __restrict__ ysrc, const float* __restrict__ yw,
    T* __restrict__ dx) {
  const int groups = C / V;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= w * groups) return;
  const long long row_len = (long long)w * C;
  const int c0 = e * V;  // the group's offset within a row (ix * C + c)
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const int n = r / h;
    const int iy = r - n * h;
    const long long base = (long long)n * H;
    float acc[V] = {}, tv[V];
    for (int k = yoff[iy]; k < yoff[iy + 1]; ++k) {
      const float wk = yw[k];
      load_v<V>(t, (base + ysrc[k]) * row_len + c0, tv);
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] += wk * tv[v];
    }
    store_v<V>(dx, (long long)r * row_len + c0, acc);
  }
}

dim3 grid_of(int groups_per_row, int rows) {
  return dim3((unsigned)((groups_per_row + kThreads - 1) / kThreads),
              (unsigned)(rows < kMaxRowBlocks ? rows : kMaxRowBlocks));
}

template <typename T, int V>
int launch_fwd(const void* x, int n, int h, int w, int C, int H, int W, const void* ytab,
               const void* ylam, const void* xtab, const void* xlam, void* out,
               cudaStream_t st) {
  const int rows = n * H;
  resize_fwd_kernel<T, V><<<grid_of(W * (C / V), rows), kThreads, 0, st>>>(
      (const T*)x, h, w, C, H, W, rows, (const int*)ytab, (const float*)ylam,
      (const int*)xtab, (const float*)xlam, (T*)out);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_grad(const void* g, int n, int h, int w, int C, int H, int W, const void* yoff,
                const void* ysrc, const void* yw, const void* xoff, const void* xsrc,
                const void* xw, void* t, void* dx, cudaStream_t st) {
  const int groups = w * (C / V);
  resize_grad_cols_kernel<T, V><<<grid_of(groups, n * H), kThreads, 0, st>>>(
      (const T*)g, w, C, W, n * H, (const int*)xoff, (const int*)xsrc, (const float*)xw,
      (float*)t);
  const int code = (int)cudaGetLastError();
  if (code) return code;
  resize_grad_rows_kernel<T, V><<<grid_of(groups, n * h), kThreads, 0, st>>>(
      (const float*)t, h, w, C, H, n * h, (const int*)yoff, (const int*)ysrc,
      (const float*)yw, (T*)dx);
  return (int)cudaGetLastError();
}

bool wide(int C, const void* a, const void* b) {
  auto ok = [](const void* p) { return ((unsigned long long)p & 15ull) == 0; };
  return C % 4 == 0 && ok(a) && ok(b);
}

}  // namespace

// x: [n, h, w, C] contiguous, f32 (is_bf16 == 0) or bf16; out: [n, H, W,
// C] in x's type; tables as above.  Returns cudaGetLastError().
extern "C" int resize_bilinear_fwd(const void* x, int is_bf16, int n, int h, int w, int C,
                                   int H, int W, const void* ytab, const void* ylam,
                                   const void* xtab, const void* xlam, void* out,
                                   void* stream) {
  if ((long long)n * H * W * C == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const bool v4 = wide(C, x, out);
  if (is_bf16)
    return v4 ? launch_fwd<__nv_bfloat16, 4>(x, n, h, w, C, H, W, ytab, ylam, xtab, xlam, out, st)
              : launch_fwd<__nv_bfloat16, 1>(x, n, h, w, C, H, W, ytab, ylam, xtab, xlam, out, st);
  return v4 ? launch_fwd<float, 4>(x, n, h, w, C, H, W, ytab, ylam, xtab, xlam, out, st)
            : launch_fwd<float, 1>(x, n, h, w, C, H, W, ytab, ylam, xtab, xlam, out, st);
}

// g: [n, H, W, C] contiguous cotangent; dx: [n, h, w, C] in g's type; t:
// f32 [n, H, w, C] scratch; yoff/xoff: int32 [h + 1] / [w + 1]; ysrc/xsrc
// int32 and yw/xw f32 of their last offset's length.  Two launches on
// `stream`.  Returns cudaGetLastError().
extern "C" int resize_bilinear_grad(const void* g, int is_bf16, int n, int h, int w, int C,
                                    int H, int W, const void* yoff, const void* ysrc,
                                    const void* yw, const void* xoff, const void* xsrc,
                                    const void* xw, void* t, void* dx, void* stream) {
  if ((long long)n * h * w * C == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  // one channel a thread: each thread's sum is a serial chain of loads, so
  // the passes want the most threads in flight (4 channels a thread took
  // 0.361 ms against 0.283 at the distillation's chunk, H100, [45])
  if (is_bf16)
    return launch_grad<__nv_bfloat16, 1>(g, n, h, w, C, H, W, yoff, ysrc, yw, xoff, xsrc, xw,
                                         t, dx, st);
  return launch_grad<float, 1>(g, n, h, w, C, H, W, yoff, ysrc, yw, xoff, xsrc, xw, t, dx, st);
}
