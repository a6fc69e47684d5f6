// Fused stem: train-mode ABN apply + leaky-ReLU + 3x3/2 max-pool, forward
// and backward (the ResNet stem after its 7x7/2 convolution).
//
// Replaces the TPU kernels of bacs_tpu/ops/stem_pool.py: the forward
// `_fwd_pallas` (:232, pallas_call at :244, body `_fwd_kernel` :208) and the
// backward `_bwd_pallas` (:338, pallas_call at :355, body `_bwd_kernel` :267).
//
// Forward, per pooled output p[n, t, u, ch] of c [N, H, W, C] (NHWC, H and W
// even): y = leaky(c * a + b) in f32 for the 3x3 window of input rows 2t-1..2t+1
// and columns 2u-1..2u+1 (the padding never wins: every window holds a real
// cell), p = the window's max in c's dtype.  The full-resolution y is never
// written.  `a` and `b` are the folded affine rounded to c's dtype (given as
// f32 values), so the forward and the backward see the same y.
//
// Backward, two launches.  First one thread per window recomputes y from c
// and writes the window's FIRST-max code (scan order ky*3+kx, a cell takes
// over only on a strict >) as one byte, into a scratch the wrapper
// allocates (1/8 of c's bytes in bf16; no code is kept from the forward).
// Then, in gather form, one thread per input cell (n, y, x, ch) visits the at
// most 2 x 2 windows that contain it (an even row 2s belongs to window s, an
// odd row 2s+1 to windows s and s+1; the same for columns) and sums the
// pooled cotangent `dap` of the windows whose code names this cell, in the
// scan order of `_scatter_codes_jnp` (so the f32 sum equals the plain
// version's), then applies the BN backward in the same pass:
//   dc = g * da - g_mean_da - g_mean_da_xhat * (c - mean) * inv.
// No atomics, deterministic sums.  The affine, the leaky and the BN backward
// use explicitly rounded f32 operations (__fmul_rn / __fadd_rn: no fused
// multiply-add), the order of the plain PyTorch version's elementwise ops,
// so both take the same argmax and give the same bits.
//
// Bound on the H100, at the stem of a batch-16 512^2 DeepLabV3 train step,
// c [16, 256, 256, 64] bf16: device-memory bytes.  Forward 134.2 MB read +
// 33.6 MB written, 0.050 ms at 3.35 TB/s; backward 134.2 + 33.6 MB read and
// 134.2 MB written, 0.090 ms.  The work per element (an FMA, a select, nine
// compares per window) is served from L1/L2: each window reads its nine
// cells, so c passes through L1 about 2.25 times per pass, the cost of this
// simple design against its bound; a tile of y in shared memory with a
// one-row halo (each y computed once) is later work.  A first design
// recomputed all of a cell's windows in the gather itself (~20 affine
// evaluations per cell): 1.89 ms at [12, 256, 256, 64] bf16 on an NVIDIA
// H100 80GB HBM3 at 700 W, 28x its bound (PERF.md).
//
// Tolerance against the plain version (ops/stem_pool.py) on the same inputs:
// the same rounded f32 operations in the same order, so values and
// gradients are expected bit-equal in f32 and bf16; the checks hold values
// exact and gradients exact wherever no two candidates of a window lie
// within one bf16 ulp (a value rtol of 2e-3 and gradient rtol of 5e-2 are
// what scripts/check_kernels_tpu.py:247-248 allowed the TPU kernel).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;  // the JAX kernel's padding value

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// leaky(x * a + b), each operation rounded as the plain version's
__device__ __forceinline__ float act(float x, float a, float b, float slope) {
  const float y = __fadd_rn(__fmul_rn(x, a), b);
  return y >= 0.f ? y : __fmul_rn(y, slope);
}

// scan window (t, u) of image `img` (pointer at its channel); returns the
// first-max code ky*3+kx and writes the max
template <typename T>
__device__ __forceinline__ int window_max(const T* img, int H, int W, int C,
                                          int t, int u, float a, float b,
                                          float slope, float* best_out) {
  float best = kNeg;
  int code = 0;
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
    const int y = 2 * t - 1 + ky;
    if (y < 0 || y >= H) continue;
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const int x = 2 * u - 1 + kx;
      if (x < 0 || x >= W) continue;
      const float v = act(load(img + ((size_t)y * W + x) * C), a, b, slope);
      if (v > best) {
        best = v;
        code = ky * 3 + kx;
      }
    }
  }
  *best_out = best;
  return code;
}

template <typename T, typename Idx>
__global__ void stem_pool_fwd_kernel(const T* __restrict__ c,
                                     const float* __restrict__ vec, float slope,
                                     int n, int H, int W, int C,
                                     T* __restrict__ p) {
  const int H2 = H / 2, W2 = W / 2;
  const Idx total = (Idx)n * H2 * W2 * C;
  const Idx i = (Idx)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int ch = (int)(i % C);
  Idx r = i / C;
  const int u = (int)(r % W2);
  r /= W2;
  const int t = (int)(r % H2);
  const int img = (int)(r / H2);
  float best;
  window_max(c + (size_t)img * H * W * C + ch, H, W, C, t, u, vec[ch],
             vec[C + ch], slope, &best);
  store(p + i, best);
}

// the first-max code of every window, one thread per pooled element
template <typename T, typename Idx>
__global__ void stem_pool_codes_kernel(const T* __restrict__ c,
                                       const float* __restrict__ vec,
                                       float slope, int n, int H, int W, int C,
                                       uint8_t* __restrict__ codes) {
  const int H2 = H / 2, W2 = W / 2;
  const Idx total = (Idx)n * H2 * W2 * C;
  const Idx i = (Idx)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int ch = (int)(i % C);
  Idx r = i / C;
  const int u = (int)(r % W2);
  r /= W2;
  const int t = (int)(r % H2);
  const int img = (int)(r / H2);
  float best;
  codes[i] = (uint8_t)window_max(c + (size_t)img * H * W * C + ch, H, W, C, t, u,
                                 vec[ch], vec[C + ch], slope, &best);
}

// vec rows: a, b, g, g_mean_da, g_mean_da_xhat, mean, inv (each [C] f32)
template <typename T, typename Idx>
__global__ void stem_pool_grad_kernel(const T* __restrict__ c,
                                      const T* __restrict__ dap,
                                      const uint8_t* __restrict__ codes,
                                      const float* __restrict__ vec, int n, int H,
                                      int W, int C, T* __restrict__ dc) {
  const int H2 = H / 2, W2 = W / 2;
  const Idx total = (Idx)n * H * W * C;
  const Idx i = (Idx)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int ch = (int)(i % C);
  Idx r = i / C;
  const int x = (int)(r % W);
  r /= W;
  const int y = (int)(r % H);
  const int img = (int)(r / H);
  const size_t win0 = (size_t)img * H2 * W2 * C + ch;
  float da = 0.f;
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
    const int ty = y + 1 - ky;  // 2t = y + 1 - ky for the window holding y at ky
    if (ty < 0 || (ty & 1)) continue;
    const int t = ty >> 1;
    if (t >= H2) continue;
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const int tx = x + 1 - kx;
      if (tx < 0 || (tx & 1)) continue;
      const int u = tx >> 1;
      if (u >= W2) continue;
      const size_t w = win0 + ((size_t)t * W2 + u) * C;
      if (codes[w] == ky * 3 + kx) da = __fadd_rn(da, load(dap + w));
    }
  }
  const float g = vec[2 * C + ch], gmda = vec[3 * C + ch];
  const float gmdax = vec[4 * C + ch], mean = vec[5 * C + ch];
  const float inv = vec[6 * C + ch];
  const float x_hat = __fmul_rn(__fsub_rn(load(c + i), mean), inv);
  store(dc + i, __fsub_rn(__fsub_rn(__fmul_rn(g, da), gmda), __fmul_rn(gmdax, x_hat)));
}

constexpr int kThreads = 256;

unsigned blocks_for(long long total) {
  return (unsigned)((total + kThreads - 1) / kThreads);
}

// Index arithmetic in 32 bits where the element count allows (a 64-bit
// integer division is a long subroutine on the GPU, and each thread makes
// three), in 64 bits beyond.
bool fits_32(long long total) { return total < (1LL << 31); }

template <typename T, typename Idx>
int launch_fwd(const void* c, const void* vec, float slope, int n, int H, int W,
               int C, void* p, cudaStream_t st, long long total) {
  stem_pool_fwd_kernel<T, Idx><<<blocks_for(total), kThreads, 0, st>>>(
      (const T*)c, (const float*)vec, slope, n, H, W, C, (T*)p);
  return (int)cudaGetLastError();
}

template <typename T, typename Idx>
int launch_grad(const void* c, const void* dap, const void* vec, float slope, int n,
                int H, int W, int C, void* codes, void* dc, cudaStream_t st,
                long long wins, long long total) {
  stem_pool_codes_kernel<T, Idx><<<blocks_for(wins), kThreads, 0, st>>>(
      (const T*)c, (const float*)vec, slope, n, H, W, C, (uint8_t*)codes);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  stem_pool_grad_kernel<T, Idx><<<blocks_for(total), kThreads, 0, st>>>(
      (const T*)c, (const T*)dap, (const uint8_t*)codes, (const float*)vec, n, H, W,
      C, (T*)dc);
  return (int)cudaGetLastError();
}

}  // namespace

// c: [n, H, W, C] contiguous, f32 (is_bf16 == 0) or bf16, H and W even;
// vec: f32 [2, C] (a, b); p: [n, H/2, W/2, C] in c's dtype.
// Returns cudaGetLastError().
extern "C" int stem_pool_fwd(const void* c, int is_bf16, const void* vec,
                             float slope, int n, int H, int W, int C, void* p,
                             void* stream) {
  const long long total = (long long)n * (H / 2) * (W / 2) * C;
  if (total == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const bool small = fits_32(total);
  if (is_bf16)
    return small ? launch_fwd<__nv_bfloat16, unsigned>(c, vec, slope, n, H, W, C, p, st, total)
                 : launch_fwd<__nv_bfloat16, long long>(c, vec, slope, n, H, W, C, p, st, total);
  return small ? launch_fwd<float, unsigned>(c, vec, slope, n, H, W, C, p, st, total)
               : launch_fwd<float, long long>(c, vec, slope, n, H, W, C, p, st, total);
}

// c: [n, H, W, C]; dap: [n, H/2, W/2, C], both contiguous in one dtype;
// vec: f32 [7, C] (a, b, g, g_mean_da, g_mean_da_xhat, mean, inv);
// codes: uint8 [n, H/2, W/2, C] scratch; dc: [n, H, W, C] in c's dtype.
// Two launches on `stream`: the window codes, then the gather.  Returns
// cudaGetLastError().
extern "C" int stem_pool_grad(const void* c, const void* dap, int is_bf16,
                              const void* vec, float slope, int n, int H, int W,
                              int C, void* codes, void* dc, void* stream) {
  const long long wins = (long long)n * (H / 2) * (W / 2) * C;
  const long long total = (long long)n * H * W * C;
  if (total == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const bool small = fits_32(total);
  if (is_bf16)
    return small ? launch_grad<__nv_bfloat16, unsigned>(c, dap, vec, slope, n, H, W, C,
                                                        codes, dc, st, wins, total)
                 : launch_grad<__nv_bfloat16, long long>(c, dap, vec, slope, n, H, W, C,
                                                         codes, dc, st, wins, total);
  return small ? launch_grad<float, unsigned>(c, dap, vec, slope, n, H, W, C, codes, dc,
                                              st, wins, total)
               : launch_grad<float, long long>(c, dap, vec, slope, n, H, W, C, codes, dc,
                                               st, wins, total);
}
