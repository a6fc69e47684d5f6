// Fused stem: train-mode ABN apply + leaky-ReLU + 3x3/2 max-pool, forward
// and backward (the ResNet stem after its 7x7/2 convolution).
//
// Replaces the TPU kernels of bacs_tpu/ops/stem_pool.py: the forward
// `_fwd_pallas` (:232, pallas_call at :244, body `_fwd_kernel` :208, which
// pools separably: `_col_pool` :173, then `_row_pool` :195) and the
// backward `_bwd_pallas` (:338, pallas_call at :355, body `_bwd_kernel`
// :267, which recomputes its row block's codes with a halo row).
//
// Forward, per pooled output p[n, t, u, ch] of c [N, H, W, C] (NHWC, H and W
// even): y = leaky(c * a + b) in f32 for the 3x3 window of input rows 2t-1..2t+1
// and columns 2u-1..2u+1 (the padding never wins: every window holds a real
// cell), p = the window's max in c's dtype.  The full-resolution y is never
// written.  `a` and `b` are the folded affine rounded to c's dtype (given as
// f32 values), so the forward and the backward see the same y.
//
// Design.  A block takes one image, a band of pooled rows and a tile of
// pooled columns by channel groups (grid = (column tiles x channel tiles,
// bands, images)); a thread owns one pooled column u and V = 4 channels
// (one 8-byte load of bf16; V = 1 where C % 4 != 0 or a pointer is not
// 16-byte aligned).  Its indices come from the grid: one division per
// thread at its start, none per element.  Loads take clamped addresses
// and no branch (a mask drops what lies outside), so a row's loads issue
// together.  The pooling is separable, as the TPU kernel's: per input row
// the thread takes the 3-wide max of its columns 2u-1, 2u, 2u+1 (the first
// strict max and its kx), then walks down the band combining three row
// results per window, the lower row of one window kept as the upper row of
// the next.  Each thread computes y at its own columns 2u and 2u+1 and
// takes y at 2u-1 from the thread of column u-1 by a warp shuffle (the
// first column of each warp loads it), so each y is computed once per
// band, plus the band's one-row halo.
//
// Backward, one launch in two phases.  The same tiling plus one halo column
// of threads per block.  (1) Each thread walks its band as the forward
// does and writes the first-max codes (scan order ky*3+kx, a cell taking
// over only on a strict >: each row's first strict max, the rows compared
// in order with a strict >, which is the same code) of its windows, and of
// one halo window row, to shared memory, packed four bits a channel.  (2)
// After one barrier each input cell (2t+i, 2u+k) of the band gathers `dap`
// from the at most 2 x 2 windows that name it (their codes from shared
// memory, the right neighbour's written by the thread of column u+1), in
// the order `_scatter_codes_jnp` adds them (ky outer, kx inner), and
// applies the BN backward:
//   dc = g * da - g_mean_da - g_mean_da_xhat * (c - mean) * inv.
// No code reaches device memory; dap is read once, c twice (the second
// time, right after the first, from L2), dc written once.  No atomics,
// deterministic sums.  The affine, the leaky and the BN backward use
// explicitly rounded f32 operations (__fmul_rn / __fadd_rn / __fsub_rn: no
// fused multiply-add), the order of the plain PyTorch version's elementwise
// ops, so both take the same argmax and give the same bits.
//
// Bound on the H100, at the stem of a batch-12 512^2 DeepLabV3 train step,
// c [12, 256, 256, 64] bf16: device-memory bytes.  Forward 100.7 MB read +
// 25.2 MB written, 0.0376 ms at 3.35 TB/s; backward 100.7 + 25.2 MB read
// and 100.7 MB written, 0.0676 ms.  The work per element (two rounded
// operations, a select, the compares) is far below the f32 rate.  Measured
// on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py --family-times,
// CUDA-graph replay): forward 0.062-0.065 ms, backward 0.145 ms (1.7x and
// 2.1x the bound); the first port's design (one thread per element, nine
// evaluations of y per window, a uint8 code scratch between two backward
// launches) took 0.1898 and 0.6373 ms.  What holds the backward: phase (1)
// alone takes about the forward's time and phase (2) alone 0.091 ms, and
// the two do not overlap (PERF.md section 6).
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
constexpr int kThreads = 256;
constexpr int kMaxGroups = 32;       // channel groups of one block
constexpr int kTargetBlocks = 1024;  // about 8 blocks for each of the 132 SMs
constexpr int kMaxBand = 32;         // pooled rows of a block (the backward's codes fit 48 KB)
// channels a thread owns where C allows: 4 measured fastest both ways (8:
// 0.079 / 0.283 ms, 2: 0.071 / 0.174 at the main shape)
constexpr int kVec = 4;
constexpr uint32_t kNone = 0xffffffffu;  // packed codes of no window (15 matches no cell)

// leaky(x * a + b), each operation rounded as the plain version's
__device__ __forceinline__ float act(float x, float a, float b, float slope) {
  const float y = __fadd_rn(__fmul_rn(x, a), b);
  return y >= 0.f ? y : __fmul_rn(y, slope);
}

__device__ __forceinline__ float lo_bf16(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// One cell's V consecutive channels as loaded (one 8-byte load of bf16 at
// V = 4), so a thread holds its cells in the fewest registers; get(j)
// reads channel j as f32.
template <typename T, int V>
struct Cell {
  float f[V];
  __device__ __forceinline__ void load(const float* p) {
    if constexpr (V % 4 == 0) {
#pragma unroll
      for (int k = 0; k < V / 4; ++k) {
        const float4 q = reinterpret_cast<const float4*>(p)[k];
        f[4 * k] = q.x; f[4 * k + 1] = q.y; f[4 * k + 2] = q.z; f[4 * k + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) f[j] = p[j];
    }
  }
  __device__ __forceinline__ float get(int j) const { return f[j]; }
};
template <int V>
struct Cell<__nv_bfloat16, V> {
  static constexpr int kWords = (V + 1) / 2;
  uint32_t w[kWords];
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    static_assert(V == 4 || V == 1, "a thread owns 4 channels or 1");
    if constexpr (V == 4) {
      const uint2 r = *reinterpret_cast<const uint2*>(p);
      w[0] = r.x; w[1] = r.y;
    } else {
      w[0] = reinterpret_cast<const uint16_t*>(p)[0];
    }
  }
  __device__ __forceinline__ float get(int j) const {
    return j & 1 ? hi_bf16(w[j >> 1]) : lo_bf16(w[j >> 1]);
  }
};

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int k = 0; k < V / 4; ++k)
      reinterpret_cast<float4*>(p)[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = v[j];
  }
}
template <int V>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = __float2bfloat16_rn(v[j]);
  }
}

// A thread's place in the grid (grid = (column tiles x channel tiles,
// bands, images); one division per thread, none per element): its pooled
// column u, first channel ch, whether it holds a window (u < W2, ch < C),
// whether it writes, and whether the thread of column u - 1 is in its warp.
struct Place {
  int u, ch;
  int uc, chc;  // u and ch clamped into the tensor: every thread loads, `win` masks
  unsigned lanes;  // the warp's threads (a block's last warp may be partial)
  bool win, writer, left_in_warp;
};

// cols = kThreads / groups columns write; the backward's blocks hold one
// halo column of threads after them (`halo`), which only compute codes.
template <int V>
__device__ __forceinline__ Place place(int C, int W2, int groups, bool halo) {
  const int cols = kThreads / groups;
  const int cg_all = C / V;
  const int ctiles = (cg_all + groups - 1) / groups;
  const int ut = blockIdx.x / ctiles, ct = blockIdx.x - ut * ctiles;
  const int ul = threadIdx.x / groups, gl = threadIdx.x - ul * groups;
  const int lane = threadIdx.x & 31;
  Place pl;
  pl.u = ut * cols + ul;
  const int cg = ct * groups + gl;
  pl.ch = cg * V;
  pl.win = ul < cols + (halo ? 1 : 0) && pl.u < W2 && cg < cg_all;
  pl.writer = pl.win && ul < cols;
  const int in_warp = (int)blockDim.x - (int)(threadIdx.x & ~31u);
  pl.lanes = in_warp >= 32 ? 0xffffffffu : (1u << in_warp) - 1;
  pl.uc = min(pl.u, W2 - 1);
  pl.chc = cg < cg_all ? pl.ch : 0;
  pl.left_in_warp = groups < 32 && lane >= groups;
  return pl;
}

// y of V channels at two cells of a row
template <typename T, int V>
__device__ __forceinline__ void act_cells(const Cell<T, V>& x0, const Cell<T, V>& x1, bool have,
                                          const float (&a)[V], const float (&b)[V], float slope,
                                          float (&y0)[V], float (&y1)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    y0[j] = have ? act(x0.get(j), a[j], b[j], slope) : kNeg;
    y1[j] = have ? act(x1.get(j), a[j], b[j], slope) : kNeg;
  }
}

// The 3-wide row max of cells (l, m, r) per channel, the first strict max
// (l taking part only where `with_l`), and its kx packed four bits a channel.
template <int V>
__device__ __forceinline__ void max3(const float (&l)[V], bool with_l, const float (&m)[V],
                                     const float (&r)[V], float (&best)[V], uint32_t& kx) {
  kx = 0;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float v = kNeg;
    uint32_t k = 0;
    if (with_l && l[j] > v) v = l[j];  // kx 0 (k already 0)
    if (m[j] > v) { v = m[j]; k = 1; }
    if (r[j] > v) { v = r[j]; k = 2; }
    best[j] = v;
    kx |= k << (4 * j);
  }
}

// One input row r of the thread's window (t, u): its cells at columns 2u,
// 2u + 1 (x0, x1) and y there, and y at 2u - 1 from the thread of column
// u - 1 by a warp shuffle (loaded where that thread is not in the warp).
// Every thread of the warp must call it; r outside [0, H) is the padding
// (all kNeg, never taken).
template <typename T, typename Idx, int V>
__device__ __forceinline__ void load_row(const T* __restrict__ img, int r, int H, int W, int C,
                                         const Place& pl, int groups, const float (&a)[V],
                                         const float (&b)[V], float slope, Cell<T, V>& x0,
                                         Cell<T, V>& x1, float (&yl)[V], float (&y0)[V],
                                         float (&y1)[V], bool& have) {
  have = pl.win && r >= 0 && r < H;
  // loads without branches (clamped addresses), so that a row's loads issue
  // together; `have` masks what lies outside
  const T* row = img + (Idx)min(max(r, 0), H - 1) * W * C + pl.chc;
  x0.load(row + (Idx)(2 * pl.uc) * C);
  x1.load(row + (Idx)(2 * pl.uc + 1) * C);
  Cell<T, V> xl;
  if (!pl.left_in_warp) xl.load(row + (Idx)max(2 * pl.uc - 1, 0) * C);
  act_cells<T, V>(x0, x1, have, a, b, slope, y0, y1);
#pragma unroll
  for (int j = 0; j < V; ++j) yl[j] = __shfl_up_sync(pl.lanes, y1[j], groups & 31);
  if (!pl.left_in_warp) {
#pragma unroll
    for (int j = 0; j < V; ++j) yl[j] = act(xl.get(j), a[j], b[j], slope);
  }
}

// The window of three row results in scan order: a row takes over only on
// a strict >, its cell the row's first strict max; the code ky*3+kx packed
// four bits a channel.
template <int V>
__device__ __forceinline__ uint32_t combine(const float (&m0)[V], uint32_t k0,
                                            const float (&m1)[V], uint32_t k1,
                                            const float (&m2)[V], uint32_t k2) {
  uint32_t code = 0;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float m = kNeg;
    uint32_t c = 0;
    if (m0[j] > m) { m = m0[j]; c = (k0 >> (4 * j)) & 15u; }
    if (m1[j] > m) { m = m1[j]; c = 3 + ((k1 >> (4 * j)) & 15u); }
    if (m2[j] > m) { c = 6 + ((k2 >> (4 * j)) & 15u); }
    code |= c << (4 * j);
  }
  return code;
}

template <typename T, typename Idx, int V>
__global__ void __launch_bounds__(kThreads)
stem_pool_fwd_kernel(const T* __restrict__ c, const float* __restrict__ vec, float slope,
                     int H, int W, int C, int band, int groups, T* __restrict__ p) {
  const int H2 = H / 2, W2 = W / 2;
  const Place pl = place<V>(C, W2, groups, false);
  const T* img = c + (size_t)blockIdx.z * H * W * C;
  T* out = p + (size_t)blockIdx.z * H2 * W2 * C;
  float a[V], b[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    a[j] = pl.win ? vec[pl.ch + j] : 0.f;
    b[j] = pl.win ? vec[C + pl.ch + j] : 0.f;
  }
  const int t0 = blockIdx.y * band, t1 = min(H2, t0 + band);
  // each row's 3-wide max; the window the rows' max in order (values only)
  auto row = [&](int r, float (&best)[V]) {
    Cell<T, V> x0, x1;
    float yl[V], y0[V], y1[V];
    bool have;
    load_row<T, Idx, V>(img, r, H, W, C, pl, groups, a, b, slope, x0, x1, yl, y0, y1, have);
    uint32_t kx;
    max3<V>(yl, have && pl.u >= 1, y0, y1, best, kx);
  };
  float mp[V], m0[V], m1[V];
  row(2 * t0 - 1, mp);
  for (int t = t0; t < t1; ++t) {
    row(2 * t, m0);
    row(2 * t + 1, m1);
    float best[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float m = kNeg;  // strict >, as the scan
      if (mp[j] > m) m = mp[j];
      if (m0[j] > m) m = m0[j];
      if (m1[j] > m) m = m1[j];
      best[j] = m;
      mp[j] = m1[j];
    }
    if (pl.win) store_vec<V>(out + ((Idx)t * W2 + pl.u) * C + pl.ch, best);
  }
}

// The backward's threads: its writing columns and one halo column.
__host__ __device__ __forceinline__ int grad_threads(int groups) {
  return (kThreads / groups + 1) * groups;
}

// Shared memory of the backward: the packed codes of the band's window
// rows and the halo row, one word per thread a row, then the BN
// backward's five vectors of the block's channels, [5][groups * V] floats.
size_t grad_smem_bytes(int band, int groups, int V) {
  return sizeof(uint32_t) * ((size_t)(band + 1) * grad_threads(groups) + 5 * (size_t)groups * V);
}

// vec rows: a, b, g, g_mean_da, g_mean_da_xhat, mean, inv (each [C] f32).
// Four blocks an SM (56 registers): measured 5 % faster than three (65).
template <typename T, typename Idx, int V>
__global__ void __launch_bounds__(kThreads + kMaxGroups, 4)
stem_pool_grad_kernel(const T* __restrict__ c, const T* __restrict__ dap,
                      const float* __restrict__ vec, float slope, int H, int W, int C,
                      int band, int groups, T* __restrict__ dc) {
  extern __shared__ uint32_t codes[];  // [band + 1][threads]
  const int H2 = H / 2, W2 = W / 2;
  const Place pl = place<V>(C, W2, groups, true);
  const int slot = threadIdx.x;  // the thread's window in a row of codes
  const int pitch = blockDim.x;
  const size_t img_off = (size_t)blockIdx.z * H * W * C;
  const T* img = c + img_off;
  const int t0 = blockIdx.y * band, t1 = min(H2, t0 + band), tw = min(H2, t1 + 1);

  // 1. The first-max codes of the windows of rows t0 .. tw - 1 (the band and
  // one halo row), as the forward walks them, into shared memory.
  {
    float a[V], b[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      a[j] = pl.win ? vec[pl.ch + j] : 0.f;
      b[j] = pl.win ? vec[C + pl.ch + j] : 0.f;
    }
    auto row = [&](int r, float (&m)[V], uint32_t& k) {
      Cell<T, V> x0, x1;
      float yl[V], y0[V], y1[V];
      bool have;
      load_row<T, Idx, V>(img, r, H, W, C, pl, groups, a, b, slope, x0, x1, yl, y0, y1, have);
      max3<V>(yl, have && pl.u >= 1, y0, y1, m, k);
    };
    float mp[V], m0[V], m1[V];
    uint32_t kp, k0, k1;
    row(2 * t0 - 1, mp, kp);
    for (int t = t0; t < tw; ++t) {
      row(2 * t, m0, k0);
      row(2 * t + 1, m1, k1);
      codes[(t - t0) * pitch + slot] = pl.win ? combine<V>(mp, kp, m0, k0, m1, k1) : kNone;
#pragma unroll
      for (int j = 0; j < V; ++j) mp[j] = m1[j];
      kp = k1;
    }
  }
  // the five vectors of the BN backward, for the block's channels
  const int nv = groups * V;
  float* sv = reinterpret_cast<float*>(codes + (band + 1) * pitch);  // [5][nv]
  {
    const int ch0 = pl.ch - (slot % groups) * V;  // the block's first channel
    for (int i = threadIdx.x; i < 5 * nv; i += blockDim.x) {
      const int k = i / nv, ch = ch0 + i - k * nv;
      sv[i] = ch < C ? vec[(2 + k) * C + ch] : 0.f;
    }
  }
  __syncthreads();
  if (!pl.writer) return;

  // 2. Each cell (2t + i, 2u + k) of the band gathers the dap of the windows
  // that name it, in scan order of its place in them ((ky, kx) ascending),
  // and takes the BN backward.
  const T* dimg = dap + (size_t)blockIdx.z * H2 * W2 * C;
  T* dout = dc + img_off;
  const bool has_r = pl.u + 1 < W2;
  const int right = slot + groups;  // the thread of window (t, u + 1)
  const float* v5 = sv + (slot % groups) * V;  // g, g_mean_da, g_mean_da_xhat, mean, inv
  Cell<T, V> d_c, d_cr, d_n, d_nr;  // dap of (t, u), (t, u+1), (t+1, u), (t+1, u+1)
  const T* drow = dimg + ((Idx)t0 * W2 + pl.u) * C + pl.ch;
  d_c.load(drow);
  d_cr.load(drow + (has_r ? C : 0));
  for (int t = t0; t < t1; ++t) {
    const bool next = t + 1 < H2;
    const uint32_t* crow = codes + (t - t0) * pitch;
    const uint32_t code_c = crow[slot], code_cr = crow[right];
    const uint32_t code_n = next ? crow[pitch + slot] : kNone;
    const uint32_t code_nr = next ? crow[pitch + right] : kNone;
    const T* dn = drow + (Idx)(next ? t + 1 - t0 : t - t0) * W2 * C;
    d_n.load(dn);
    d_nr.load(dn + (has_r ? C : 0));
    const T* r0 = img + ((Idx)(2 * t) * W + 2 * pl.u) * C + pl.ch;
    Cell<T, V> x00, x01, x10, x11;
    x00.load(r0);
    x01.load(r0 + C);
    x10.load(r0 + (Idx)W * C);
    x11.load(r0 + (Idx)W * C + C);
    float o00[V], o01[V], o10[V], o11[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int s = 4 * j;
      const uint32_t kc = (code_c >> s) & 15u, kcr = (code_cr >> s) & 15u;
      const uint32_t kn = (code_n >> s) & 15u, knr = (code_nr >> s) & 15u;
      float da00 = 0.f, da01 = 0.f, da10 = 0.f, da11 = 0.f;
      if (kc == 4) da00 = __fadd_rn(da00, d_c.get(j));    // (2t, 2u): (t, u) only
      if (kcr == 3) da01 = __fadd_rn(da01, d_cr.get(j));  // (2t, 2u+1)
      if (kc == 5) da01 = __fadd_rn(da01, d_c.get(j));
      if (kn == 1) da10 = __fadd_rn(da10, d_n.get(j));    // (2t+1, 2u)
      if (kc == 7) da10 = __fadd_rn(da10, d_c.get(j));
      if (knr == 0) da11 = __fadd_rn(da11, d_nr.get(j));  // (2t+1, 2u+1)
      if (kn == 2) da11 = __fadd_rn(da11, d_n.get(j));
      if (kcr == 6) da11 = __fadd_rn(da11, d_cr.get(j));
      if (kc == 8) da11 = __fadd_rn(da11, d_c.get(j));
      const float g = v5[j], gmda = v5[nv + j], gmdax = v5[2 * nv + j];
      const float mean = v5[3 * nv + j], inv = v5[4 * nv + j];
      auto bn_bwd = [&](float x, float da) {
        const float x_hat = __fmul_rn(__fsub_rn(x, mean), inv);
        return __fsub_rn(__fsub_rn(__fmul_rn(g, da), gmda), __fmul_rn(gmdax, x_hat));
      };
      o00[j] = bn_bwd(x00.get(j), da00);
      o01[j] = bn_bwd(x01.get(j), da01);
      o10[j] = bn_bwd(x10.get(j), da10);
      o11[j] = bn_bwd(x11.get(j), da11);
    }
    T* w0 = dout + ((Idx)(2 * t) * W + 2 * pl.u) * C + pl.ch;
    store_vec<V>(w0, o00);
    store_vec<V>(w0 + C, o01);
    store_vec<V>(w0 + (Idx)W * C, o10);
    store_vec<V>(w0 + (Idx)W * C + C, o11);
    d_c = d_n;
    d_cr = d_nr;
  }
}

// Index arithmetic inside an image in 32 bits where its element count
// allows (a 64-bit multiply is two instructions), in 64 bits beyond.
bool fits_32(long long total) { return total < (1LL << 31); }

// Whether a thread takes kVec channels: C a multiple of it and every
// pointer 16-byte aligned (a float4 of f32), else one channel.
bool wide(int C, const void* p0, const void* p1, const void* p2 = nullptr) {
  return C % kVec == 0 && ((uintptr_t)p0 | (uintptr_t)p1 | (uintptr_t)p2) % 16 == 0;
}

struct Grid {
  dim3 blocks;
  int band, groups;
};

// Bands of pooled rows that give about kTargetBlocks blocks.
Grid grid_for(int n, int H, int W, int C, int V) {
  const int cg_all = C / V;
  Grid g;
  g.groups = cg_all < kMaxGroups ? cg_all : kMaxGroups;
  const int cols = kThreads / g.groups;
  const int W2 = W / 2, H2 = H / 2;
  const long long tiles = (long long)((W2 + cols - 1) / cols) *
                          ((cg_all + g.groups - 1) / g.groups);
  long long band = (tiles * n * H2 + kTargetBlocks - 1) / kTargetBlocks;
  band = band < 1 ? 1 : (band > kMaxBand ? kMaxBand : band);
  g.band = (int)band;
  g.blocks = dim3((unsigned)tiles, (unsigned)((H2 + band - 1) / band), (unsigned)n);
  return g;
}

template <typename T, int V>
int launch_fwd(const void* c, const void* vec, float slope, int n, int H, int W, int C,
               void* p, cudaStream_t st) {
  const Grid g = grid_for(n, H, W, C, V);
  if (fits_32((long long)H * W * C))
    stem_pool_fwd_kernel<T, unsigned, V><<<g.blocks, kThreads, 0, st>>>(
        (const T*)c, (const float*)vec, slope, H, W, C, g.band, g.groups, (T*)p);
  else
    stem_pool_fwd_kernel<T, long long, V><<<g.blocks, kThreads, 0, st>>>(
        (const T*)c, (const float*)vec, slope, H, W, C, g.band, g.groups, (T*)p);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_grad(const void* c, const void* dap, const void* vec, float slope, int n, int H,
                int W, int C, void* dc, cudaStream_t st) {
  const Grid g = grid_for(n, H, W, C, V);
  const size_t smem = grad_smem_bytes(g.band, g.groups, V);  // at most 43 KB
  if (fits_32((long long)H * W * C))
    stem_pool_grad_kernel<T, unsigned, V><<<g.blocks, grad_threads(g.groups), smem, st>>>(
        (const T*)c, (const T*)dap, (const float*)vec, slope, H, W, C, g.band, g.groups,
        (T*)dc);
  else
    stem_pool_grad_kernel<T, long long, V><<<g.blocks, grad_threads(g.groups), smem, st>>>(
        (const T*)c, (const T*)dap, (const float*)vec, slope, H, W, C, g.band, g.groups,
        (T*)dc);
  return (int)cudaGetLastError();
}

}  // namespace

// c: [n, H, W, C] contiguous, f32 (is_bf16 == 0) or bf16, H and W even;
// vec: f32 [2, C] (a, b); p: [n, H/2, W/2, C] in c's dtype.
// Returns cudaGetLastError().
extern "C" int stem_pool_fwd(const void* c, int is_bf16, const void* vec, float slope, int n,
                             int H, int W, int C, void* p, void* stream) {
  if ((long long)n * (H / 2) * (W / 2) * C == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const bool v4 = wide(C, c, p);
  if (is_bf16)
    return v4 ? launch_fwd<__nv_bfloat16, kVec>(c, vec, slope, n, H, W, C, p, st)
              : launch_fwd<__nv_bfloat16, 1>(c, vec, slope, n, H, W, C, p, st);
  return v4 ? launch_fwd<float, kVec>(c, vec, slope, n, H, W, C, p, st)
            : launch_fwd<float, 1>(c, vec, slope, n, H, W, C, p, st);
}

// c: [n, H, W, C]; dap: [n, H/2, W/2, C], both contiguous in one dtype;
// vec: f32 [7, C] (a, b, g, g_mean_da, g_mean_da_xhat, mean, inv);
// dc: [n, H, W, C] in c's dtype.  One launch on `stream`.  Returns
// cudaGetLastError().
extern "C" int stem_pool_grad(const void* c, const void* dap, int is_bf16, const void* vec,
                              float slope, int n, int H, int W, int C, void* dc, void* stream) {
  if ((long long)n * H * W * C == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const bool v4 = wide(C, c, dap, dc);
  if (is_bf16)
    return v4 ? launch_grad<__nv_bfloat16, kVec>(c, dap, vec, slope, n, H, W, C, dc, st)
              : launch_grad<__nv_bfloat16, 1>(c, dap, vec, slope, n, H, W, C, dc, st);
  return v4 ? launch_grad<float, kVec>(c, dap, vec, slope, n, H, W, C, dc, st)
            : launch_grad<float, 1>(c, dap, vec, slope, n, H, W, C, dc, st);
}
