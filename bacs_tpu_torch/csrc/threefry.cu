// Counter-based random draws: Threefry-2x32, 20 rounds, with jax.random's
// partitionable counters, so the card draws the CPU's numbers from the same
// key (bacs_tpu_torch/ops/rng.py holds the plain version and the key API).
//
// Replaces no TPU kernel: JAX draws with XLA's own threefry
// (jax._src.prng, threefry2x32_p) and the port drew with torch.Generator,
// whose CUDA stream (Philox) differs from its CPU stream (mt19937).  Element
// i of a draw is the xor of the two words of threefry2x32(key, (i >> 32,
// i & 0xffffffff)), then by mode:
//   0  the bits, zero-extended to int64;
//   1  a uniform: the top 23 bits as the mantissa of a float in [1, 2),
//      minus 1, then lo + u * span rounded once (the product is exact in
//      f64, the sum rounded to f64 and then to f32, as the plain version
//      computes it; __dmul_rn / __dadd_rn keep nvcc from fusing) and at
//      least lo;
//   2  a Bernoulli mask u < p (u the uniform on [0, 1)), one byte a draw:
//      the dropout mask in one pass.
//
// Design.  One thread per element in a grid-stride loop, 256 threads a
// block, at most 16 blocks an SM; the key schedule is three registers, the
// rotations are constants (funnel shifts), so an element costs some 73
// integer instructions and one store.  Two launches give the same bits.
//
// Bound on the H100, at the detector's dropout mask of a BACS step, [16,
// 512, 32, 32] (8.4 M draws, mode 2): operations.  73 integer instructions
// a draw (20 rounds of add, funnel shift, xor; 5 key injections of two
// adds; the counters' first add and the output xor) at 128 lanes a clock
// that can issue an integer instruction (the 64 INT32 lanes and IMAD on the
// 64 FMA lanes) on each of 132 SMs at 1.98 GHz (33.4 T/s): 0.0183 ms; the
// 8.4 MB mask at 3.35 TB/s is 0.0025 ms.  Measured 0.0316 ms (NVIDIA H100
// 80GB HBM3, 700 W, chip_smoke.py [45]), 1.7x the bound.  chip_smoke.py
// computes the bound of each run's shapes.
// Tolerance: bit-equal to the plain version (mode 0 and 2, and mode 1).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define TF_ROUND(r)  \
  x0 += x1;          \
  x1 = rotl(x1, r);  \
  x1 ^= x0;

__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0,
                                              uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
  return make_uint2(x0, x1);
}

#undef TF_ROUND

__device__ __forceinline__ float unit(uint32_t b) {
  return __fsub_rn(__uint_as_float((b >> 9) | 0x3F800000u), 1.0f);
}

template <int kMode>
__global__ void __launch_bounds__(256) threefry_kernel(uint32_t k0, uint32_t k1, long long n,
                                                       float lo, float span, float p,
                                                       void* out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const uint2 y = threefry2x32(k0, k1, (uint32_t)((unsigned long long)i >> 32),
                                 (uint32_t)((unsigned long long)i & 0xFFFFFFFFull));
    const uint32_t b = y.x ^ y.y;
    if (kMode == 0) {
      ((long long*)out)[i] = (long long)b;
    } else if (kMode == 1) {
      const double v = __dadd_rn(__dmul_rn((double)unit(b), (double)span), (double)lo);
      ((float*)out)[i] = fmaxf(lo, __double2float_rn(v));
    } else {
      ((unsigned char*)out)[i] = unit(b) < p ? 1 : 0;
    }
  }
}

}  // namespace

// out: n elements, int64 (mode 0), f32 (mode 1) or bool (mode 2), on the
// current device.  One launch on `stream`.  Returns cudaGetLastError().
extern "C" int threefry_fill(uint32_t k0, uint32_t k1, long long n, int mode, float lo,
                             float span, float p, void* out, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long want = (n + 255) / 256;
  const int blocks = (int)(want < (long long)sms * 16 ? want : (long long)sms * 16);
  if (mode == 0)
    threefry_kernel<0><<<blocks, 256, 0, st>>>(k0, k1, n, lo, span, p, out);
  else if (mode == 1)
    threefry_kernel<1><<<blocks, 256, 0, st>>>(k0, k1, n, lo, span, p, out);
  else
    threefry_kernel<2><<<blocks, 256, 0, st>>>(k0, k1, n, lo, span, p, out);
  return (int)cudaGetLastError();
}
