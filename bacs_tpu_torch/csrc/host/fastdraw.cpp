// Normal and truncated-normal draws of jax.random on the CPU, bit for bit,
// on the host: threefry2x32 (20 rounds, partitionable counters), the top 23
// bits as a uniform in [0, 1), and XLA's CPU f32 erfinv (Giles), log1p and
// log (Cephes) with the multiply-adds XLA fuses written as fma().  The plain
// version is ``bacs_tpu_torch/ops/rng.py`` (``normal``, ``truncated_normal``
// on torch ops), which this file must match bit for bit.
//
//   g++ -O3 -march=native -ffp-contract=off -shared -fPIC -pthread fastdraw.cpp \
//       -o libfastdraw.so
//
// -ffp-contract=off: the compiler fuses no multiply-add of its own; each
// one XLA fuses is an explicit fma().

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

inline uint32_t threefry_bits(uint32_t k0, uint32_t k1, uint64_t i) {
  static const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  uint32_t x0 = static_cast<uint32_t>(i >> 32) + k0;
  uint32_t x1 = static_cast<uint32_t>(i) + k1;
  for (int r5 = 0; r5 < 5; ++r5) {
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[r5 % 2][j]);
      x1 ^= x0;
    }
    x0 += ks[(r5 + 1) % 3];
    x1 += ks[(r5 + 2) % 3] + static_cast<uint32_t>(r5 + 1);
  }
  return x0 ^ x1;
}

inline float unit(uint32_t b) {
  uint32_t m = (b >> 9) | 0x3F800000u;
  float f;
  std::memcpy(&f, &m, 4);
  return f - 1.0f;
}

inline float xla_log(float x) {
  static const float p[9] = {7.0376836292e-2f, -1.1514610310e-1f, 1.1676998740e-1f,
                             -1.2420140846e-1f, 1.4249322787e-1f, -1.6668057665e-1f,
                             2.0000714765e-1f, -2.4999993993e-1f, 3.3333331174e-1f};
  if (std::isnan(x) || x < 0.0f) return NAN;
  if (x == 0.0f) return -INFINITY;
  if (std::isinf(x)) return INFINITY;
  const float tiny = 1.17549435e-38f;
  int ei;
  float m = std::frexp(x < tiny ? tiny : x, &ei);
  const bool small = m < 0.707106781186547524f;
  float e = static_cast<float>(ei) - (small ? 1.0f : 0.0f);
  float t = (m - 1.0f) + (small ? m : 0.0f);
  float t2 = t * t;
  float t3 = t2 * t;
  float y = std::fma(p[0], t, p[1]);
  float y1 = std::fma(p[3], t, p[4]);
  float y2 = std::fma(p[6], t, p[7]);
  y = std::fma(y, t, p[2]);
  y1 = std::fma(y1, t, p[5]);
  y2 = std::fma(y2, t, p[8]);
  y = std::fma(y, t3, y1);
  y = std::fma(y, t3, y2);
  y = std::fma(y, t3, e * -2.12194440e-4f);
  return ((t - 0.5f * t2) + y) + e * 0.693359375f;
}

inline float horner(const float* c, int n, float x) {
  float p = c[0];
  for (int i = 1; i < n; ++i) p = std::fma(p, x, c[i]);
  return p;
}

inline float xla_log1p(float x) {
  static const float num[7] = {
      4.5270000862445199635215e-5f, 4.9854102823193375972212e-1f,
      6.5787325942061044846969e0f,  2.9911919328553073277375e1f,
      6.0949667980987787057556e1f,  5.7112963590585538103336e1f,
      2.0039553499201281259648e1f};
  static const float den[7] = {
      1.0f, 1.5062909083469192043167e1f, 8.3047565967967209469434e1f,
      2.2176239823732856465394e2f, 3.0909872225312059774938e2f,
      2.1642788614495947685003e2f, 6.0118660497603843919306e1f};
  if (std::fabs(x) < 0.41421356237309504880f) {
    float x2 = x * x;
    float r = horner(num, 7, x) / horner(den, 7, x);
    return x + ((-0.5f) * x2 + (x * x2) * r);
  }
  return xla_log(x + 1.0f);
}

inline float xla_erfinv(float x) {
  static const float lo[9] = {2.81022636e-08f, 3.43273939e-07f, -3.5233877e-06f,
                              -4.39150654e-06f, 0.00021858087f, -0.00125372503f,
                              -0.00417768164f, 0.246640727f, 1.50140941f};
  static const float hi[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f,
                              -0.00367342844f, 0.00573950773f, -0.0076224613f,
                              0.00943887047f, 1.00167406f, 2.83297682f};
  if (std::fabs(x) == 1.0f) return x * 3.40282347e+38f;
  float w = -xla_log1p(-(x * x));
  const bool lt = w < 5.0f;
  const float* c = lt ? lo : hi;
  w = lt ? w - 2.5f : std::sqrt(w) - 3.0f;
  return horner(c, 9, w) * x;
}

void draw_range(uint32_t k0, uint32_t k1, int64_t begin, int64_t end, int truncated,
                float scale, float* out) {
  const float sqrt2 = 1.41421353816986083984375f;
  // the uniform's ends: (nextafter(-1, 0), 1), or (erf(-sqrt 2), erf(sqrt 2))
  const float lo = truncated ? -0.954499721527099609375f : -0.999999940395355224609375f;
  const float hi = truncated ? 0.954499721527099609375f : 1.0f;
  const float span = hi - lo;
  const float inner = 1.99999988079071044921875f;  // nextafter(2, 0)
  for (int64_t i = begin; i < end; ++i) {
    float u = std::fma(unit(threefry_bits(k0, k1, static_cast<uint64_t>(i))), span, lo);
    if (u < lo) u = lo;
    float v = xla_erfinv(u) * sqrt2;
    if (truncated) v = v < -inner ? -inner : (v > inner ? inner : v);
    out[i] = v * scale;
  }
}

}  // namespace

extern "C" {

// out[i] = jax.random.normal(key, shape)[i] (truncated = 0), or
// jax.random.truncated_normal(key, -2, 2, shape)[i] (truncated = 1), times
// ``scale`` (an initializer's f32 multiply), for i in [0, n) in row-major
// order, on ``threads`` threads.
void draw_normal(uint32_t k0, uint32_t k1, int64_t n, int truncated, float scale,
                 int threads, float* out) {
  const int64_t parts = threads > 1 && n >= (1 << 16) ? threads : 1;
  std::vector<std::thread> pool;
  for (int64_t p = 1; p < parts; ++p)
    pool.emplace_back(draw_range, k0, k1, n * p / parts, n * (p + 1) / parts, truncated,
                      scale, out);
  draw_range(k0, k1, 0, n / parts, truncated, scale, out);
  for (auto& t : pool) t.join();
}

}  // extern "C"
