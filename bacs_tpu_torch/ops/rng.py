"""Counter-based random draws, the same bits on every device and JAX's.

``jax.random``'s default generator, Threefry-2x32 with 20 rounds and
partitionable counters (JAX 0.9's default), written for torch.  A draw is a
function of its key and its shape alone: element i of ``bits(key, shape)``
is the xor of the two words of threefry2x32(key, (i >> 32, i & 0xFFFFFFFF)),
i the element's row-major index, so the CPU and the card draw the same
numbers from the same key, as a TPU and a CPU do in JAX.

- A key is two uint32 words, a tuple of Python ints (``key(seed)``,
  ``split``, ``fold_in``: JAX's ``threefry_seed``, its fold-like split and
  ``fold_in``).  Keys live on the host and cost no device memory, launch or
  host read; a checkpoint saves them as they are.  Each draw site of the
  port takes the key the JAX function it ports takes and splits it as that
  function does; :func:`scope_key` is the key Flax's ``make_rng`` gives a
  module path (the initial weights, ``utils/flax_init.py``, and the
  detector's dropout) and :func:`train_step_keys` a train step's split.
- :func:`bits`, :func:`uniform`, :func:`bernoulli`, :func:`normal`,
  :func:`truncated_normal`, :func:`beta` and :func:`choice` equal
  ``jax.random``'s on the CPU bit for bit: ``uniform`` puts the top 23 bits
  in a float's mantissa in [1, 2) and subtracts 1, then scales to [lo, hi)
  as u * (hi - lo) + lo rounded once (XLA fuses the two; here the product
  is exact in f64 and the sum rounded to f64, then to f32); ``normal`` is
  sqrt(2) erfinv of a uniform on (-1, 1) with XLA's CPU ``erf_inv``
  (:func:`xla_erfinv`: Giles' polynomial over XLA's ``log1p`` and Cephes
  ``log``, each multiply-add XLA fuses rounded once), drawn on the host by
  ``csrc/host/fastdraw.cpp`` where it builds, else by the plain torch
  version; ``beta`` runs ``jax.random.beta``'s Marsaglia-Tsang loops with
  their keys.

On a CPU tensor the draws are the plain version.  On a CUDA device
:func:`bits`, :func:`uniform` and :func:`bernoulli` launch the hand-written
kernel of ``csrc/threefry.cu`` (``threefry_fill``) or raise: the detector's
dropout mask, [16, 32, 32, 512] at the main path's shapes, is too large to
draw on the host and copy over.  Draws that pass through ``exp``, ``log``
or ``erfinv`` (normals, crops, Beta draws) are computed on the host and
copied, as the card's transcendental functions differ in the last bit.
The kernel replaces no TPU kernel: JAX draws with XLA's own threefry.
``threefry_fill.launches`` counts its launches.
"""

from __future__ import annotations

import hashlib
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from bacs_tpu_torch.kernels import build

Key = Tuple[int, int]

_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# the kernel's modes (csrc/threefry.cu)
_BITS, _UNIFORM, _BERNOULLI = 0, 1, 2
_SQRT2 = float(np.float32(np.sqrt(2)))
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def _threefry(k0, k1, x0, x1, mask):
    """Threefry-2x32, 20 rounds (``jax._src.prng._threefry2x32_lowering``),
    on Python ints (``mask`` = 0xFFFFFFFF) or int64 tensors (counters x0,
    x1)."""
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & mask
    x1 = (x1 + k1) & mask
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & mask
            x1 = ((x1 << r) & mask) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & mask
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & mask
    return x0, x1


def key(seed: int) -> Key:
    """The key of an integer seed (``jax.random.key(seed,
    impl="threefry2x32")``): its high and low 32-bit words."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return (seed >> 32) & _M, seed & _M


def as_key(k) -> Key:
    """A key given as a tuple, a list or a [2] integer tensor or array."""
    if isinstance(k, torch.Tensor):
        k = k.tolist()
    k0, k1 = (int(v) & _M for v in k)
    return k0, k1


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in``: threefry2x32(key, (0, data))."""
    k0, k1 = as_key(k)
    return _threefry(k0, k1, 0, int(data) & _M, _M)


def split(k: Key, n: int = 2) -> List[Key]:
    """``jax.random.split`` with partitionable counters: key i is
    threefry2x32(key, (0, i)), the same as ``fold_in(key, i)``."""
    return [fold_in(k, i) for i in range(n)]


def _shape(shape) -> Tuple[int, ...]:
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


def _bits_host(k: Key, n: int, chunk: int = 1 << 16) -> np.ndarray:
    """The plain version on the host: uint32 [n], :func:`_threefry` on
    numpy's wrapping uint32 arrays, a cache-sized chunk at a time (several
    times the rate of the int64 tensor version on one core)."""
    k0, k1 = as_key(k)
    out = np.empty(n, np.uint32)
    for lo in range(0, n, chunk):
        i = np.arange(lo, min(n, lo + chunk), dtype=np.uint64)
        y0, y1 = _threefry(k0, k1, (i >> np.uint64(32)).astype(np.uint32),
                           i.astype(np.uint32), _M)
        np.bitwise_xor(y0, y1, out=out[lo:lo + len(i)])
    return out


def _bits_plain(k: Key, shape: Sequence[int], device) -> torch.Tensor:
    """The plain version: int64 [shape] in [0, 2^32), the xor of the two
    output words at counters (i >> 32, i & 0xFFFFFFFF); on the host in
    numpy (:func:`_bits_host`), elsewhere in int64 tensor ops masked to 32
    bits."""
    n = math.prod(shape)
    if torch.device(device).type == "cpu":
        return torch.from_numpy(_bits_host(k, n).astype(np.int64)).reshape(shape)
    i = torch.arange(n, dtype=torch.int64, device=device)
    k0, k1 = k
    y0, y1 = _threefry(k0, k1, i >> 32, i & _M, _M)
    return (y0 ^ y1).reshape(shape)


def _bits_to_unit(b: torch.Tensor) -> torch.Tensor:
    """int64 bits -> f32 in [0, 1): the top 23 bits as the mantissa of a
    float in [1, 2), minus 1 (``jax.random._uniform``)."""
    return ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def _scale(lo: float, hi: float) -> Tuple[float, float]:
    """(lo, hi - lo) rounded as JAX rounds them: both ends in f32 first."""
    lo32, hi32 = np.float32(lo), np.float32(hi)
    return float(lo32), float(np.float32(hi32 - lo32))


def _on_card(device) -> bool:
    device = torch.device(device)
    if device.type == "cuda":
        return True
    if device.type != "cpu":
        raise ValueError(f"draws run on the CPU or a CUDA device, got {device}")
    return False


def fill_plain(k: Key, shape: Sequence[int], mode: int, device="cpu", lo: float = 0.0,
               span: float = 1.0, p: float = 0.5) -> torch.Tensor:
    """The plain version of :func:`threefry_fill`, on any device: ``mode``
    0 the bits (int64), 1 the uniforms lo + u * span (f32, at least lo), 2
    the mask ``u < p`` (bool, u the uniform on [0, 1)).  ``lo``, ``span``
    and ``p`` are rounded to f32, as the kernel takes them."""
    lo, span, p = (float(np.float32(v)) for v in (lo, span, p))
    b = _bits_plain(as_key(k), shape, device)
    if mode == _BITS:
        return b
    u = _bits_to_unit(b)
    if mode == _BERNOULLI:
        return u < p
    return torch.clamp_min((u.double() * span + lo).float(), lo)


def threefry_fill(k: Key, shape: Sequence[int], mode: int, device, lo: float = 0.0,
                  span: float = 1.0, p: float = 0.5) -> torch.Tensor:
    """Launch ``csrc/threefry.cu`` on a CUDA ``device`` (the arguments of
    :func:`fill_plain`)."""
    if not _on_card(device):
        raise ValueError(f"threefry_fill needs a CUDA device, got {device}")
    dtype = (torch.int64, torch.float32, torch.bool)[mode]
    out = torch.empty(shape, dtype=dtype, device=device)
    n = out.numel()
    if n == 0:
        return out
    k0, k1 = as_key(k)
    lib = build.load_library()
    with torch.cuda.device(out.device):
        code = lib.threefry_fill(k0, k1, n, mode, float(lo), float(span), float(p),
                                 out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    build.check(code, "threefry_fill")
    threefry_fill.launches += 1
    return out


threefry_fill.launches = 0


def _fill(k: Key, shape, mode: int, device, **kw) -> torch.Tensor:
    """The kernel on a CUDA device, the plain version on the CPU."""
    shape = _shape(shape)
    if _on_card(device):
        return threefry_fill(k, shape, mode, device, **kw)
    return fill_plain(k, shape, mode, device, **kw)


def bits(k: Key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as int64 values in [0, 2^32)."""
    return _fill(k, shape, _BITS, device)


def uniform(k: Key, shape, lo: float = 0.0, hi: float = 1.0, device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=lo, maxval=hi)``, f32."""
    lo32, span = _scale(lo, hi)
    return _fill(k, shape, _UNIFORM, device, lo=lo32, span=span)


def bernoulli(k: Key, p: float, shape, device="cpu") -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: ``uniform < p``, bool."""
    return _fill(k, shape, _BERNOULLI, device, p=float(np.float32(p)))


# XLA's f32 elementary functions on the CPU, bit for bit: Cephes' log and
# exp and Giles' erfinv, evaluated as XLA's CPU code evaluates them (each
# multiply-add of a polynomial fused, emulated here as an f64 product, exact,
# and one rounding to f32).  torch's own log, exp and erfinv differ from
# them in the last bit in 10-70 % of the values.
_F32_MAX = float(np.finfo(np.float32).max)
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
          1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
          3.3333331174e-1)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
          1.6666665459e-1, 5.0000001201e-1)
_ERFINV_LO = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
              0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_HI = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
              0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _f32(v: float) -> float:
    return float(np.float32(v))


def _fma(a, b, c) -> torch.Tensor:
    """a * b + c rounded once to f32 (f32 tensors or floats; a tensor
    among them)."""
    dd = lambda v: v.double() if isinstance(v, torch.Tensor) else float(v)  # noqa: E731
    return (dd(a) * dd(b) + dd(c)).float()


def xla_sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root of a host tensor, as XLA's
    ``vsqrtps`` gives it (torch's CPU ``sqrt`` is not: it differs in the
    last bit in ~0.7 % of the values)."""
    return torch.from_numpy(np.asarray(np.sqrt(x.numpy())))


def _pow2(m: torch.Tensor) -> torch.Tensor:
    """2 ** m for f32 integral m in [-126, 127], built from its bits."""
    return ((m.to(torch.int32) + 127) << 23).view(torch.float32)


def _horner(coeffs, x: torch.Tensor) -> torch.Tensor:
    p = torch.full_like(x, _f32(coeffs[0]))
    for c in coeffs[1:]:
        p = _fma(p, x, _f32(c))
    return p


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log`` of f32 ``x`` as XLA computes it on the CPU."""
    m, e = torch.frexp(torch.clamp_min(x, _f32(np.finfo(np.float32).tiny)))
    small = m < _f32(0.707106781186547524)
    e = e.float() - small.float()
    t = (m - 1.0) + torch.where(small, m, 0.0)
    t2 = t * t
    t3 = t2 * t
    y = _fma(_f32(_LOG_P[0]), t, _f32(_LOG_P[1]))
    y1 = _fma(_f32(_LOG_P[3]), t, _f32(_LOG_P[4]))
    y2 = _fma(_f32(_LOG_P[6]), t, _f32(_LOG_P[7]))
    y = _fma(y, t, _f32(_LOG_P[2]))
    y1 = _fma(y1, t, _f32(_LOG_P[5]))
    y2 = _fma(y2, t, _f32(_LOG_P[8]))
    y = _fma(y, t3, y1)
    y = _fma(y, t3, y2)
    y = _fma(y, t3, e * _f32(-2.12194440e-4))
    out = ((t - 0.5 * t2) + y) + e * 0.693359375
    out = torch.where(x == 0, -torch.inf, out)
    out = torch.where(x == torch.inf, torch.inf, out)
    return torch.where((x < 0) | torch.isnan(x), torch.nan, out)


def xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log1p`` of f32 ``x`` as XLA computes it on the CPU: Cephes'
    rational function below |x| = sqrt(2) - 1, ``log(1 + x)`` above."""
    x2 = x * x
    small = _horner(_LOG1P_NUM, x) / _horner(_LOG1P_DEN, x)
    small = x + ((-0.5) * x2 + (x * x2) * small)
    return torch.where(x.abs() < _f32(0.41421356237309504880), small, xla_log(x + 1.0))


def xla_exp(x: torch.Tensor) -> torch.Tensor:
    """``jnp.exp`` of f32 ``x`` as XLA computes it on the CPU (to
    exp(-87.3), the smallest normal float's logarithm)."""
    x = torch.clamp(x, _f32(-87.33654475), _f32(88.72283905))
    m = torch.floor(_fma(x, _f32(1.44269504088896341), 0.5))
    r = _fma(m, -0.693359375, x)
    r = _fma(m, _f32(2.12194440e-4), r)
    y = _fma(_horner(_EXP_P, r), r * r, r) + 1.0
    half = torch.floor(m * 0.5)
    return y * _pow2(half) * _pow2(m - half)


def xla_erfinv(x: torch.Tensor) -> torch.Tensor:
    """``lax.erf_inv`` of f32 ``x`` in (-1, 1) as XLA computes it on the CPU
    (Giles' single-precision approximation)."""
    w = -xla_log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, xla_sqrt(w) - 3.0)
    p = torch.where(lt, _f32(_ERFINV_LO[0]), _f32(_ERFINV_HI[0]))
    for lo, hi in zip(_ERFINV_LO[1:], _ERFINV_HI[1:]):
        p = _fma(p, w, torch.where(lt, _f32(lo), _f32(hi)))
    return torch.where(x.abs() == 1.0, x * _F32_MAX, p * x)


_LIB = None
_TRIED = False


def _native():
    """The host library of ``csrc/host/fastdraw.cpp`` (built with g++ at
    first use), or None where it does not build."""
    global _LIB, _TRIED
    if not _TRIED:
        _TRIED = True
        import ctypes

        from bacs_tpu_torch.kernels import host_build

        try:
            _LIB = ctypes.CDLL(str(host_build.build("fastdraw")))
            _LIB.draw_normal.argtypes = (ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int64,
                                         ctypes.c_int, ctypes.c_float, ctypes.c_int,
                                         ctypes.c_void_p)
            _LIB.draw_normal.restype = None
        except (RuntimeError, OSError):
            _LIB = None
    return _LIB


def _normal_host(k: Key, shape, truncated: bool, scale: float = 1.0) -> torch.Tensor:
    """The draws of :func:`normal` or :func:`truncated_normal` on the host,
    times ``scale`` rounded to f32 (one f32 multiply, as an initializer's
    ``normal(key, shape) * std``): the native library's where it builds
    (60x the rate), else the plain version below, bit for bit the same."""
    shape = _shape(shape)
    lib = _native()
    if lib is not None:
        out = torch.empty(shape, dtype=torch.float32)
        lib.draw_normal(*as_key(k), out.numel(), int(truncated), _f32(scale),
                        torch.get_num_threads(), out.data_ptr())
        return out
    out = _normal_plain(k, shape, truncated)
    return out if scale == 1.0 else out * _f32(scale)


def _normal_plain(k: Key, shape, truncated: bool) -> torch.Tensor:
    """sqrt(2) erfinv of a uniform on (nextafter(-1, 0), 1), or for the
    truncated normal on (erf(-sqrt 2), erf(sqrt 2)) and clamped to the open
    interval (-2, 2), in torch ops (``jax.random._normal_real``,
    ``_truncated_normal``)."""
    if not truncated:
        return xla_erfinv(uniform(k, shape, _NORMAL_LO, 1.0)) * _SQRT2
    out = xla_erfinv(uniform(k, shape, -_ERF_SQRT2, _ERF_SQRT2)) * _SQRT2
    inner = float(np.nextafter(np.float32(2.0), np.float32(0.0)))
    return torch.clamp(out, -inner, inner)


# erf(-+2 / sqrt(2)) in f32: a standard normal's truncation to [-2, 2]
_ERF_SQRT2 = _f32(math.erf(math.sqrt(2.0)))


def normal(k: Key, shape, device="cpu", scale: float = 1.0) -> torch.Tensor:
    """``jax.random.normal(key, shape) * scale`` (``scale`` an f32), f32,
    bit for bit; drawn on the host and moved (the same numbers on every
    device)."""
    return to_device(_normal_host(k, shape, False, scale), device)


def truncated_normal(k: Key, shape, device="cpu", scale: float = 1.0) -> torch.Tensor:
    """``jax.random.truncated_normal(key, -2, 2, shape) * scale``, f32, bit
    for bit; drawn on the host and moved."""
    return to_device(_normal_host(k, shape, True, scale), device)


def split_keys(keys, n: int) -> List[np.ndarray]:
    """``split(k, n)`` of each key of ``keys`` (a sequence of keys or an
    int64 array [m, 2]): n int64 arrays [m, 2], the i-th the keys' i-th
    split, computed at once."""
    keys = np.asarray(keys, np.int64).reshape(-1, 2)
    out = []
    for i in range(n):
        y0, y1 = _threefry(keys[:, 0], keys[:, 1], 0, i, _M)
        out.append(np.stack([y0, y1], axis=1))
    return out


def scalar_uniforms(keys, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    """f32 [m] on the host: ``jax.random.uniform(k, (), lo, hi)`` of each
    key of ``keys`` (a sequence of keys or an int64 array [m, 2]; the bits
    of counter 0, as a vmap over per-item keys draws them)."""
    keys = np.asarray(keys, np.int64).reshape(-1, 2)
    y0, y1 = _threefry(keys[:, 0], keys[:, 1], 0, 0, _M)
    lo32, span = _scale(lo, hi)
    u = _bits_to_unit(torch.from_numpy(np.asarray(y0 ^ y1, np.int64)))
    return torch.clamp_min((u.double() * span + lo32).float(), lo32)


def _log_gamma(keys: np.ndarray, a: float) -> torch.Tensor:
    """f32 [m]: one ``jax.random.loggamma(k, a)`` draw per key of an array
    [m, 2] (``_gamma_one`` in log space: Marsaglia and Tsang's method, f32,
    each key's while loops and splits as JAX's), all keys at once."""
    alpha = torch.tensor(a, dtype=torch.float32)
    boost = a >= 1.0
    if not boost:
        alpha = alpha + 1.0
    d = alpha - _f32(1.0 / 3.0)
    c = _f32(1.0 / 3.0) / xla_sqrt(d)
    keys, sub = split_keys(keys, 2)
    m = keys.shape[0]
    big_x, big_v = torch.zeros(m), torch.ones(m)
    u = torch.full((m,), 2.0)
    while True:
        todo = ((u >= 1.0 - _f32(0.0331) * (big_x * big_x))
                & (xla_log(u) >= big_x * 0.5 + d * ((1.0 - big_v) + xla_log(big_v))))
        rows = np.flatnonzero(todo.numpy())
        if not len(rows):
            break
        keys[rows], x_keys, u_keys = split_keys(keys[rows], 3)
        x, v = torch.zeros(len(rows)), torch.full((len(rows),), -1.0)
        again = np.arange(len(rows))
        while len(again):
            x_keys[again], s = split_keys(x_keys[again], 2)
            x[again] = xla_erfinv(scalar_uniforms(s, _NORMAL_LO, 1.0)) * _SQRT2
            v[again] = _fma(x[again], c, 1.0)
            again = np.flatnonzero((v <= 0.0).numpy())
        big_x[rows], big_v[rows] = x * x, (v * v) * v
        u[rows] = scalar_uniforms(u_keys)
    out = xla_log(d) + xla_log(big_v)
    if not boost:
        log_u = xla_log1p(-scalar_uniforms(sub))
        out = out + torch.where(log_u == 0, 0.0, log_u * (1.0 / torch.tensor(a)))
    return out


def beta(k: Key, a: float, b: float, n: int, device="cpu") -> torch.Tensor:
    """``jax.random.beta(key, a, b, (n,))``, f32, bit for bit: log-Gamma
    draws of ``split(key)``'s two halves, each split in n, then exp(la -
    max) / (exp(la - max) + exp(lb - max)); on the host, then moved."""
    key_a, key_b = (np.asarray(split(h, n), np.int64) for h in split(k))
    la, lb = _log_gamma(key_a, a), _log_gamma(key_b, b)
    top = torch.maximum(la, lb)
    ga, gb = xla_exp(la - top), xla_exp(lb - top)
    return to_device(ga / (ga + gb), device)


def given(k: Optional[Key]) -> Key:
    """``k``, or where a caller gave none a key drawn from torch's global
    CPU generator (the draws torch's own default would take)."""
    if k is not None:
        return as_key(k)
    return key(int(torch.randint(0, 2**62, (), dtype=torch.int64)))


def scope_key(k: Key, path: Sequence[str], count: int) -> Key:
    """The key Flax's ``make_rng`` gives the ``count``-th draw (from 1) of
    a collection in the module scope at ``path``, under a root key ``k``
    (``flax/core/scope.py``: ``LazyRng``, ``_fold_in_static``): the path's
    names (UTF-8) and the count (its minimal big-endian bytes), with no
    separator, hashed by SHA-1, the digest's first four bytes folded in."""
    h = hashlib.sha1()
    for part in (*path, count):
        h.update(part.encode("utf-8") if isinstance(part, str)
                 else int(part).to_bytes((int(part).bit_length() + 7) // 8, "big"))
    return fold_in(k, int.from_bytes(h.digest()[:4], "big"))


def choice(k: Key, p: torch.Tensor) -> torch.Tensor:
    """``jax.random.choice(key, len(p), p=p)`` (with replacement, one
    draw): the first index whose cumulative sum reaches total x (1 - u),
    u a uniform on [0, 1); a device int64 scalar, no host read."""
    cum = torch.cumsum(p.float(), dim=0)
    u = to_device(uniform(k, ()), cum.device)
    return torch.searchsorted(cum, cum[-1] * (1.0 - u))


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on ``device`` without waiting: pinned, then copied
    asynchronously (the CPU's own tensor for the CPU).  Draws whose floats
    pass through a transcendental function (``exp``, ``log``, ``erfinv``:
    the card's differ from the CPU's in the last bit) are computed on the
    host and moved so, to stay the same on every device."""
    device = torch.device(device)
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def train_step_keys(k: Key, rank: Optional[int] = None) -> Tuple[Key, Key]:
    """(the state's next key, this step's key): ``key, step_key =
    split(key)``, then the rank folded into the step's key under data
    parallelism (``bacs_tpu/train/step.py:34-37``)."""
    nxt, step = split(k)
    return nxt, (step if rank is None else fold_in(step, rank))
