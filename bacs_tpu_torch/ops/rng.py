"""Counter-based random draws, the same bits on every device.

``jax.random``'s default generator, Threefry-2x32 with 20 rounds and
partitionable counters (JAX 0.9's default), written for torch.  A draw is a
function of its key and its shape alone: element i of ``bits(key, shape)``
is the xor of the two words of threefry2x32(key, (i >> 32, i & 0xFFFFFFFF)),
i the element's row-major index, so the CPU and the card draw the same
numbers from the same key, as a TPU and a CPU do in JAX.  A
``torch.Generator`` gives no such promise: a CUDA generator (Philox) and a
CPU one (mt19937) give different streams from one seed.

- A key is two uint32 words, a tuple of Python ints (``key(seed)``,
  ``split``, ``fold_in``: JAX's ``threefry_seed``, its fold-like split and
  ``fold_in``).  Keys live on the host and cost no device memory, launch or
  host read; a checkpoint saves them as they are.
- :func:`bits`, :func:`uniform`, :func:`normal`, :func:`bernoulli`,
  :func:`gumbel` and :func:`categorical` follow ``jax.random``'s rules:
  ``uniform`` puts the top 23 bits in a float's mantissa in [1, 2) and
  subtracts 1, then scales to [lo, hi) as u * (hi - lo) + lo rounded once
  (XLA fuses the two into a multiply-add; here the product is exact in f64
  and the sum is rounded to f64, then to f32, which differs from a fused
  f32 multiply-add only where the f64 sum falls on an f32 midpoint); ``normal`` is sqrt(2) erfinv of a
  uniform on (-1, 1) (torch's ``erfinv`` may differ from XLA's, and the
  card's from the CPU's, by an ulp); ``bernoulli`` is ``uniform < p``;
  ``gumbel`` is -log(-log(u)) of a uniform on [tiny, 1).
- :class:`KeyStream` hands out fold_in(key, 0), fold_in(key, 1), ...: the
  role a ``torch.Generator`` had on a draw path, where each draw takes the
  next key.  A train step's stream is keyed by (seed, step) and, under data
  parallelism, the rank, so a draw depends on (seed, step, its place among
  the step's draws, shape) and on nothing else.

On a CPU tensor the draws are the plain version, torch integer ops on int64
masked to 32 bits.  On a CUDA device :func:`bits`, :func:`uniform` and
:func:`bernoulli` launch the hand-written kernel of ``csrc/threefry.cu``
(``threefry_fill``) or raise: the detector's dropout mask, [16, 512, 32, 32]
at the main path's shapes, is too large to draw on the host and copy over.
The kernel replaces no TPU kernel: JAX draws with XLA's own threefry.
``threefry_fill.launches`` counts its launches.
"""

from __future__ import annotations

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
_TINY = float(np.finfo(np.float32).tiny)


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


def _bits_plain(k: Key, shape: Sequence[int], device) -> torch.Tensor:
    """The plain version: int64 [shape] in [0, 2^32), the xor of the two
    output words at counters (i >> 32, i & 0xFFFFFFFF)."""
    n = math.prod(shape)
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


def normal(k: Key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.normal(key, shape)``: sqrt(2) erfinv of a uniform on
    (-1, 1), f32."""
    return torch.erfinv(uniform(k, shape, _NORMAL_LO, 1.0, device)) * _SQRT2


def gumbel(k: Key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.gumbel(key, shape)``: -log(-log(u)), u on [tiny, 1)."""
    return -torch.log(-torch.log(uniform(k, shape, _TINY, 1.0, device)))


def categorical(k: Key, logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.random.categorical``: the Gumbel-max draw, argmax of logits
    plus Gumbel noise of the logits' shape along ``dim``."""
    return torch.argmax(gumbel(k, logits.shape, logits.device) + logits, dim=dim)


class KeyStream:
    """Successive keys fold_in(key, 0), fold_in(key, 1), ...: each draw on
    a path takes the next, so the draws follow from the stream's key and
    their order alone."""

    def __init__(self, k: Key):
        self.key = as_key(k)
        self.count = 0

    def next(self) -> Key:
        out = fold_in(self.key, self.count)
        self.count += 1
        return out


def stream_of(keys: Optional[KeyStream]) -> KeyStream:
    """``keys``, or where a caller gave none a stream keyed from torch's
    global CPU generator (the draws torch's own default would take)."""
    if keys is not None:
        return keys
    return KeyStream(key(int(torch.randint(0, 2**62, (), dtype=torch.int64))))


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


def step_key(k: Key, step: int, rank: Optional[int] = None) -> Key:
    """The key of a train step's draws: fold_in(key, step), and the rank
    folded in after it under data parallelism (JAX folds in the device's
    index, ``bacs_tpu/train/step.py:34-37``)."""
    out = fold_in(k, step)
    return out if rank is None else fold_in(out, rank)


