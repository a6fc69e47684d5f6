"""ctypes bindings for the host label-ops library (``csrc/host/fastlabel.cpp``).

Port of ``bacs_tpu/data/native.py``: the same entry points, signatures and
numpy fallbacks.  The library is built at first use (``kernels/
host_build.py``); where it does not build, each entry point takes its numpy
fallback (``unpack_bitplanes`` returns None, as JAX's does), the same
values, and the build's failure is warned once.
"""

from __future__ import annotations

import ctypes
import warnings
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build_and_load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    from bacs_tpu_torch.kernels import host_build

    try:
        lib = ctypes.CDLL(str(host_build.build("fastlabel")))
    except Exception as e:
        warnings.warn(f"the host label library did not build; numpy runs its ops: {e}")
        return None
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.class_presence.argtypes = [p, i64, i64, p]
    lib.remap_labels.argtypes = [p, p, i64, p]
    lib.class_histogram.argtypes = [p, i64, p]
    lib.resize_nearest_u8.argtypes = [p, i64, i64, p, i64, i64]
    lib.unpack_bitplanes.argtypes = [p, i64, i64, i64, i64, p]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _build_and_load() is not None


def class_presence(labels: np.ndarray) -> np.ndarray:
    """[N, ...] uint8 label maps -> [N, 256] bool presence matrix."""
    labels = np.ascontiguousarray(labels, np.uint8)
    n = labels.shape[0]
    per = int(labels.size // max(n, 1))
    lib = _build_and_load()
    if lib is not None:
        out = np.zeros((n, 256), np.uint8)
        lib.class_presence(labels.ctypes.data, n, per, out.ctypes.data)
        return out.astype(bool)
    out = np.zeros((n, 256), bool)
    flat = labels.reshape(n, -1)
    for i in range(n):
        out[i, np.unique(flat[i])] = True
    return out


def remap_labels(labels: np.ndarray, table: np.ndarray) -> np.ndarray:
    """``table[labels]`` as int32, for uint8 labels and a [256] table."""
    labels = np.ascontiguousarray(labels, np.uint8)
    table = np.ascontiguousarray(table, np.int32)
    lib = _build_and_load()
    if lib is not None:
        out = np.empty(labels.shape, np.int32)
        lib.remap_labels(labels.ctypes.data, table.ctypes.data, labels.size, out.ctypes.data)
        return out
    return table[labels]


def unpack_bitplanes(packed: np.ndarray, n: int, bits: int, groups: int,
                     w: int) -> Optional[np.ndarray]:
    """The serving wire format's unpack (``ops/bitpack.py``): [n, bits,
    groups, w] byte-planes -> [n, groups * 8, w] uint8; None without the
    library."""
    lib = _build_and_load()
    if lib is None:
        return None
    packed = np.ascontiguousarray(packed, np.uint8)
    out = np.empty((n, groups * 8, w), np.uint8)
    lib.unpack_bitplanes(packed.ctypes.data, n, bits, groups, w, out.ctypes.data)
    return out


def resize_nearest_u8(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """Nearest resize of a uint8 [sh, sw] map to [dh, dw] (source row
    ``i * sh // dh``)."""
    src = np.ascontiguousarray(src, np.uint8)
    sh, sw = src.shape
    lib = _build_and_load()
    if lib is not None:
        out = np.empty((dh, dw), np.uint8)
        lib.resize_nearest_u8(src.ctypes.data, sh, sw, out.ctypes.data, dh, dw)
        return out
    ys = (np.arange(dh) * sh // dh).astype(np.int64)
    xs = (np.arange(dw) * sw // dw).astype(np.int64)
    return src[ys][:, xs]
