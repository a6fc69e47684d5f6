"""ctypes binding for the host batch decoder (``csrc/host/fastdecode.cpp``).

Port of ``bacs_tpu/data/native_decode.py``: a whole (image, label) batch
decoded in parallel C++ threads (JPEG/PNG decode, short-side resize,
center crop: ``datasets._load_pair``'s geometry).  The library is built at
first use with the build line the source documents (``-march=native``, the
command the JAX package's shipped ``native/libfastdecode.so`` was built
with; ``kernels/host_build.py`` says why), so the two packages decode a
folder tree to the same bytes.

As in JAX, a folder source decodes through this library when it builds and
through PIL when it does not (``datasets.FolderSource.load_batch``).  The
choice is reported, never silent: a failed build warns once with the
compiler's message, ``available()`` says which path a process takes, and
``decode_batch.launches`` counts the batches this process decoded natively
(the decode pool's workers count their own).
"""

from __future__ import annotations

import ctypes
import os
import warnings
from typing import Optional, Sequence, Tuple

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
        lib = ctypes.CDLL(str(host_build.build("fastdecode")))
    except Exception as e:
        warnings.warn(
            "the native batch decoder did not build, so folder sources decode "
            "with PIL, whose images differ from the native decoder's by up to 16 "
            f"levels (the JAX package decodes natively where it builds): {e}")
        return None
    p = ctypes.c_void_p
    lib.decode_batch.argtypes = [
        ctypes.c_char_p, p,  # image paths + offsets
        ctypes.c_char_p, p,  # label paths + offsets
        ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        p, p, p,
    ]
    lib.decode_batch.restype = ctypes.c_int
    _LIB = lib
    return _LIB


def available() -> bool:
    return _build_and_load() is not None


def _pack(paths: Sequence[str]) -> Tuple[bytes, np.ndarray]:
    offsets = np.zeros((len(paths),), np.int64)
    blobs = []
    pos = 0
    for i, p in enumerate(paths):
        b = os.fsencode(p) + b"\0"
        offsets[i] = pos
        blobs.append(b)
        pos += len(b)
    return b"".join(blobs), offsets


def decode_batch(
    img_paths: Sequence[str],
    lbl_paths: Sequence[str],
    size: int,
    n_threads: int = 0,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(images [n, s, s, 3] u8, labels [n, s, s] u8, failed [n] bool), or
    None when the library is unavailable.  Failed slots are zeroed: callers
    patch them through PIL.  ``n_threads`` 0 takes every hardware thread."""
    lib = _build_and_load()
    if lib is None:
        return None
    n = len(img_paths)
    img_blob, img_off = _pack(img_paths)
    lbl_blob, lbl_off = _pack(lbl_paths)
    imgs = np.zeros((n, size, size, 3), np.uint8)
    lbls = np.zeros((n, size, size), np.uint8)
    failed = np.zeros((n,), np.uint8)
    lib.decode_batch(
        img_blob, img_off.ctypes.data, lbl_blob, lbl_off.ctypes.data,
        n, size, n_threads,
        imgs.ctypes.data, lbls.ctypes.data, failed.ctypes.data,
    )
    decode_batch.launches += 1
    return imgs, lbls, failed.astype(bool)


decode_batch.launches = 0
