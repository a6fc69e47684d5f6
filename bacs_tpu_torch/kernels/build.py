"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Every ``bacs_tpu_torch/csrc/*.cu`` file is compiled on its own, all at once
in parallel, and the objects are linked into one shared library with a
plain C interface (no PyTorch headers to compile).  One nvcc per source
keeps the build at its slowest file's time rather than the sum of all, as
each ported kernel adds a source and ``chip_smoke.py`` builds them all
inside a fixed time limit; so a source that instantiates many templates
is split (the upsample+loss family: one source per loss on
``upsample_ce.cuh``).  ``build(verbose=True)`` prints each file's compile
time:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c -o <stem>.o bacs_tpu_torch/csrc/<stem>.cu  # each
    nvcc -shared -o build/bacs_tpu_torch/libbacs_kernels_<hash>.so *.o

The build runs at first use, into ``build/bacs_tpu_torch/`` at the root of
the checkout, keyed by a hash of the sources and the flags, so an edited
source rebuilds and an unchanged one is loaded as it is.  Wrappers pass
pointers (``tensor.data_ptr()``) and PyTorch's current stream as
``ctypes.c_void_p``; each C entry point returns ``cudaGetLastError()`` of
its launch, and :func:`check` raises on a nonzero code.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "bacs_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_FAMILY = [_P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I]
_PLAN = [_P, _I, _I, _I, _I]
_PAIR = [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F]
# C signature of every entry point in csrc/, declared before first use
SIGNATURES = {
    # (sem, sem_is_bf16, n, h, w, c, H, W, the launch plan (tables, band,
    #  tile, span, rows), preds, conf, stream)
    "upsample_argmax_conf": [_P, _I, _I, _I, _I, _I, _I, _I] + _PLAN + [_P, _P, _P],
    # the upsample+loss family (K1, K3, K4, K6, K7, K8): the problem
    # (sem, sem_is_bf16, labels, labels_are_i64, n, h, w, c, H, W,
    # ignore_index), the term's arguments, then the launch plan (tables,
    # band, tile, span, rows) and the outputs
    # (problem, plan, partials, loss_out, count_out, stream)
    "upsample_ce_sums": _FAMILY + _PLAN + [_P, _P, _P, _P],
    # (problem, g, plan, partials, dsem, stream)
    "upsample_ce_grad": _FAMILY + [_P] + _PLAN + [_P, _P, _P],
    # (problem, weights, plan, partials, loss_out, wsum_out, stream)
    "upsample_wce_sums": _FAMILY + [_P] + _PLAN + [_P, _P, _P, _P],
    # (problem, weights, g, plan, partials, dsem, stream)
    "upsample_wce_grad": _FAMILY + [_P, _P] + _PLAN + [_P, _P, _P],
    # (problem, max_seen, old_classes, ukd, gamma, threshold, plan,
    #  partials, loss_out, count_out, stream)
    "upsample_bacs_sum": _FAMILY + [_P, _I, _I, _F, _F] + _PLAN + [_P, _P, _P, _P],
    # (problem, max_seen, old_classes, ukd, gamma, threshold, g, plan,
    #  partials, dsem, stream)
    "upsample_bacs_grad": _FAMILY + [_P, _I, _I, _F, _F, _P] + _PLAN + [_P, _P, _P],
    # (sem, sem_is_bf16, labels, labels_are_i64, n, h, w, c, H, W,
    #  num_classes, plan, conf, stream)
    "upsample_confusion": _FAMILY + _PLAN + [_P, _P],
    # (problem, g [n], plan, partials, dsem, stream)
    "upsample_ce_grad_per_image": _FAMILY + [_P] + _PLAN + [_P, _P, _P],
    # (problem, old_classes, plan, partials, loss_out, count_out, stream)
    "upsample_uce_sums": _FAMILY + [_I] + _PLAN + [_P, _P, _P, _P],
    # (problem, old_classes, g, plan, partials, dsem, stream)
    "upsample_uce_grad": _FAMILY + [_I, _P] + _PLAN + [_P, _P, _P],
    # K7, no labels: (pair, plan, partials, t_out, count_out, stream), pair =
    # (sem, sem_old, sem_is_bf16, n, h, w, c, c_old, H, W, alpha)
    "upsample_ukd_sum": _PAIR + _PLAN + [_P, _P, _P, _P],
    # (pair, g, plan, partials, dsem, stream)
    "upsample_ukd_grad": _PAIR + [_P] + _PLAN + [_P, _P, _P],
    # (problem, thresholds, max_entropy, ent_scale, plan, out, counts, stream)
    "upsample_plop_pseudo": _FAMILY + [_P, _P, _F] + _PLAN + [_P, _P, _P],
    # (k0, k1, n, mode, lo, span, p, out, stream)
    "threefry_fill": [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_longlong, _I, _F, _F, _F,
                      _P, _P],
    # (x, is_bf16, n, h, w, C, H, W, ytab, ylam, xtab, xlam, out, stream)
    "resize_bilinear_fwd": [_P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    # (g, is_bf16, n, h, w, C, H, W, yoff, ysrc, yw, xoff, xsrc, xw, t, dx,
    #  stream)
    "resize_bilinear_grad": [_P, _I, _I, _I, _I, _I, _I, _I] + [_P] * 9,
    # (c, is_bf16, vec [2, C], slope, n, H, W, C, p, stream)
    "stem_pool_fwd": [_P, _I, _P, _F, _I, _I, _I, _I, _P, _P],
    # (c, dap, is_bf16, vec [7, C], slope, n, H, W, C, dc, stream)
    "stem_pool_grad": [_P, _P, _I, _P, _F, _I, _I, _I, _I, _P, _P],
}


def find_nvcc() -> str | None:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))  # the toolkit's default
    for c in candidates:
        if c.is_file():
            return str(c)
    return None


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libbacs_kernels_{source_hash()}.so"


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu unless the library for these sources exists."""
    out = library_path()
    if out.is_file():
        return out
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
            "kernels of bacs_tpu_torch are built from source at first use"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    ptxas = ["-Xptxas", "-v"] if verbose else []
    # compile and link under a private directory and rename, so concurrent
    # builders never load a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        srcs = sorted(CSRC_DIR.glob("*.cu"))
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in srcs]
        cmds = [[nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", obj, str(src)]
                for src, obj in zip(srcs, objs)]
        # leaving the pool waits for every compiler before a failure is raised
        with ThreadPoolExecutor(len(cmds)) as pool:
            compiled = list(pool.map(_nvcc, cmds))
        lib = str(Path(tmp) / "lib.so")
        _nvcc([nvcc, "-shared", "-o", lib, *objs])
        os.replace(lib, out)
    if verbose:
        for src, (log, secs) in zip(srcs, compiled):
            print(f"{log}nvcc {src.name}: {secs:.2f} s")
    return out


def _nvcc(cmd: list[str]) -> tuple[str, float]:
    """Run one nvcc command; returns its stderr (ptxas's report) and its
    seconds, or raises with them."""
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
                           f"{res.stderr}")
    return res.stderr, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(code: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {code}")
