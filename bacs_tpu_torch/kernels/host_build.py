"""Build the package's host (CPU) libraries with g++ and load them with ctypes.

The host data path has two C++ sources of its own, ``bacs_tpu_torch/csrc/
host/fastdecode.cpp`` (the batch image decoder) and ``fastlabel.cpp`` (label
ops), copies of the JAX package's ``native/`` sources, compiled so that
both packages decode and resize the same files to the same bytes:

    g++ -O3 -march=native -shared -fPIC bacs_tpu_torch/csrc/host/fastdecode.cpp \
        -o build/bacs_tpu_torch/libfastdecode_<hash>.so -ljpeg -lpng
    g++ -O3 -shared -fPIC bacs_tpu_torch/csrc/host/fastlabel.cpp \
        -o build/bacs_tpu_torch/libfastlabel_<hash>.so

A third source, ``fastdraw.cpp``, draws ``jax.random``'s normals and
truncated normals on the host for the initial weights (``ops/rng.py``),
with no multiply-add fused but the ones it writes as ``fma()``:

    g++ -O3 -march=native -ffp-contract=off -shared -fPIC -pthread \
        bacs_tpu_torch/csrc/host/fastdraw.cpp \
        -o build/bacs_tpu_torch/libfastdraw_<hash>.so

The decoder takes the build line its source documents
(``fastdecode.cpp:17-18``), the one the JAX package's shipped
``native/libfastdecode.so`` was built with: JAX loads that file as it is
unless the source is newer (``bacs_tpu/data/native_decode.py:31-42``).
The bilinear resize sums in floating point, so the flags decide its
rounding: ``-march=native`` lets the compiler fuse multiply-adds, and a
build without it differs from the shipped library by one level in about
one pixel in a million (measured on a VOC tree at 512²).  The label ops
are integer-only; they take JAX's own build command (``native.py:30-36``).

The build runs at first use, into ``build/bacs_tpu_torch/`` at the root of
the checkout (the CUDA library's directory, ``kernels/build.py``), keyed by
a hash of the source and the command (and, for ``-march=native``, of the
CPU), and never writes into ``native/``.
The sources sit under ``csrc/host/``, out of the nvcc build's
``csrc/*.cu`` glob.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

from bacs_tpu_torch.kernels.build import BUILD_DIR, CSRC_DIR

HOST_DIR = CSRC_DIR / "host"
GXX_FLAGS = {"fastdecode": ("-O3", "-march=native", "-shared", "-fPIC"),
             "fastlabel": ("-O3", "-shared", "-fPIC"),
             "fastdraw": ("-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC",
                          "-pthread")}
# libraries each source links, after the output as the JAX package orders them
LIBS = {"fastdecode": ("-ljpeg", "-lpng"), "fastlabel": (), "fastdraw": ()}
# seconds of each compile this process ran (none where the library was built)
build_seconds: dict = {}


def source(name: str) -> Path:
    return HOST_DIR / f"{name}.cpp"


def _cpu() -> bytes:
    """The host CPU's model and instruction-set flags (``/proc/cpuinfo``),
    which ``-march=native`` compiles for: a checkout copied to another
    machine builds its own library."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = [ln for ln in f.read().splitlines()
                     if ln.startswith((b"model name", b"flags"))]
        return b"\n".join(dict.fromkeys(lines))
    except OSError:
        import platform

        return platform.processor().encode()


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(("g++", *GXX_FLAGS[name], *LIBS[name])).encode())
    h.update(source(name).read_bytes())
    if "-march=native" in GXX_FLAGS[name]:
        h.update(_cpu())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/host/<name>.cpp`` unless its library exists; raises
    RuntimeError with the compiler's message when g++ is missing or fails
    (a missing ``jpeglib.h`` or ``png.h`` for the decoder)."""
    out = library_path(name)
    if out.is_file():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile under a private name and rename, so concurrent builds (the
    # decode pool's workers, data-parallel ranks) never load a half-written file
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [gxx, *GXX_FLAGS[name], str(source(name)), "-o", tmp, *LIBS[name]]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds[name] = time.perf_counter() - t0
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}): {' '.join(cmd)}\n"
                               f"{res.stderr.strip()}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def header_probe() -> dict:
    """{header: whether ``g++`` preprocesses ``#include <header>``} for the
    decoder's two image libraries' headers."""
    gxx = shutil.which("g++")
    out = {}
    for header in ("jpeglib.h", "png.h"):
        if gxx is None:
            out[header] = False
            continue
        res = subprocess.run([gxx, "-x", "c++", "-E", "-"], input=f"#include <{header}>\n",
                             capture_output=True, text=True)
        out[header] = res.returncode == 0
    return out
