"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` file compiles into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes). No
flag relaxes IEEE float rounding (no --use_fast_math): the int8 conv's
quantize and epilogue must round as the JAX package does. The
library lands in ``yolo_tensorflow_tpu_torch/_build/`` under a name that
carries a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads as is. Nothing here runs at import: the first kernel
launch calls ``load()``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")


def sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libyolo_kernels-{h.hexdigest()[:16]}.so"


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                           "the CUDA kernels cannot be built")
    return path


def _run(cmd, proc):
    """Wait for one nvcc process; raise with its errors if it failed."""
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{err}")


def build(force: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into the shared library unless it is already
    built for these sources. Returns its path. Each source compiles in its
    own nvcc process, all started together; one more links them."""
    out = library_path()
    if out.exists() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        try:
            for src in sources():
                cmd = [nvcc(), *NVCC_FLAGS, "-c", str(src), "-o",
                       os.path.join(tmp, src.stem + ".o")]
                jobs.append((cmd, subprocess.Popen(
                    cmd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                    text=True)))
            for cmd, proc in jobs:
                _run(cmd, proc)
        finally:
            for _, proc in jobs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        lib = os.path.join(tmp, "lib.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-shared", "-o", lib,
               *(obj_cmd[-1] for obj_cmd, _ in jobs)]
        _run(cmd, subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                   stderr=subprocess.PIPE, text=True))
        os.replace(lib, out)          # atomic: no reader sees half a file
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """The kernels' library, built on first use, with every entry point's
    C signature declared."""
    lib = ctypes.CDLL(str(build()))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.yolo_decode_scale.argtypes = [vp, i, vp, vp, vp, i, i, i, i,
                                      ctypes.POINTER(ctypes.c_float), i, i, i,
                                      vp]
    lib.yolo_decode_scale.restype = i
    lib.yolo_conv2d_int8.argtypes = [vp, i, vp, ctypes.c_float, vp, vp, vp, i,
                                     i, i, i, i, i, i, i, i, i, i, vp]
    lib.yolo_conv2d_int8.restype = i
    lib.yolo_conv3x3_bnstat_tiles.argtypes = [i, i, i]
    lib.yolo_conv3x3_bnstat_tiles.restype = i
    lib.yolo_conv3x3_bnstat.argtypes = [vp, vp, vp, vp, vp, vp, vp, i, i, i,
                                        i, i, i, i, vp]
    lib.yolo_conv3x3_bnstat.restype = i
    return lib
