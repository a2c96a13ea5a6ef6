"""ctypes binding to the repository's native batch-preprocessing kernel
(``native/yolodata.cpp``: crop, resize, HSV distortion and flip of a batch
of uint8 images on host threads).

The port's counterpart of yolo_tensorflow_tpu/data/native.py: the same
``Aug`` struct and the same ``yd_process_batch`` signature. It does not
load the prebuilt ``native/libyolodata.so`` (the host it runs on may not
link against it): the library is compiled from ``native/yolodata.cpp`` at
first use, with ``native/Makefile``'s flags, into the package's git-ignored
``_build/`` under a name that carries a hash of the source and flags, as
``ops/kernels/build.py`` does for the CUDA kernels. A failed build raises
with the compiler's output. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes as ct
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR.parent / "native" / "yolodata.cpp"
BUILD_DIR = PACKAGE_DIR / "_build"
# native/Makefile's CXXFLAGS and link step; no -ffast-math
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")


class Aug(ct.Structure):
    _fields_ = [("crop_x0", ct.c_int32), ("crop_y0", ct.c_int32),
                ("crop_w", ct.c_int32), ("crop_h", ct.c_int32),
                ("dhue", ct.c_float), ("dsat", ct.c_float),
                ("dexp", ct.c_float), ("flip", ct.c_int32)]


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libyolodata-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``native/yolodata.cpp`` unless it is built for this source.
    Raises RuntimeError with the compiler's output if the build fails."""
    out = library_path()
    if out.exists():
        return out
    if not SOURCE.exists():
        raise RuntimeError(f"{SOURCE} not found: the native loader is "
                           "built from the repository's native/ directory")
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or c++) on PATH; the native "
                           "loader cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = os.path.join(tmp, "lib.so")
        cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-o", lib]
        done = subprocess.run(cmd, capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"building the native loader failed "
                               f"({done.returncode}):\n{' '.join(cmd)}\n"
                               f"{done.stdout}{done.stderr}")
        os.replace(lib, out)          # atomic: no reader sees half a file
    return out


@functools.cache
def load_library() -> ct.CDLL:
    """The native library, built on first use, its entry points declared."""
    lib = ct.CDLL(str(build()))
    lib.yd_process_batch.argtypes = [
        ct.POINTER(ct.c_void_p), ct.POINTER(ct.c_int32),
        ct.POINTER(ct.c_int32), ct.c_int32, ct.POINTER(Aug),
        ct.c_void_p, ct.c_int32, ct.c_uint8, ct.c_int32]
    lib.yd_process_batch.restype = None
    lib.yd_version.argtypes = []
    lib.yd_version.restype = ct.c_int32
    return lib


def process_batch(images: Sequence[np.ndarray], augs: Sequence[dict],
                  out_size: int, *, pad: int = 128,
                  nthreads: int = 0) -> np.ndarray:
    """images: list of HWC RGB uint8 arrays; augs: per-image dicts with
    crop_x0/crop_y0/crop_w/crop_h/dhue/dsat/dexp/flip. Returns
    (N, out_size, out_size, 3) uint8."""
    lib = load_library()
    n = len(images)
    images = [np.ascontiguousarray(im, np.uint8) for im in images]
    for im in images:
        if im.ndim != 3 or im.shape[2] != 3:
            raise ValueError(f"images must be (H, W, 3) uint8, got "
                             f"{im.shape}")
    srcs = (ct.c_void_p * n)(*[im.ctypes.data_as(ct.c_void_p).value
                               for im in images])
    hs = (ct.c_int32 * n)(*[im.shape[0] for im in images])
    ws = (ct.c_int32 * n)(*[im.shape[1] for im in images])
    ca = (Aug * n)()
    for i, a in enumerate(augs):
        ca[i] = Aug(int(a["crop_x0"]), int(a["crop_y0"]), int(a["crop_w"]),
                    int(a["crop_h"]), float(a.get("dhue", 0.0)),
                    float(a.get("dsat", 1.0)), float(a.get("dexp", 1.0)),
                    int(a.get("flip", 0)))
    out = np.empty((n, out_size, out_size, 3), np.uint8)
    lib.yd_process_batch(
        ct.cast(srcs, ct.POINTER(ct.c_void_p)), hs, ws, n, ca,
        out.ctypes.data_as(ct.c_void_p), out_size, pad, nthreads)
    return out
