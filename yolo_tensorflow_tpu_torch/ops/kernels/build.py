"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` file compiles into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes); the
``csrc/*.cuh`` headers they include (the shared wgmma main loop) are hashed
with them. No flag relaxes IEEE float rounding (no --use_fast_math): the
int8 conv's quantize and epilogue must round as the JAX package does. The
library lands in ``yolo_tensorflow_tpu_torch/_build/`` under a name that
carries a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads as is. Nothing here runs at import: the first kernel
launch calls ``load()``.

    python3 -m yolo_tensorflow_tpu_torch.ops.kernels.build [--sass PATTERN]

prints what ``nvcc -Xptxas -v`` says of every kernel (registers, spills,
static shared memory) and, with ``--sass``, the opcode counts of the kernels
whose name contains PATTERN: what to read when a kernel is off its bound.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import collections
import os
import re
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


def headers() -> list:
    return sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources, headers and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
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


VP, INT, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# every extern "C" entry point of csrc/*.cu: (argument types, result type)
SIGNATURES = {
    "yolo_decode": ([VP, VP, VP, INT, INT, INT, INT, INT, INT, INT, INT,
                     INT, VP, VP, VP, VP], INT),
    "yolo_quantize_act": ([VP, INT, VP, ctypes.c_longlong, F32, VP], INT),
    "yolo_conv2d_int8": ([VP, INT, VP, VP, F32, VP, VP, VP, INT, INT, INT,
                          INT, INT, INT, INT, INT, INT, INT, INT, INT, VP],
                         INT),
    "yolo_conv2d_int8_q": ([VP, VP, F32, VP, VP, VP, INT, F32, INT, INT,
                            INT, INT, INT, INT, INT, INT, INT, INT, INT, VP],
                           INT),
    "yolo_conv3x3_bnstat_tiles": ([INT, INT, INT], INT),
    "yolo_conv3x3_bnstat": ([VP, VP, VP, VP, VP, VP, VP, INT, INT, INT, INT,
                             INT, INT, INT, INT, VP], INT),
    "yolo_nms": ([VP, VP, VP, INT, INT, INT, F32, F32, INT, VP, VP, VP, VP,
                  VP, VP], INT),
}


@functools.cache
def load() -> ctypes.CDLL:
    """The kernels' library, built on first use, with every entry point's
    C signature declared."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def report(sass_pattern: str = None) -> str:
    """Registers, spills and static shared memory of every kernel as ptxas
    reports them, one line a kernel; with ``sass_pattern`` also the SASS
    opcode counts of the kernels whose name contains it (cuobjdump)."""
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        for src in sources():
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
                   "-o", obj]
            done = subprocess.run(cmd, capture_output=True, text=True)
            if done.returncode != 0:
                raise RuntimeError(f"nvcc failed ({done.returncode}):\n"
                                   f"{' '.join(cmd)}\n{done.stderr}")
            name, spills = "", ""
            for line in done.stderr.splitlines():
                entry = re.search(r"Compiling entry function '(\S+)'", line)
                if entry:
                    name = entry.group(1)
                elif "spill" in line:
                    spills = line.strip()
                elif "Used" in line:
                    filt = subprocess.run(["c++filt", "-p", name],
                                          capture_output=True, text=True)
                    lines.append(f"{src.name}: {filt.stdout.strip() or name}"
                                 f": {line.split(':', 1)[1].strip()}; "
                                 f"{spills}")
            if sass_pattern is None:
                continue
            dump = os.path.join(os.path.dirname(nvcc()), "cuobjdump")
            sass = subprocess.run([dump, "-sass", obj], capture_output=True,
                                  text=True, check=True).stdout
            counts = collections.defaultdict(collections.Counter)
            for line in sass.splitlines():
                fn = re.search(r"Function : (\S+)", line)
                if fn:
                    name = fn.group(1)
                op = re.match(r"\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\d+\s+)?"
                              r"([A-Z][A-Z0-9_]*)", line)
                if op and sass_pattern in name:
                    counts[name][op.group(1)] += 1
            for name, ops in counts.items():
                filt = subprocess.run(["c++filt", "-p", name],
                                      capture_output=True, text=True)
                lines.append(f"{src.name}: SASS of "
                             f"{filt.stdout.strip() or name}: "
                             f"{sum(ops.values())} instructions, "
                             f"{dict(ops.most_common(12))}")
    return "\n".join(lines)


if __name__ == "__main__":
    import argparse
    parser = argparse.ArgumentParser(description=report.__doc__)
    parser.add_argument("--sass", metavar="PATTERN", default=None)
    print(report(parser.parse_args().sass))
