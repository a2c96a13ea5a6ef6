"""Where the direct int8 first-conv kernel's time goes, on the card.

    python3 -m yolo_tensorflow_tpu_torch.ops.kernels.direct_probe \\
        [--parent DIR] [--ablations noepi,nomma,nostore,noload,pack7,prof]

There is no Nsight on the card's machine, so this builds altered copies of
``csrc/conv_int8.cu`` (into ``_build/probe/``, each source with its own
nvcc, all at once) and times them beside the kernel, in turns (parent,
kernel, each copy, kernel, parent), at the four cases the main paths
launch: yolov3-416's first conv (3x3 s1, 3 -> 32) and yolov1-448's (7x7
s2, 3 -> 64), at the serving batch, bf16 in and out (``conv2d_int8``) and
int8 in and out (``conv2d_int8_q``). The source marks each place that a
copy alters with a comment line ``// [probe:NAME]``; a copy inserts its
text for NAME there (and nothing elsewhere). The copies:

- ``noepi``: each epilogue returns its accumulators' bits (its stores
  stay);
- ``nomma``: mma.sync replaced by an xor of its operands (their loads
  stay);
- ``nostore``: no global stores of the output;
- ``noload``: no global loads of the input (zeros are quantized);
- ``pack7``: K packed as (ky, kx, c) bytes at 7x7 too (147 bytes, 5 k32
  steps instead of 7; each A register two loads and a byte permute);
- ``prof``: the kernel with clock64() read between its phases, each warp's
  cycles in each phase summed over warps (lane 0's clock): the share of
  warp time each phase takes, the instrumentation included. "mma" is the
  products' issue and the shared-memory loads they wait for (their
  results are waited for in "epilogue").

A copy's time is the kernel's without that part, not that part's time:
the parts overlap. The results of ``noepi``, ``nomma``, ``nostore`` and
``noload`` are wrong by design and are not compared; ``pack7`` and
``prof`` are held to the kernel bit for bit. ``--parent DIR`` also builds
and times ``DIR/yolo_tensorflow_tpu_torch/csrc/conv_int8.cu``, an earlier
checkout of the repository unpacked with ``git archive`` (its C entry
points must take the same arguments). ``chip_smoke.py`` times the parent
the same way through ``start_build`` / ``finish_build`` / ``entry_calls``.
tests/test_torch_kernel_host.py holds every marker below to the source.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

from yolo_tensorflow_tpu_torch.ops.kernels import build

PROBE_DIR = build.BUILD_DIR / "probe"
SOURCE = "conv_int8.cu"
BATCH = 64                     # the serving batch

_RAW = """
struct RawPair {               // an epilogue's accumulators, as its result
  int a, b;
  __device__ operator float2() const {
    return make_float2(__int_as_float(a), __int_as_float(b));
  }
  __device__ operator char2() const {
    return make_char2(static_cast<char>(a), static_cast<char>(b));
  }
  __device__ operator __nv_bfloat162() const {
    __nv_bfloat162 r;
    r.x = __ushort_as_bfloat16(static_cast<unsigned short>(a));
    r.y = __ushort_as_bfloat16(static_cast<unsigned short>(b));
    return r;
  }
};
"""
_PROF_HEAD = """
__device__ unsigned long long direct_prof[8];
#define PROF_MARK(k) { const long long n_ = clock64(); \\
                       prof_[k] += n_ - prof_t_; prof_t_ = n_; }
"""
_PROF_TAIL = """
extern "C" int yolo_direct_prof(unsigned long long* out, int reset) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e != cudaSuccess) return e;
  if (reset) {
    const unsigned long long z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    return cudaMemcpyToSymbol(direct_prof, z, sizeof(z));
  }
  return cudaMemcpyFromSymbol(out, direct_prof, sizeof(direct_prof));
}
"""
# phases of ``prof``, by the index its marks add to
PHASES = ("stage next patch", "prefetch issue", "barrier", "mma",
          "epilogue", "store", "-", "setup")

# name -> {marker: the text inserted at each of its lines}
ABLATIONS = {
    "noepi": {"head": _RAW, "epilogue": "return RawPair{a0, a1};"},
    "nomma": {"mma": "d[0] += a[0] ^ a[1] ^ a[2] ^ a[3] ^ b0 ^ b1;\n"
                     "return;"},
    "nostore": {"store": "continue;"},
    "noload": {"load": "for (int e = 0; e < 3; ++e) v[e] = Tin();\n"
                       "return;"},
    "pack7": {"k-order": "return true;"},
    "prof": {"head": _PROF_HEAD,
             "begin": "long long prof_t_ = clock64();\n"
                      "long long prof_[8] = {0, 0, 0, 0, 0, 0, 0, 0};",
             **{f"phase{i}": f"PROF_MARK({i});" for i in (0, 1, 2, 3, 4, 5,
                                                          7)},
             "end": "if ((threadIdx.x & 31) == 0) {\n"
                    "  for (int k = 0; k < 8; ++k) {\n"
                    "    atomicAdd(&direct_prof[k],\n"
                    "              static_cast<unsigned long long>("
                    "prof_[k]));\n"
                    "  }\n}"},
}
# the copies whose results must equal the kernel's
EXACT = ("pack7", "prof")
# the four cases: (k, stride, Cout, H = W) and the two entries
CASES = ((3, 1, 32, 416), (7, 2, 64, 448))
ENTRIES = ("bf16 in/out", "int8 in/out")


def marker(name: str) -> str:
    return f"// [probe:{name}]"


def patched_source(ablation, csrc: Path = None) -> str:
    """conv_int8.cu with ``ablation``'s text inserted at its markers, each
    line indented as the marker; raises if a marker is not in the source.
    ``ablation`` names a copy of ABLATIONS, or is a copy's own mapping of
    marker to text (tools/int8_ablate.py keeps its copies so)."""
    texts = ABLATIONS[ablation] if isinstance(ablation, str) else ablation
    lines = ((csrc or build.CSRC_DIR) / SOURCE).read_text().split("\n")
    for name, text in texts.items():
        at = [i for i, line in enumerate(lines)
              if line.strip() == marker(name)]
        if not at:
            raise ValueError(f"{marker(name)} is not in {SOURCE}")
        for i in at:
            indent = lines[i][:len(lines[i]) - len(lines[i].lstrip())]
            lines[i] = "\n".join(indent + t for t in text.split("\n"))
    return "\n".join(lines) + (_PROF_TAIL if ablation == "prof" else "")


def start_build(name: str, csrc: Path = None, ablation=None,
                source: str = SOURCE):
    """Start nvcc on ``source`` alone (conv_int8.cu unless named; of
    ``csrc``, by default the package's; altered by ``ablation``, as
    ``patched_source`` takes it) into ``_build/probe/<name>.so``. Returns
    the job for finish_build."""
    csrc = Path(csrc or build.CSRC_DIR)
    work = PROBE_DIR / name
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(csrc, work)
    if ablation:
        (work / SOURCE).write_text(patched_source(ablation, csrc))
    out = PROBE_DIR / f"{name}.so"
    cmd = [build.nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(out),
           str(work / source)]
    return name, out, cmd, subprocess.Popen(
        cmd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)


def finish_build(job) -> ctypes.CDLL:
    """Wait for a start_build job; its library, the two conv entry points
    declared where it has them (and ``yolo_direct_prof`` where the copy has
    it)."""
    name, out, cmd, proc = job
    build._run(cmd, proc)
    lib = ctypes.CDLL(str(out))
    for entry in ("yolo_conv2d_int8", "yolo_conv2d_int8_q"):
        if hasattr(lib, entry):
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = build.SIGNATURES[entry]
    if hasattr(lib, "yolo_direct_prof"):
        lib.yolo_direct_prof.argtypes = [
            ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int]
        lib.yolo_direct_prof.restype = ctypes.c_int
    return lib


def case_operands(k, stride, cout, size, dev, seed):
    """Seeded operands of one case at BATCH: bf16 x, its int8 quantization
    xq (the int8-in entry's input), w_q, s_x, s_w, b, s_in, s_out."""
    import torch
    from yolo_tensorflow_tpu_torch.ops.kernels import conv_int8 as Q8
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn((BATCH, 3, size, size), generator=gen, device=dev)
         * 2).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    w_q = torch.randint(-127, 128, (cout, 3, k, k), generator=gen,
                        device=dev).to(torch.int8).contiguous(
                            memory_format=torch.channels_last)
    s_x = 4.0 / 127
    s_w = (torch.rand(cout, generator=gen, device=dev) + 0.5) / 127
    b = torch.randn(cout, generator=gen, device=dev)
    return dict(x=x, xq=Q8.quantize_act(x, s_x), w_q=w_q, s_x=s_x, s_w=s_w,
                b=b, s_in=0.02, s_out=0.9)


def entry_calls(ops, k, stride, lib=None):
    """The two entries' calls on ``ops``, leaky, bf16 out and int8 out:
    through the port's wrappers, or (``lib``) the launches of another build
    of the kernel."""
    import torch
    from yolo_tensorflow_tpu_torch.ops.kernels import conv_int8 as Q8
    o, pad = ops, k // 2
    if lib is None:
        return [lambda: Q8.conv2d_int8(
                    o["x"], o["w_q"], o["s_x"], o["s_w"], o["b"],
                    stride=stride, act="leaky",
                    epilogue_dtype=torch.bfloat16),
                lambda: Q8.conv2d_int8_q(
                    o["xq"], o["s_in"], o["w_q"], o["s_w"], o["b"],
                    stride=stride, act="leaky", s_out=o["s_out"])]
    return [lambda: Q8._launch(o["x"], o["w_q"], o["s_x"], o["s_w"], o["b"],
                               stride, pad, "leaky", torch.bfloat16, lib),
            lambda: Q8._launch_q(o["xq"], o["s_in"], o["w_q"], o["s_w"],
                                 o["b"], stride, pad, "leaky", o["s_out"],
                                 lib)]


def main(argv=None) -> int:
    import torch
    from yolo_tensorflow_tpu_torch.utils.profiling import cuda_ms
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", default=None)
    parser.add_argument("--ablations", default=",".join(ABLATIONS))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("direct_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    names = [a for a in args.ablations.split(",") if a]
    jobs = [start_build(a, ablation=a) for a in names]
    if args.parent:
        jobs.append(start_build("parent", Path(args.parent)
                                / "yolo_tensorflow_tpu_torch" / "csrc"))
    build.build()
    build.load()
    libs = {job[0]: finish_build(job) for job in jobs}
    dev = torch.device("cuda", 0)
    for i, (k, stride, cout, size) in enumerate(CASES):
        ops = case_operands(k, stride, cout, size, dev, 12 + i)
        calls = {"kernel": entry_calls(ops, k, stride)}
        for name, lib in libs.items():
            calls[name] = entry_calls(ops, k, stride, lib)
            if name in EXACT or name == "parent":
                for want, got in zip(calls["kernel"], calls[name]):
                    if not torch.equal(got(), want()):
                        raise SystemExit(f"direct_probe: {name} differs "
                                         f"from the kernel at k{k}")
        others = [n for n in calls if n not in ("kernel", "parent")]
        order = (["parent"] * ("parent" in calls) + ["kernel"] + others
                 + ["kernel"] + ["parent"] * ("parent" in calls))
        for e, entry in enumerate(ENTRIES):
            times = [(n, cuda_ms(calls[n][e], iters=30)) for n in order]
            print(f"[direct probe] k{k} s{stride} 3->{cout} at {size}^2 "
                  f"B={BATCH} {entry}: "
                  + ", ".join(f"{n} {ms:.4f}" for n, ms in times)
                  + f" ms; on {smi}", flush=True)
            if "prof" in libs:
                buf = (ctypes.c_ulonglong * 8)()
                libs["prof"].yolo_direct_prof(buf, 1)
                for _ in range(5):
                    calls["prof"][e]()
                libs["prof"].yolo_direct_prof(buf, 0)
                tot = sum(buf) or 1
                print(f"[direct probe] k{k} {entry} warp time by phase: "
                      + ", ".join(f"{p} {100 * c / tot:.1f}%"
                                  for p, c in zip(PHASES, buf) if p != "-"),
                      flush=True)
    print("[direct probe] ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
