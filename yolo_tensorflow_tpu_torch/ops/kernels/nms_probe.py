"""Where the NMS kernel's time goes, on the card.

    python3 -m yolo_tensorflow_tpu_torch.ops.kernels.nms_probe

There is no Nsight on the card's machine, so this builds a copy of
``csrc/nms.cu`` (into ``_build/probe/``) whose ``// [stamp:k]`` comments,
k = 0..6 at the phase boundaries, become a ``clock64()`` read of each CTA's
thread 0, and runs it beside the kernel on seeded decodes of the main
paths' shapes at conf 0.5 (yolov3-416's N = 10647 at batch 64 and 1, also
with bf16-rounded scores; yolov2-416's 845 and yolov1-448's 98 at batch
64, K = 256, D = 20). It prints the kernel's device ms (CUDA events, host
kept ahead), an empty kernel's (the launch floor), and the copy's cycles
per phase, the mean over CTAs: keys (the score pass), select (the radix
passes), compact, rank (ranking and the candidates' loads), walk, out.
The phases follow each other in a CTA, so they add up to its time; the
copy's outputs are held equal to the kernel's. tests/test_torch_kernel_host.py
holds the stamps to the source.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

from yolo_tensorflow_tpu_torch.ops.kernels import build

PHASES = ("keys", "select", "compact", "rank", "walk", "out")
MAX_CTAS = 64
SPIN = 20_000_000                 # ~10 ms of the card: the host runs ahead

_STAMPED = """
__device__ long long nms_stamps[%d * 8];
""" % MAX_CTAS
_TAIL = """
__global__ void nms_empty_kernel() {}
extern "C" int yolo_nms_stamps(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, nms_stamps, sizeof(nms_stamps));
}
extern "C" int yolo_nms_empty(void* stream) {
  nms_empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def stamped_source() -> str:
    """csrc/nms.cu with each ``// [stamp:k]`` a clock64() read of thread 0
    into nms_stamps[blockIdx.x * 8 + k] (the first MAX_CTAS CTAs)."""
    text = (build.CSRC_DIR / "nms.cu").read_text()
    for k in range(len(PHASES) + 1):
        marker = f"// [stamp:{k}]"
        if text.count(marker) != 1:
            raise RuntimeError(f"csrc/nms.cu must hold {marker} once")
        text = text.replace(marker, (
            f"if (tid == 0 && blockIdx.x < {MAX_CTAS}) "
            f"nms_stamps[blockIdx.x * 8 + {k}] = clock64();"))
    return text.replace("namespace {", _STAMPED + "namespace {", 1) + _TAIL


def build_stamped() -> ctypes.CDLL:
    """nvcc on the stamped copy; its library, entry points declared."""
    work = build.BUILD_DIR / "probe"
    work.mkdir(parents=True, exist_ok=True)
    src, out = work / "nms_stamped.cu", work / "nms_stamped.so"
    src.write_text(stamped_source())
    cmd = [build.nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(out),
           str(src)]
    build._run(cmd, subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                     stderr=subprocess.PIPE, text=True))
    lib = ctypes.CDLL(str(out))
    lib.yolo_nms.argtypes, lib.yolo_nms.restype = build.SIGNATURES["yolo_nms"]
    lib.yolo_nms_stamps.argtypes = [ctypes.c_void_p]
    lib.yolo_nms_empty.argtypes = [ctypes.c_void_p]
    return lib


def seeded_decode(batch, n, dev, seed, bf16=False):
    """(boxes, scores, labels) like a decode's: xyxy boxes up to 0.4 wide
    around uniform centres, scores u^3 (about a fifth above 0.5), 80
    classes."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 1, (batch, n, 2))
    h = rng.uniform(0.01, 0.2, (batch, n, 2))
    boxes = torch.as_tensor(np.concatenate([c - h, c + h], -1),
                            dtype=torch.float32, device=dev)
    scores = torch.as_tensor(rng.uniform(0, 1, (batch, n)) ** 3,
                             dtype=torch.float32, device=dev)
    if bf16:
        scores = scores.to(torch.bfloat16).float()
    labels = torch.as_tensor(rng.integers(0, 80, (batch, n)),
                             dtype=torch.int32, device=dev)
    return boxes, scores, labels


def main() -> int:
    import numpy as np
    import torch
    from yolo_tensorflow_tpu_torch.ops.kernels import nms as NK
    from yolo_tensorflow_tpu_torch.utils.profiling import cuda_ms
    if not torch.cuda.is_available():
        print("nms_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True,
                         check=True).stdout.strip()
    lib = build_stamped()
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    kw = dict(conf_threshold=0.5, iou_threshold=0.45, max_detections=20,
              num_candidates=256, class_aware=False)
    floor = cuda_ms(lambda: lib.yolo_nms_empty(stream), 50, 3, SPIN)
    print(f"nms_probe on {smi}: an empty kernel {floor:.4f} ms")
    cases = (("yolov3-416 B=64", 64, 10647, False),
             ("yolov3-416 B=1", 1, 10647, False),
             ("yolov3-416 B=64 bf16 scores", 64, 10647, True),
             ("yolov2-416 B=64", 64, 845, False),
             ("yolov1-448 B=64", 64, 98, False))
    for seed, (label, batch, n, bf16) in enumerate(cases):
        decoded = seeded_decode(batch, n, dev, seed, bf16)
        want = NK.greedy_nms(*decoded, **kw)
        ms = cuda_ms(lambda: NK.greedy_nms(*decoded, **kw), 20, 3, SPIN)
        p = NK.plan(n, kw["num_candidates"], kw["max_detections"])
        out = NK._outputs(batch, kw["max_detections"], dev)
        err = lib.yolo_nms(*(t.data_ptr() for t in decoded), batch, n,
                           p.candidates, kw["max_detections"],
                           kw["conf_threshold"], kw["iou_threshold"], 0,
                           None, *(t.data_ptr() for t in out), stream)
        if err != 0:
            raise RuntimeError(f"the stamped copy failed: CUDA error {err}")
        torch.cuda.synchronize()
        for a, b in zip(out, want):
            if not torch.equal(a, b):
                raise RuntimeError(f"{label}: the stamped copy differs")
        stamps = np.zeros(MAX_CTAS * 8, np.int64)
        if lib.yolo_nms_stamps(stamps.ctypes.data) != 0:
            raise RuntimeError("reading the stamps failed")
        cycles = np.diff(stamps.reshape(MAX_CTAS, 8)[:min(batch, MAX_CTAS),
                                                     :7], axis=1).mean(0)
        active = int((decoded[1] > kw["conf_threshold"]).sum()) // batch
        print(f"{label}: {active} active an image; the kernel {ms:.4f} ms; "
              f"cycles a CTA: " + ", ".join(
                  f"{name} {c:.0f}" for name, c in zip(PHASES, cycles))
              + f", in all {cycles.sum():.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
