"""The int8 backbone under five conv-epilogue formulations, on the card.

The port's counterpart of tools/int8_ablate.py: yolov3-416's backbone and
heads (no decode, no NMS) at batch 256, 8 chained iterations, folded seeded
weights (``engine.init_params``, ``io.weights.fold_params``), the input
scale 0.05 for every conv and ``ops.quant.quantize_params``, which keeps
the head convs float. Each row runs the same engine walk with another
quantized conv (``walk``); the rows, under the reference's names and in its
order:

- ``bf16-ref``: w_q as bfloat16, a cuDNN bf16 conv, then the bias and
  leaky in float32 and the result rounded to bf16 (the reference computes
  it with lax.conv outside any Pallas kernel);
- ``int8-v0-f32-epilogue``: ``conv2d_int8`` with the linear bf16 epilogue
  (the reference's default epilogue is bf16 too; the name is its own),
  then leaky as a separate pass;
- ``int8-v1-bf16-epilogue``: ``conv2d_int8`` with leaky fused into the
  bf16 epilogue, the call ``engine.QuantConv`` makes;
- ``int8-v2-folded``: y = f32(acc) + b/s, leaky in float32, y * s rounded
  once to bf16 (s = s_x * s_w; b/s divided once a layer);
- ``int8-SOL-no-epilogue``: the input cast to int8 (no quantize), the int8
  conv, the accumulator clamped to +-127 as int8: no scale, bias or
  activation; the shortcuts add int8 and wrap, the heads take int8 input.

v2 and SOL run two altered builds of the hand kernel, ``folded`` and
``sol`` (COPIES): ops/kernels/direct_probe.py's mechanism writes
``_build/probe/<name>.so``, each copy inserting its text at the source's
``// [probe:head]`` and ``// [probe:epilogue]`` markers (the latter opens
all three epilogue overloads, so each copy returns a small struct that
converts to each output type), launched through
``conv_int8._launch(..., lib)`` and ``_launch_q(..., lib)``. They are
formulations for measurement, not kernels of a serving path; on a CPU
tensor each runs its plain version (``folded_plain``, ``sol_plain``).
``check_copies`` holds each copy to its plain version exactly, at one
conv of each distinct kernel instance, tile, kernel size and stride that
the walk gives it.

Each row is measured as the reference measures it: a chained call runs
``iters`` forwards, each iteration's uint8 input shifted by int(sum of the
outputs) % 2 (``chain_step``); one warm call, then one timed call ending
in the sum's readback. The host clock gives img/s, CUDA events the
device time of an iteration (the backbone's ms).

Usage:  python -m yolo_tensorflow_tpu_torch.tools.int8_ablate
            [model [size [device [batch [iters]]]]]
(defaults yolov3 416 cuda 256 8). On ``device`` cpu every conv runs its
plain version and the times are the CPU's host clock. The last line is
the table as one JSON object.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

BATCH = 256
ITERS = 8
ACT_SCALE = 0.05                # every conv's input scale (the reference's)
ROWS = ("bf16-ref", "int8-v0-f32-epilogue", "int8-v1-bf16-epilogue",
        "int8-v2-folded", "int8-SOL-no-epilogue")

_HEAD = """
// tools/int8_ablate.py's copies: an epilogue's pair, converted to each
// output type (only the bf16 one of "folded" and the int8 one of "sol" are
// measured; the others make the three overloads compile)
struct FoldedPair {            // y = leaky(f32(acc) + b/s), out y * s
  float y0, y1, s0, s1;
  __device__ operator __nv_bfloat162() const {
    return __floats2bfloat162_rn(__fmul_rn(y0, s0), __fmul_rn(y1, s1));
  }
  __device__ operator float2() const {
    return make_float2(__fmul_rn(y0, s0), __fmul_rn(y1, s1));
  }
  __device__ operator char2() const { return make_char2(0, 0); }
};
__device__ __forceinline__ float folded_leaky(float y, int leaky,
                                              float alpha) {
  return leaky ? fmaxf(y, __fmul_rn(alpha, y)) : y;
}
struct SolPair {               // the accumulators, clamped to int8
  int a, b;
  __device__ operator char2() const {
    return make_char2(static_cast<signed char>(max(-127, min(127, a))),
                      static_cast<signed char>(max(-127, min(127, b))));
  }
  __device__ operator float2() const {
    return make_float2(__int2float_rn(a), __int2float_rn(b));
  }
  __device__ operator __nv_bfloat162() const {
    return __floats2bfloat162_rn(__int2float_rn(a), __int2float_rn(b));
  }
};
"""
# copy name -> {marker: the text inserted at each of its lines}; at the
# epilogue markers a0, a1 (accumulators), sc (s_x * s_w), b (the bias: b/s
# for "folded") and p (p.leaky) are the overload's arguments
COPIES = {
    "folded": {"head": _HEAD, "epilogue": (
        "return FoldedPair{\n"
        "    folded_leaky(__fadd_rn(__int2float_rn(a0), b.x), p.leaky, "
        "kAlpha),\n"
        "    folded_leaky(__fadd_rn(__int2float_rn(a1), b.y), p.leaky, "
        "kAlpha),\n"
        "    sc.x, sc.y};")},
    "sol": {"head": _HEAD, "epilogue": "return SolPair{a0, a1};"},
}
# launches of each copy (the production kernel's counts stay conv_int8's)
launches = {name: 0 for name in COPIES}
_libs = {}


def start_copies() -> list:
    """Start one nvcc for each copy, all at once (into _build/probe/);
    ``finish_copies`` waits for them. ``chip_smoke.py`` starts them beside
    the package's own build."""
    from yolo_tensorflow_tpu_torch.ops.kernels import direct_probe as DP
    return [DP.start_build(name, ablation=texts)
            for name, texts in COPIES.items()]


def finish_copies(jobs) -> dict:
    """Wait for ``start_copies``' jobs; {name: library} of the copies."""
    from yolo_tensorflow_tpu_torch.ops.kernels import direct_probe as DP
    for job in jobs:
        _libs[job[0]] = DP.finish_build(job)
    return _libs


def copy_libs() -> dict:
    """{name: ctypes library} of the two copies, built at first use."""
    return _libs if len(_libs) == len(COPIES) else finish_copies(
        start_copies())


# ------------------------------------------------------------ the two copies

def _column(v):
    return v.reshape(1, -1, 1, 1)


def folded_plain(x, w_q, s_x, s_w, b_over_s, *, stride=1, pad=None,
                 act="linear"):
    """Plain PyTorch version of the ``folded`` copy, on any device: x
    quantized with s_x as the kernel does, the exact accumulator, y =
    f32(acc) + b_over_s, leaky max(y, 0.1 * y) in float32, y * (s_x * s_w)
    rounded once to bf16; channels-last (B, Cout, Ho, Wo)."""
    import torch
    from yolo_tensorflow_tpu_torch.ops import layers as L
    from yolo_tensorflow_tpu_torch.ops.kernels import conv_int8 as Q8
    pad = w_q.shape[-1] // 2 if pad is None else pad
    acc = Q8.int8_accumulate(Q8.quantize_act_plain(x, s_x), w_q,
                             stride=stride, pad=pad).float()
    y = acc + _column(b_over_s)
    if act == "leaky":
        y = L.leaky_relu(y)
    s = Q8._full(s_x, x.device) * s_w
    return (y * _column(s)).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)


def sol_plain(xq, w_q, *, stride=1, pad=None):
    """Plain PyTorch version of the ``sol`` copy, on any device: the exact
    int32 accumulator of int8 xq and w_q clamped to +-127, as int8."""
    import torch
    from yolo_tensorflow_tpu_torch.ops.kernels import conv_int8 as Q8
    pad = w_q.shape[-1] // 2 if pad is None else pad
    acc = Q8.int8_accumulate(xq, w_q, stride=stride, pad=pad)
    return torch.clamp(acc, -127, 127).to(torch.int8).contiguous(
        memory_format=torch.channels_last)


def folded_conv(x, w_q, s_x, s_w, b_over_s, *, stride=1, pad=None,
                act="linear"):
    """The ``folded`` formulation: the copy's launch on a CUDA x (bf16
    out), ``folded_plain`` on a CPU one."""
    import torch
    from yolo_tensorflow_tpu_torch.ops.kernels import conv_int8 as Q8
    pad = w_q.shape[-1] // 2 if pad is None else pad
    Q8._check(x, w_q, s_w, b_over_s, stride, pad, act, torch.bfloat16)
    if x.device.type == "cpu":
        return folded_plain(x, w_q, s_x, s_w, b_over_s, stride=stride,
                            pad=pad, act=act)
    y = Q8._launch(x, w_q, float(s_x), s_w, b_over_s, stride, pad, act,
                   torch.bfloat16, copy_libs()["folded"])
    launches["folded"] += 1
    return y


def sol_conv(xq, w_q, s_w, b, *, stride=1, pad=None):
    """The ``sol`` formulation: the copy's launch through the int8-in
    entry on a CUDA xq (its scales, bias and activation unused), int8 out;
    ``sol_plain`` on a CPU one."""
    import torch
    from yolo_tensorflow_tpu_torch.ops.kernels import conv_int8 as Q8
    pad = w_q.shape[-1] // 2 if pad is None else pad
    Q8._check(xq, w_q, s_w, b, stride, pad, "linear", torch.float32,
              x_dtypes=(torch.int8,))
    if xq.device.type == "cpu":
        return sol_plain(xq, w_q, stride=stride, pad=pad)
    y = Q8._launch_q(xq, 1.0, w_q, s_w, b, stride, pad, "linear", 1.0,
                     copy_libs()["sol"])
    launches["sol"] += 1
    return y


# ------------------------------------------------------------ the five rows

def prepare(specs, qparams, device) -> dict:
    """``quantize_params``' output as tensors on ``device``
    (``ops.quant.int8_params_to``), and for each conv its weights as bf16
    (w_q's values for a quantized conv, as the reference's bf16 row takes
    them) and, for a quantized one, b / (s_x * s_w) in float32."""
    import torch
    from yolo_tensorflow_tpu_torch.ops import quant as Q
    from yolo_tensorflow_tpu_torch.ops.kernels import conv_int8 as Q8
    qp = Q.int8_params_to(qparams, device)
    for p in qp.values():
        if "w_q" in p:
            p["w_bf16"] = p["w_q"].to(torch.bfloat16)
            p["b_over_s"] = p["b"] / (Q8._full(p["s_x"], device) * p["s_w"])
        elif "w" in p and p["w"].dim() == 4:
            p["w_bf16"] = p["w"].to(torch.bfloat16)
    return qp


def float_conv(x, w, b, stride, pad, act):
    """A bf16 conv with a float32 result: x and w as bf16, cuDNN's conv,
    then the bias and leaky in float32, rounded to bf16 (the reference's
    ``L.conv2d(..., compute_dtype=bfloat16)``, leaky, cast)."""
    import torch
    import torch.nn.functional as F
    y = F.conv2d(x.to(torch.bfloat16), w, stride=stride, padding=pad)
    y = y + _column(b)                  # bf16 + float32 b: float32
    if act == "leaky":
        F.leaky_relu_(y, 0.1)           # max(y, 0.1 * y) in float32
    return y.to(torch.bfloat16)


def _conv_bf16_ref(x, p, spec, pad):
    return float_conv(x, p["w_bf16"], p["b"], spec.stride, pad, spec.act)


def _leaky(spec):
    return "leaky" if spec.act == "leaky" else "linear"


def _conv_v0(x, p, spec, pad):
    import torch
    from yolo_tensorflow_tpu_torch.ops import layers as L
    from yolo_tensorflow_tpu_torch.ops.kernels import conv_int8 as Q8
    y = Q8.conv2d_int8(x, p["w_q"], p["s_x"], p["s_w"], p["b"],
                       stride=spec.stride, pad=pad,
                       epilogue_dtype=torch.bfloat16)
    return L.leaky_relu(y) if spec.act == "leaky" else y


def _conv_v1(x, p, spec, pad):
    import torch
    from yolo_tensorflow_tpu_torch.ops.kernels import conv_int8 as Q8
    return Q8.conv2d_int8(x, p["w_q"], p["s_x"], p["s_w"], p["b"],
                          stride=spec.stride, pad=pad, act=_leaky(spec),
                          epilogue_dtype=torch.bfloat16)


def _conv_v2(x, p, spec, pad):
    return folded_conv(x, p["w_q"], p["s_x"], p["s_w"], p["b_over_s"],
                       stride=spec.stride, pad=pad, act=_leaky(spec))


def _conv_sol(x, p, spec, pad):
    import torch
    if x.dtype != torch.int8:
        x = x.to(torch.int8)            # a cast: truncation toward zero
    return sol_conv(x, p["w_q"], p["s_w"], p["b"], stride=spec.stride,
                    pad=pad)


CONVS = dict(zip(ROWS, (_conv_bf16_ref, _conv_v0, _conv_v1, _conv_v2,
                        _conv_sol)))


def walk(cfg, specs, qp, row):
    """images uint8 (B, S, S, 3) -> the head convs' outputs, channels-last
    (the reference's ``apply_with``): bf16 normalized input, each quantized
    conv by ``row``'s formulation, the head convs by ``float_conv``. Only
    the outputs that a later route or shortcut reads are kept. A layer of
    another type than those it walks raises NotImplementedError."""
    import torch
    from yolo_tensorflow_tpu_torch.models import engine
    from yolo_tensorflow_tpu_torch.models import specs as S
    from yolo_tensorflow_tpu_torch.ops import layers as L
    from yolo_tensorflow_tpu_torch.pipeline import normalize_images
    conv = CONVS[row]
    handled = (S.Conv, S.MaxPool, S.Route, S.Shortcut, S.Upsample, S.Detect)
    keep = set()
    for i, spec in enumerate(specs):
        if not isinstance(spec, handled):
            raise NotImplementedError(
                f"int8_ablate walks {[t.__name__ for t in handled]} only; "
                f"layer {i} is a {type(spec).__name__}")
        if isinstance(spec, S.Route):
            keep |= {S.resolve_ref(r, i) for r in spec.refs}
        elif isinstance(spec, S.Shortcut):
            keep.add(S.resolve_ref(spec.ref, i))

    def fwd(images):
        cur = normalize_images(images, cfg, torch.bfloat16)
        outputs, heads = {}, []
        for i, spec in enumerate(specs):
            if isinstance(spec, S.Conv):
                p = qp[engine.layer_key(i)]
                pad = spec.size // 2 if spec.pad < 0 else spec.pad
                cur = cur.contiguous(memory_format=torch.channels_last)
                cur = (conv(cur, p, spec, pad) if "w_q" in p else
                       float_conv(cur, p["w_bf16"], p["b"], spec.stride,
                                  pad, spec.act))
            elif isinstance(spec, S.MaxPool):
                cur = L.max_pool(cur, spec.size, spec.stride)
            elif isinstance(spec, S.Route):
                ts = [outputs[S.resolve_ref(r, i)] for r in spec.refs]
                cur = ts[0] if len(ts) == 1 else torch.cat(ts, dim=1)
            elif isinstance(spec, S.Shortcut):
                cur = cur + outputs[S.resolve_ref(spec.ref, i)]
            elif isinstance(spec, S.Upsample):
                cur = L.upsample_nearest(cur, spec.factor)
            elif isinstance(spec, S.Detect):
                heads.append(cur)
            if i in keep:
                outputs[i] = cur
        return heads
    return fwd


def next_images(images, s):
    """The reference's chained input: images + uint8(int32(s) % 2), the
    sum truncated toward zero, the remainder Python's, the add wrapping
    as uint8 does."""
    import torch
    return images + (s.to(torch.int32) % 2).to(torch.uint8)


def chain_step(fwd, images, acc):
    """One iteration of the reference's chained loop: (images, acc) ->
    (the next images, acc + the float32 sum of the outputs)."""
    import torch
    s = sum(o.to(torch.float32).sum() for o in fwd(images))
    return next_images(images, s), acc + s


def measure(fwd, images, iters) -> dict:
    """One warm chained call of ``iters`` iterations, then one timed one
    ending in the sum's readback: img/s and seconds on the host clock,
    ms an iteration between CUDA events on the card (None on the CPU)."""
    import torch
    cuda = images.device.type == "cuda"

    def chained():
        im = images
        acc = torch.zeros((), dtype=torch.float32, device=images.device)
        for _ in range(iters):
            im, acc = chain_step(fwd, im, acc)
        return acc

    float(chained())
    if cuda:
        torch.cuda.synchronize(images.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    acc = chained()
    if cuda:
        end.record()
    total = float(acc)
    dt = time.perf_counter() - t0
    return {"img_s": images.shape[0] * iters / dt, "host_s": dt,
            "device_ms": (start.elapsed_time(end) / iters if cuda
                          else None), "sum": total}


def model_params(model, size, device):
    """(cfg, specs, qp): the seeded folded weights, every conv at
    ACT_SCALE, quantized (heads float), as tensors on ``device``."""
    from yolo_tensorflow_tpu_torch import config as C
    from yolo_tensorflow_tpu_torch.io.weights import fold_params
    from yolo_tensorflow_tpu_torch.models import engine
    from yolo_tensorflow_tpu_torch.models import specs as S
    from yolo_tensorflow_tpu_torch.ops import quant as Q
    cfg = C.get_config(model, input_size=size)
    specs = C.build_specs(cfg)
    params, stats = engine.init_params(specs, size, 0)
    folded = fold_params(params, stats, cfg.bn_eps)
    scales = {engine.layer_key(i): ACT_SCALE
              for i, sp in enumerate(specs) if isinstance(sp, S.Conv)}
    return cfg, specs, prepare(specs, Q.quantize_params(specs, folded,
                                                        scales), device)


def copy_cases(specs, qp, size) -> list:
    """The convs ``check_copies`` takes: for each copy, the first quantized
    conv of the walk at each distinct (instance, BN, kernel size, stride,
    activation) that the copy launches there (the instance and BN from
    ``conv_int8.plan`` for ``folded``'s bf16 out and ``plan_q`` for
    ``sol``'s int8 out, on operands as fresh as the walk's). A list of
    (copy, layer, Cin, input height, (instance, BN))."""
    import torch
    from yolo_tensorflow_tpu_torch.models import engine
    from yolo_tensorflow_tpu_torch.models import specs as S
    from yolo_tensorflow_tpu_torch.ops.kernels import conv_int8 as Q8
    shapes = engine.infer_shapes(specs, (1, size, size, 3))
    seen, out = set(), []
    for i, spec in enumerate(specs):
        p = qp.get(engine.layer_key(i), {})
        if not (isinstance(spec, S.Conv) and "w_q" in p):
            continue
        cin, h = (shapes[i - 1][3], shapes[i - 1][1]) if i else (3, size)
        fresh = torch.empty(16, dtype=torch.int8, device=p["w_q"].device)
        plans = {"folded": Q8.plan(fresh, p["w_q"], spec.stride,
                                   torch.bfloat16),
                 "sol": Q8.plan_q(fresh, p["w_q"], True, spec.stride)}
        for name, plan in plans.items():
            key = (name, *plan, spec.size, spec.stride, _leaky(spec))
            if key not in seen:
                seen.add(key)
                out.append((name, i, cin, h, plan))
    return out


def check_copies(specs, qp, size, device, batch=8, seed=40) -> dict:
    """Each copy against its plain version on seeded inputs, bit for bit,
    at every conv of ``copy_cases`` (the direct first conv, and the wgmma
    and gather main loops at each BN, kernel size and stride the walk
    gives them) at ``batch`` images; raises where one differs. Returns
    {"copy layer": (instance, BN, max |diff|)}."""
    import torch
    from yolo_tensorflow_tpu_torch.models import engine
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, i, cin, h, plan in copy_cases(specs, qp, size):
        spec, p = specs[i], qp[engine.layer_key(i)]
        kw = dict(stride=spec.stride,
                  pad=spec.size // 2 if spec.pad < 0 else spec.pad)
        if name == "folded":
            x = (torch.randn((batch, cin, h, h), generator=gen,
                             device=device) * 2).to(torch.bfloat16)
            x = x.contiguous(memory_format=torch.channels_last)
            args = (x, p["w_q"], p["s_x"], p["s_w"], p["b_over_s"])
            got = folded_conv(*args, act=_leaky(spec), **kw)
            want = folded_plain(*args, act=_leaky(spec), **kw)
        else:
            xq = torch.randint(-127, 128, (batch, cin, h, h), generator=gen,
                               device=device).to(torch.int8).contiguous(
                                   memory_format=torch.channels_last)
            got = sol_conv(xq, p["w_q"], p["s_w"], p["b"], **kw)
            want = sol_plain(xq, p["w_q"], **kw)
        diff = float((got.float() - want.float()).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(
                f"int8_ablate: the {name} copy differs from its plain "
                f"version at layer {i} ({plan}): max |diff| {diff}")
        out[f"{name} L{i:03d} {spec.size}x{spec.size}/{spec.stride} "
            f"{cin}->{spec.filters} at {h}^2"] = (*plan, diff)
    return out


def run_rows(cfg, specs, qp, images, iters, rows=ROWS) -> list:
    """Each row's ``measure`` under inference mode, in order; a row's dict
    also holds its name."""
    import torch
    out = []
    with torch.inference_mode():
        for row in rows:
            out.append({"name": row, **measure(walk(cfg, specs, qp, row),
                                               images, iters)})
    return out


def main(model="yolov3", size=416, device="cuda", batch=BATCH,
         iters=ITERS):
    import torch
    from yolo_tensorflow_tpu_torch.tools.ablate_train import card_line
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("int8_ablate runs on the card: "
                           "torch.cuda.is_available() is false")
    if dev.type == "cuda":
        # the copies' nvcc beside the package's own build, all at once
        from yolo_tensorflow_tpu_torch.ops.kernels import build
        jobs = start_copies()
        build.build()
        finish_copies(jobs)
    cfg, specs, qp = model_params(model, size, dev)
    card = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu (host clock)")
    smi = card_line() if dev.type == "cuda" else None
    print(f"{model}-{size} backbone, B={batch}, {iters} chained iterations, "
          f"device {card}" + (f"; nvidia-smi: {smi}" if smi else ""),
          flush=True)
    with torch.inference_mode():
        checked = check_copies(specs, qp, size, dev)
    print("copies equal to their plain versions: "
          + "; ".join(f"{k} {v[0]} BN={v[1]}" for k, v in checked.items()),
          flush=True)
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.integers(0, 255, (batch, size, size, 3),
                                         dtype=np.uint8)).to(dev)
    rows = []
    for row in ROWS:
        (r,) = run_rows(cfg, specs, qp, imgs, iters, (row,))
        dms = ("" if r["device_ms"] is None
               else f"  {r['device_ms']:8.3f} ms a forward (device)")
        print(f"{row:28s} {r['img_s']:8.1f} img/s{dms}  host "
              f"{r['host_s']:.3f} s, sum {r['sum']:.6g}", flush=True)
        rows.append({k: (round(v, 4) if isinstance(v, float) else v)
                     for k, v in r.items()})
    out = {"int8_ablate": f"{model}-{size}", "batch": batch, "iters": iters,
           "device": card, "nvidia_smi": smi, "rows": rows}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    argv = sys.argv[1:]
    main(argv[0] if argv else "yolov3",
         int(argv[1]) if len(argv) > 1 else 416,
         argv[2] if len(argv) > 2 else "cuda",
         int(argv[3]) if len(argv) > 3 else BATCH,
         int(argv[4]) if len(argv) > 4 else ITERS)
