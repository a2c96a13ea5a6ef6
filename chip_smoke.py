#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU, and check them.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases, one line or more each (a failed phase exits nonzero, and no phase's
failure is caught):
  1. device: the card, as nvidia-smi reports its name and power limit;
  2. build:  nvcc builds the CUDA kernels (decode, int8 conv, fused conv +
             BN statistics, greedy NMS; the two convs share
             csrc/igemm_sm90.cuh) from
             yolo_tensorflow_tpu_torch/csrc, one nvcc process per source;
  3. kernel: the decode kernel against its plain PyTorch version on the same
             CUDA tensors: at the yolov3-416 head shapes (sigmoid classes,
             three scales in one launch) and at the yolov2 and
             yolov2-tiny-voc region heads (softmax classes), f32 and bf16 at
             batch 8 and bf16 at batch 64, and at the odd cases of
             DECODE_ODD (1 and 7 classes, a 1x1 grid, batch 1, scales whose
             rows are no multiple of the tile, a view off a 16-byte
             boundary, alone and as the middle one of three scales); the
             sigmoid heads also in the bf16 scoring mode (score_dtype=
             bf16: scores within one bf16 ulp); one
             launch per decode_fused; device times from CUDA
             events with the host kept ahead of the card, and the wrapper's
             host time beside them;
  4. f32:    Detector("yolov3", <seeded .weights>).detect_batch at 416 on
             CUDA, through the decode and NMS kernels (their launch counts
             are read around this run), against the same port on the CPU;
  5. bf16:   batch-64 bf16 serving throughput, and where its time goes
             (backbone, decode and NMS device ms); one forward with its
             launches counted and host syncs made errors
             (torch.cuda.set_sync_debug_mode("error")), as in phases 7, 12,
             13 and 15;
  6. int8 kernel: the int8 conv kernel against its plain version. Exactly on
             the two Pallas probe shapes with integer inputs (the output is
             then the int32 accumulator itself); within 1 ulp on every
             distinct quantized conv of yolov3-416 at batch 2, f32 and bf16,
             with leaky, and on the odd cases of INT8_ODD (ragged Cout and
             M, 1x1 images, stride 2, Cin that cp.async cannot copy,
             unaligned weights, small first convs); the quantize prologue
             bit for bit. Then, per shape at batch 64 in bf16: the kernel
             instance and tile, kernel ms (prologue + GEMM) and TOPS from
             CUDA events, the prologue's ms alone, its bound, the plain
             version's ms, torch._int_mm's ms for the 1x1 shapes (the same
             int8 GEMM, a yardstick the port never calls) and cuDNN's bf16
             conv ms for the 3x3 ones (context only: not the same function);
  7. int8:   calibrate the seeded weights on the card, quantize_params, then
             Detector("yolov3", params=qparams).detect_batch with the f32
             epilogue at batch 2 on CUDA against the CPU port, with the int8
             conv and decode launches counted around one forward; then int8
             bf16 serving at batch 64 beside phase 5's float number;
  8. bnstat kernel: the fused conv + BN-statistics kernel against its plain
             version, f32 and bf16, at the Pallas probe's two shapes (batch
             128), every distinct 3x3 stride-1 BN conv of yolov3-416 at
             the training batch (32) and the odd cases of BNSTAT_ODD: the
             kernel instance and tile, kernel ms from CUDA events, TFLOP/s,
             bound, plain ms, and cuDNN's conv + two torch.sum reductions
             as the library yardstick;
  9. f32 train: one f32 onepass train step of yolov3-416 at batch 2 on the
             card (make_train_step, 33 kernel launches counted), and its
             cost, batch statistics and every gradient against the CPU
             port's from the same seeded state; the gradients are held to
             the distance between two correct float32 evaluations (see
             GRAD_FLOOR);
 10. bf16 train: bf16 onepass training at batch 32 (tools/bench_train.py's
             batch), seeded images and 8 truths per image: img/s as the
             median of 3 samples of 5 steps with the spread, the step split
             into forward, loss, backward and optimizer from CUDA events,
             peak memory, and a finite cost at every step;
 11. yolov2 f32: Detector("yolov2", <seeded .weights>).detect_batch at 416,
             batch 2, on CUDA (Darknet-19, darknet's reorg passthrough, the
             decode kernel's softmax branch: one launch, counted) against
             the same port on the CPU; then a hand-made head (CRAFTED) at
             the model's own threshold of 0.5, against the CPU port and
             against its hand-computed boxes and scores;
 12. yolov2 bf16: batch-64 bf16 serving throughput, its split into
             backbone, decode and NMS, and darknet_reorg's device time;
 13. yolov1: Detector("yolov1", <seeded .weights>) at 448 (24 bias-only
             convs, the 50176 -> 512 -> 4096 -> 1470 connected head, the
             grid decode in plain PyTorch: the TPU kernel does not cover it
             either), f32 batch 2 against the CPU port, then bf16 batch 64
             with the same split and the three dense layers' device times;
 14. nms kernel: the greedy NMS kernel against its plain version on the
             card, all five Detections fields exactly equal: at phase 5's
             decode outputs (yolov3-416, batch 64, K = 256), class-aware off
             and on, and at the odd cases of NMS_ODD and K = 9000; top-k and
             kernel device ms, the bound, the plain version's and the former
             per-image loop's host ms;
 15. fused letterbox: Detector(letterbox=True, fused=True) on uint8
             canvases of mixed image sizes, f32 against the CPU port (boxes
             in pixels), then bf16 serving of VGA frames in 768 canvases at
             batch 64 with the step split into letterbox, backbone, decode,
             NMS and unmap, then one int8 step (the bf16 letterbox default);
 16. tta:    Detector(tta=True) at f32 batch 2 against the CPU port: yolov3
             in both tta_modes, yolov2 (13 columns: the darknet mode skips
             the middle one), int8 params (72 int8 conv launches counted)
             and the fused letterbox; bf16 batch-64 serving with its split
             (backbone over the doubled batch, activate + flip-average,
             decode, NMS);
 17. smoothing: detect_batch_smoothed(avg_frames=3) over 6 frames as
             batches of 2 with the state carried on the card, against the
             CPU port, for yolov3, yolov2 and yolov1; identical frames past
             the warm-up against detect_batch; bf16 batch-64 serving;
 18. int8-act: the int8-in kernel entry (conv2d_int8_q: int8
             activations in, requantized int8 or f32 out) against its plain
             twin: exactly the int32 accumulator at the Pallas probe shapes
             with integer inputs, int8 out equal and f32 out within 1 ulp
             at every distinct quantized yolov3-416 conv at batch 2 and the
             INT8_ODD cases; calibrate_outputs on the card;
             make_int8_forward at batch 2 against the CPU port (the int8-in
             entry launched for every quantized conv, the decode once, no
             quantize pass); batch-64 img/s and backbone ms beside phase
             7's mixed int8; per shape at batch 64 the entry's ms beside the
             mixed kernel's, its plain ms and its bound.
 19. bnstat darknet19 (A): the fused conv + BN-statistics kernel against
             its plain version, f32 and bf16, at every distinct 3x3
             stride-1 BN conv of yolov2 at each of run_training's
             multi-scale sizes 320..608 (grids 10..19; the 1280 -> 1024
             conv after the reorg + route among them) at TRAIN_BATCH and
             of darknet19-256 at CLS_BATCH; the bf16 shapes of yolov2-416
             and darknet19-256 timed (kernel, bound, plain, cuDNN's conv +
             two sums, summed over a training forward);
 20. f32 train families (B): one f32 onepass step at batch 2 on the card
             against the CPU port, as phase 9: yolov2-416 with darknet's
             region loss at seen 0 (the warm-up on) and 12800, then one
             darknet-Adam update from the same gradients; yolov1-448 with
             dropout rate 0 (connected head); darknet19-256 (softmax
             cross-entropy);
 21. bf16 train families (C): bf16 onepass training of yolov2-416 and
             yolov1-448 (dropout on) at batch 32 and darknet19-256 at 64:
             img/s, the step split (the loss part is the region loss's ms
             for yolov2), peak memory, conv_bnstat launches, one step under
             set_sync_debug_mode("error");
 22. run_training (D): the trainer end to end on yolov2-416 from a .cfg
             written by specs_to_cfg (random=1: multi-scale) and seeded
             .weights, bf16 onepass, batch 32, 64 synthetic 480x640 scenes
             through read_fn and the native pixel kernel
             (YOLO_NATIVE_LOADER=1): 30 steps, a checkpoint every 10, then a
             second call resumes to step 40, cudnn.benchmark off as a
             user runs it; conv_bnstat launched 15 times a step in each
             call; img/s with the loader in the loop and the inter-step
             idle share (CUDA events), and the card's idle share from a
             torch.profiler trace of eight steps.
 23. int8 k7: the int8 conv kernel at yolov1's 7x7 stride-2 first conv
             (Cin 3, Cout 64, 448^2) at batch 64 and the odd cases of
             K7_ODD, both entries, f32 and bf16, against the plain twins
             (0 ulp); its time beside its bound and plain time; int8
             yolov1-448 (24 quantized convs, the connected head float) f32
             against the CPU port with the int8 conv launched 24 times a
             forward, and bf16 batch-64 img/s beside float yolov1's;
 24. eval:   evaluate_samples over synthetic scenes (.npy files through
             read_fn): fused yolov2-416 (seeded, and phase 11's hand-made
             head) and fused int8 yolov1 Detectors f32 against the CPU port
             (detections and mAP equal, launches counted), then bf16 batch
             64 img/s of the whole pipeline over 256 scenes with the card's
             idle share from a torch.profiler trace;
 25. classifier: every Classifier mode (single, crop, 10crop, full, multi)
             on darknet19-256 f32 against the CPU port (probabilities
             within CLS_TOL, top 5 equal); bf16 classify_batch_center_crop
             img/s at batch 64;
 26. run_training eval: darknet19-256 with val_list and eval_every
             through read_fn: each round's top-1, conv_bnstat launched for
             every fused conv of every step.
Then a JSON line describing each kernel (conv3x3_bnstat: launches, ms,
bound, plain and library ms all over one step each of yolov3 (phases 8 and
10), yolov2-416 and darknet19-256 (phases 19 and 21)), and last the JSON
result line.

The weights are random, drawn from a numpy seed (there are no pretrained
weights in the repository), at full width and depth: Darknet-53 + FPN
(yolov3), Darknet-19 + passthrough (yolov2), 80 classes each, the
24-conv + 3-connected yolov1 with 20, and the darknet19 classifier with
1000.
Imports nothing of JAX: the machine with the card has none.
"""

import collections
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

MODEL = "yolov3"
SEED = 0
OBJ_BIAS = -3.0          # keeps most seeded scores below 0.5: see phase 4
CONF = 0.5               # the model's own confidence threshold
KERNEL_BATCH = 8         # phase 3; the Pallas int8 probes' batch in phase 6
PARITY_BATCH = 2         # phases 4, 6, 7, 11 and 13
SERVE_BATCH = 64         # phases 5, 6, 7, 12 and 13
# The region and grid models, (size bias, confidence threshold). With seeded
# weights the softmax over yolov2's 80 near-equal class logits puts every
# score under 0.22, so the model's own 0.5 would leave no detection: 0.1
# leaves some 90 of the 845 boxes of an image. Its anchors span up to 0.75
# of the image and seeded size logits have a deviation of 0.9, so unbiased
# boxes come out 1.3-1.5 images wide, and a corner near 0 of such a box
# carries the absolute error of its width (1e-5 on the card against the
# CPU, measured): a bias of -1 on the size logits keeps the boxes inside
# the image, as trained ones are, and PARITY_TOL as it is. yolov1 keeps its
# own threshold of 0.2 (its scores are a product of two raw outputs).
REGION = {"yolov2": (-1.0, 0.1), "yolov1": (0.0, 0.2)}
# Odd decode cases, (classes, G, anchors a cell, batch): one class, rows of
# 12 and 6 values, a 1x1 grid, batch 1, and row counts off every tile size
# (45, 225, 3, 405, 1083 rows). Each runs with sigmoid and with softmax
# classes, f32 and bf16, aligned and as a view one element off.
DECODE_ODD = ((1, 3, 5, 1), (7, 5, 3, 3), (7, 1, 3, 1), (20, 9, 5, 1),
              (1, 19, 3, 1))
# and one launch of three scales ((G, anchor mask); 225, 729 and 3249 rows at
# batch 3) whose middle scale is such a view
DECODE_ODD_SCALES = ((5, (6, 7, 8)), (9, (3, 4, 5)), (19, (0, 1, 2)))
# f32 kernel vs plain: the same float32 formulas, differing only in the
# rounding of expf and of the softmax sum order: a few ulp. bf16 inputs
# widen exactly to f32 in both, so the bf16 comparison holds to the same.
KERNEL_TOL = dict(rtol=1e-5, atol=1e-6)
# f32 detections, card vs CPU: TF32 is off, but cuDNN and the CPU sum each
# conv in another order, over 75 layers (the CPU tests hold the port to the
# JAX package at the same tolerance).
PARITY_TOL = dict(rtol=1e-4, atol=1e-5)
# int8 conv, kernel vs plain: the accumulator is exact in both. The f32
# epilogue is one fma in the kernel and in the plain version
# (conv_int8.fma_f32 rounds as fmaf does); the bf16 epilogue rounds after
# each step in both. Measured 0 ulp; 1 is the stated bound.
INT8_ULPS = 1
# the two shapes tools/probe_int8_3x3.py and tools/probe_conv_bnstat.py
# time their Pallas kernels at
PROBE_SHAPES = ((52, 128, 256), (13, 512, 1024))      # (H = W, Cin, Cout)
# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s, int8, bf16 and f32
# op/s
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
BF16_OPS_S = 989e12
F32_OPS_S = 67e12
# Odd int8 cases, (batch, k, stride, Cin, Cout, H = W, unaligned weights):
# Cout off the 32-channel tile and off 16-byte rows, M off the 128-row tile,
# 1x1 images (every tap but the centre is padding), stride 2, a Cin whose
# pixels are not whole 16-byte chunks and weights off a 16-byte boundary
# (both take the element-by-element instance), and first convs that do and
# do not fit the direct kernel.
INT8_ODD = ((3, 3, 1, 16, 40, 7, False), (2, 1, 1, 32, 20, 5, False),
            (5, 3, 1, 16, 24, 1, False), (2, 3, 2, 48, 72, 9, False),
            (2, 3, 1, 24, 36, 5, False), (2, 3, 1, 24, 72, 5, False),
            (2, 1, 1, 32, 64, 6, True), (2, 3, 2, 3, 16, 10, False),
            (2, 3, 1, 3, 20, 6, False))
# bf16 scoring (score_dtype=bf16), decode kernel vs plain: scores that are
# bf16 values, within one bf16 ulp (expf may round differently once)
BF16_SCORE_ULPS = 1
# phase 17: frames fed as batches of PARITY_BATCH with the state carried,
# averaged over darknet's demo_frame = 3
SMOOTH_FRAMES = 6
SMOOTH_AVG = 3
# the smoothing tails, card vs CPU: activated head outputs, the wh logits
# unsquashed, after 75 float32 layers summed in another order (yolov3
# measured 1.5e-5 at most on an H100)
TAIL_TOL = dict(rtol=1e-4, atol=1e-4)
# Odd conv_bnstat cases, (batch, H = W, Cin, Cout, unaligned input): as
# above, with Cout on each side of every tile width
BNSTAT_ODD = ((3, 7, 24, 40, False), (5, 1, 16, 20, False),
              (3, 7, 24, 300, False), (2, 5, 12, 36, False),
              (2, 5, 12, 100, False), (2, 4, 12, 260, False),
              (2, 9, 32, 64, True), (2, 6, 3, 16, False),
              (2, 6, 3, 20, False))
BNSTAT_PROBE_BATCH = 128  # tools/probe_conv_bnstat.py's batch
TRAIN_PARITY_BATCH = 2   # phase 9
TRAIN_BATCH = 32         # phase 10: tools/bench_train.py's default batch
TRUTHS = (30, 8)         # truth slots per image, valid ones (bench_train)
CLS_BATCH = 64           # phase 21: darknet19-256's training batch
RUN_BATCH = 32           # phase 22: run_training's batch ([net] batch=)
RUN_SCENES = 64          # phase 22: synthetic 480x640 scenes
# phase 22: the steps traced by torch.profiler, as indices of the run's
# steps (the resumed call's 32nd to 39th: one size, no save, no log)
RUN_TRACED = (31, 39)
# conv_bnstat, kernel vs plain, relative to the largest |y| or per channel.
# y: f32 sums in another order (measured <= 3e-6); bf16 rounds two
# accumulators that differ by order, so at most 1 ulp (2**-7 of |y|) apart.
# Sums: the kernel adds f32 partials of 128 rows, the plain version sums in
# float64 (sum measured <= 5e-7 of sqrt(n * sumsq)); the bf16 tensor cores'
# f32 accumulation truncates, which biases sumsq by up to 8.7e-6 relative.
BNSTAT_TOL = {torch.float32: dict(y=1e-5, y_ulp=0.0, sq=1e-5),
              torch.bfloat16: dict(y=1e-5, y_ulp=2 ** -7, sq=1e-4)}
BNSTAT_SUM_TOL = 1e-5
# f32 train step, card vs CPU: cost, metrics and batch statistics (the
# forward) within rtol 1e-4. Gradients cannot be held to 1e-4: two correct
# float32 evaluations of the yolov3 train step on the same CPU (the fused-
# stat path and separate reductions) differ by a median 5e-3 and up to
# 4.8e-2 (relative L2 per parameter, onepass, 128^2), from the float32
# rounding of train-mode BN's backward over 75 layers. So each gradient of
# the card's kernel path must be within GRAD_FLOOR[0] x the distance of the
# card's cuDNN path (no kernel) to the CPU, plus GRAD_FLOOR[1]; per
# parameter that distance is taken as at least its median over all
# parameters (a single parameter's floor is itself noise).
TRAIN_TOL = dict(rtol=1e-4, atol=1e-6)
GRAD_FLOOR = (4.0, 1e-4)
SPIN = 20_000_000        # ~10 ms of the card: every launch is queued first
# Odd NMS cases (phase 14; tests/test_torch_nms.py holds the plain version
# to the JAX package on the same list): each with class-aware NMS off and
# on, the kernel equal to the plain version in all five fields
NMS_ODD = ("batch 1", "K > N", "D > K", "none active", "all active",
           "chain", "IoU at the threshold", "degenerate", "K = 8", "K = 64",
           "K = 256", "K = 300", "K = 1024")
NMS_ODD_KW = dict(conf_threshold=0.3, iou_threshold=0.45, max_detections=20,
                  num_candidates=64)
NMS_BIG_K = 9000         # candidates near the most a CTA's shared memory holds
NMS_FLOPS = 15           # f32 operations of one IoU and its compare
# Phase 15, the fused letterbox: (canvas side, ((h, w), ...)) of the f32
# parity batches (mixed sizes, a 1x1 image, a canvas above the 768 bucket)
# and of the bf16 serving batch (VGA frames in the 768 bucket)
LETTERBOX_PARITY = ((768, ((480, 640), (500, 300), (416, 416), (1, 1))),
                    (1280, ((720, 1280),)))
LETTERBOX_SERVE = (768, (480, 640))
LETTERBOX_TOL = 3e-5     # tests/test_preprocess.py's bound against the C
# f32 Detections in pixels, card vs CPU: PARITY_TOL's rtol, and its atol of
# 1e-5 of the image in pixels of images up to 1280 wide
FUSED_TOL = dict(rtol=1e-4, atol=1.28e-2)
# The hand-made yolov2 head of phase 11, a deterministic end-to-end drive:
# (anchor, class, objectness bias, class logit). Every conv passes the
# input's red channel through unchanged (its centre tap 1), the images make
# it constant over each 32 x 32 cell and distinct between cells, and the
# head adds it to both anchors' objectness: scores sigmoid(4 + R/255) *
# 0.958, about 0.94-0.95, distinct (anchor 4 half a step above anchor 0),
# at the model's own threshold 0.5.
CRAFTED = ((0, 0, 4.0, 7.5), (4, 1, 4.0 + 0.5 / 255, 7.5))
# Phase 23, the int8 conv at yolov1's 7x7 stride-2 first conv (Cin 3, Cout
# 64, 448^2), and odd cases (batch, stride, Cout, H = W, unaligned views):
# Cout 8 and 72 (72 is past the direct kernel: the element-wise ring), M off
# the 128-row tile, stride 1, 1x1 images, inputs and weights off a 16-byte
# boundary. Kernel and plain twin compute the same exact accumulator and
# round the epilogue alike: held equal, 0 ulp.
K7_ODD = ((3, 2, 8, 9, False), (2, 1, 64, 5, False), (1, 2, 64, 1, False),
          (2, 2, 72, 10, False), (2, 2, 64, 15, True), (2, 1, 32, 11, True))
# Phase 24, evaluation: synthetic 480x640 scenes (phase 22's generator) as
# .npy files read through read_fn; the first EVAL_PARITY of them are also
# run by the CPU port (the int8 yolov1 one on 448^2 crops of them)
EVAL_SCENES = 256
EVAL_PARITY = 16
EVAL_BATCH = 8           # batches of the card-vs-CPU runs (the tail too)
# Phase 25, the classifier: probabilities card vs CPU (f32, TF32 off), and
# the images of every mode (sizes (h, w)); phase 26 in-training evaluation
CLS_TOL = dict(rtol=1e-4, atol=1e-6)
CLS_SIZES = ((480, 640), (300, 200), (256, 256), (333, 500))
RUN_CLS_IMAGES = 128     # phase 26: train and validation images
RUN_CLS_STEPS = 4


def require(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, iters=20, warmup=3, ahead_cycles=0):
    """Mean device time of fn() in ms, from CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls. ``ahead_cycles``: the card
    first spins that many clock cycles, so that the host has queued every
    call before the first one runs. Without it a kernel that is shorter
    than its wrapper's host time measures the host."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if ahead_cycles:
        torch.cuda._sleep(ahead_cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def wall_ms(fn, iters):
    """Host time of ``iters`` calls of fn(), ending in a synchronize, in ms
    per call: what a caller waits for a serving step, and the time of a
    plain version that syncs with the host (events alone would not say
    what a caller waits)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def serve_rate(step, batch, iters=5):
    """(sorted step ms, img/s) of ``step()`` (one batch of ``batch`` images)
    over 3 samples of ``iters`` chained steps, after 3 warm-up steps; and
    the last Detections."""
    for _ in range(3):
        out = step()
    step_ms = sorted(wall_ms(step, iters) for _ in range(3))
    return step_ms, [batch * 1e3 / ms for ms in step_ms], out


def counted_forward(label, step, **want):
    """One forward, ``step()``, with every kernel's launch count set to 0
    just before it and host syncs made errors during it
    (``torch.cuda.set_sync_debug_mode("error")``: a sync raises, and is not
    caught). ``want``: the launches expected of each counted wrapper
    (decode, nms, int8, int8_q: the int8-in entry). Returns the forward's
    output."""
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    got = {name: count for name, count in counts().items() if name in want}
    require(got == want, f"{label}: one forward launched {got}, expected "
            f"{want}")
    print(f"[{label}] one forward, inputs on the card: no host sync under "
          f"set_sync_debug_mode('error'); launches {got}")
    return out


def _wrappers():
    from yolo_tensorflow_tpu_torch.ops.kernels import conv_int8 as Q8
    from yolo_tensorflow_tpu_torch.ops.kernels import decode as K
    from yolo_tensorflow_tpu_torch.ops.kernels import nms as NK
    return {"decode": (K, "launches"), "nms": (NK, "launches"),
            "int8": (Q8, "launches"), "int8_q": (Q8, "launches_q")}


def reset_counts():
    """Every kernel wrapper's launch count set to 0."""
    for module, attr in _wrappers().values():
        setattr(module, attr, 0)


def counts():
    """{wrapper: launches since reset_counts()}."""
    return {name: getattr(module, attr)
            for name, (module, attr) in _wrappers().items()}


def bound_ms(nbytes, ops, ops_s):
    """(least ms the card could take, what bounds it): the larger of the
    bytes over HBM bandwidth and the operations over the peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / ops_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def ulp_distance(a, b):
    """Largest distance between two float32 or two bfloat16 tensors in units
    in the last place of their dtype, counted across zero."""
    bits, mask = {torch.float32: (torch.int32, 0x7FFFFFFF),
                  torch.bfloat16: (torch.int16, 0x7FFF)}[a.dtype]

    def ordered(t):
        i = t.contiguous().view(bits).long()
        return torch.where(i < 0, -(i & mask), i)

    return int((ordered(a) - ordered(b)).abs().max().item())


def unaligned(t):
    """A copy of channels-last ``t`` in channels-last memory that starts one
    element past a 16-byte boundary."""
    b, c, h, w = t.shape
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(b, h, w, c).permute(0, 3, 1, 2)
    view.copy_(t)
    require(view.is_contiguous(memory_format=torch.channels_last)
            and view.data_ptr() % 16 != 0, "unaligned(): view is aligned")
    return view


def check_detections(label, det, imgs, got, want, cfg, kind, conf=CONF,
                     scores=None):
    """Card Detections (numpy) against the CPU port's: num, classes and
    valid equal, boxes and scores within PARITY_TOL, at least one detection
    per image, and no exactly tied score among the active ones (above
    ``conf``) of any image's top 256 (the comparison would then depend on
    tie order). ``scores``: the card's scores before NMS, where they are not
    ``det``'s plain decode (TTA, the int8-activation path). Returns max
    |err|."""
    from yolo_tensorflow_tpu_torch.models import heads
    from yolo_tensorflow_tpu_torch.pipeline import normalize_images
    if scores is None:
        with torch.inference_mode():
            feats = det.network(normalize_images(
                torch.as_tensor(imgs, device=det.device), cfg))
            scores = heads.decode_scored(feats, cfg)[1]
    k = min(256, scores.shape[1])
    top = torch.topk(scores, k, dim=1).values
    active = [row[row > conf] for row in top]
    ties = [a.numel() - torch.unique(a).numel() for a in active]
    print(f"[{label}] scores in [{scores.min().item():.4g}, "
          f"{scores.max().item():.4g}], {int((scores > conf).sum())} "
          f"above {conf}; exact ties among each image's active top {k}: "
          f"{ties}")
    require(not any(ties), "tied top scores: the comparison would depend "
            "on tie order")
    require(np.all(got.num > 0), f"no detections: num={got.num}")
    for name in ("num", "classes", "valid"):
        require(np.array_equal(getattr(got, name), getattr(want, name)),
                f"card and CPU {name} differ")
    err = {}
    for name in ("boxes", "scores"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   **PARITY_TOL)
        err[name] = float(np.abs(getattr(got, name)
                                 - getattr(want, name)).max())
    require(got.boxes.shape == (imgs.shape[0], cfg.max_detections, 4)
            and np.isfinite(got.boxes).all(),
            f"boxes {got.boxes.shape} not finite or not (B, D, 4)")
    print(f"[{label}] detect_batch B={imgs.shape[0]} at {cfg.input_size} on "
          f"{kind}: num {got.num.tolist()}, classes/valid equal to the CPU "
          f"port, max |err| boxes {err['boxes']:.3g} scores "
          f"{err['scores']:.3g} (tol {PARITY_TOL})")
    return err


def decode_heads(gen, dev, batch, dtype, num_classes, scales):
    """Seeded head scales [(feat (B, G, G, A*(5+C)), Detect)] on the card;
    ``scales`` = ((G, anchor_mask), ...)."""
    from yolo_tensorflow_tpu_torch.models import specs as S
    return [(torch.randn((batch, g, g, len(mask) * (5 + num_classes)),
                         generator=gen, device=dev).to(dtype), S.Detect(mask))
            for g, mask in scales]


def off_boundary(feat):
    """A contiguous copy of a head scale that starts one element past a
    16-byte boundary."""
    flat = torch.empty(feat.numel() + 1, dtype=feat.dtype, device=feat.device)
    view = flat[1:].view(feat.shape)
    view.copy_(feat)
    require(view.data_ptr() % 16 != 0 and view.is_contiguous(),
            "off_boundary(): the view is aligned")
    return view


def decode_check(label, dets, cfg, score_dtype=None):
    """One decode_fused (exactly one launch) against decode_plain within
    KERNEL_TOL, labels exact; in the bf16 scoring mode the scores within
    BF16_SCORE_ULPS bf16 ulps. Returns (max |err|, outputs)."""
    from yolo_tensorflow_tpu_torch.ops.kernels import decode as K
    before = K.launches
    got = K.decode_fused(dets, cfg, score_dtype=score_dtype)
    count = K.launches - before
    want = K.decode_plain(dets, cfg, score_dtype=score_dtype)
    torch.cuda.synchronize()
    require(count == 1, f"{label}: decode_fused launched {count} kernels, "
            "expected one for all scales")
    err = 0.0
    for i, (g, w) in enumerate(zip(got[:2], want[:2])):
        if i == 1 and score_dtype == torch.bfloat16:
            g16, w16 = g.to(torch.bfloat16), w.to(torch.bfloat16)
            require(torch.equal(g16.float(), g) and torch.equal(w16.float(),
                                                                w),
                    f"{label}: bf16 scores are not bf16 values")
            ulps = ulp_distance(g16, w16)
            require(ulps <= BF16_SCORE_ULPS, f"{label}: bf16 scores {ulps} "
                    "ulps from plain")
        else:
            torch.testing.assert_close(g, w, **KERNEL_TOL,
                                       msg=lambda m: f"{label}: kernel != "
                                       f"plain: {m}")
        err = max(err, (g - w).abs().max().item())
    require(torch.equal(got[2], want[2]), f"{label}: labels differ")
    return err, got


def decode_kernel_phase(dev):
    """Phase 3. Returns the kernel's JSON fields, timed at the yolov3-416
    heads, batch SERVE_BATCH, bf16: the shape phase 5 serves."""
    import dataclasses
    from yolo_tensorflow_tpu_torch import config as C
    from yolo_tensorflow_tpu_torch.ops.kernels import decode as K
    gen = torch.Generator(device=dev).manual_seed(SEED)
    v3 = ((13, (6, 7, 8)), (26, (3, 4, 5)), (52, (0, 1, 2)))
    region = ((13, (0, 1, 2, 3, 4)),)
    max_err, fields = 0.0, None
    for name, scales in (("yolov3", v3), ("yolov2", region),
                         ("yolov2-tiny-voc", region)):
        cfg = C.get_config(name)
        for batch, dtype in ((KERNEL_BATCH, torch.float32),
                             (KERNEL_BATCH, torch.bfloat16),
                             (SERVE_BATCH, torch.bfloat16)):
            dets = decode_heads(gen, dev, batch, dtype, cfg.num_classes,
                                scales)
            label = f"decode {name} {str(dtype)[6:]} B={batch}"
            err, got = decode_check(label, dets, cfg)
            max_err = max(max_err, err)
            kernel_ms = cuda_ms(lambda: K.decode_fused(dets, cfg),
                                ahead_cycles=SPIN)
            plain_ms = cuda_ms(lambda: K.decode_plain(dets, cfg))
            host_ms = wall_ms(lambda: K.decode_fused(dets, cfg), 200)
            in_bytes = sum(f.numel() * f.element_size() for f, _ in dets)
            # outputs: boxes (4 f32), score (f32) and label (i32) per row
            out_bytes = sum(g.numel() * g.element_size() for g in got)
            # ~4 f32 operations per head value (sigmoid/exp, max, compares)
            bnd, by = bound_ms(in_bytes + out_bytes,
                               4 * in_bytes // dets[0][0].element_size(),
                               F32_OPS_S)
            plan = K.plan_tiles([f.numel() // (5 + cfg.num_classes)
                                 for f, _ in dets], 5 + cfg.num_classes,
                                dets[0][0].element_size())
            print(f"[3 kernel] {label} N={got[1].shape[1]} "
                  f"({'softmax' if cfg.head == 2 else 'sigmoid'} classes): "
                  f"equal to plain within {KERNEL_TOL}, labels equal, max "
                  f"|err| {err:.3g}; 1 launch of {plan.total_tiles} tiles x "
                  f"{plan.tile_rows} rows, {plan.stages} stages; kernel "
                  f"{kernel_ms:.4f} ms ({in_bytes / 1e6 / kernel_ms:.1f} GB/s "
                  f"read), bound {bnd:.4f} ms ({by}), plain {plain_ms:.4f} "
                  f"ms; {host_ms:.4f} ms a call on the host's clock in a "
                  "loop of 200 calls")
            if name == MODEL and batch == SERVE_BATCH:
                fields = {"ms": kernel_ms, "plain_ms": plain_ms,
                          "bound_ms": bnd, "bound_by": by, "library_ms": None}
            if cfg.head == 3:
                # the bf16 scoring mode (score_dtype=bf16) on the same heads
                bf16 = torch.bfloat16
                err, _ = decode_check(label + " bf16 scores", dets, cfg, bf16)
                max_err = max(max_err, err)
                k16 = cuda_ms(lambda: K.decode_fused(dets, cfg, bf16),
                              ahead_cycles=SPIN)
                p16 = cuda_ms(lambda: K.decode_plain(dets, cfg, bf16))
                same = (K.decode_fused(dets, cfg, bf16)[1]
                        == K.decode_plain(dets, cfg, bf16)[1]).float().mean()
                print(f"[3 kernel] {label} bf16 scoring mode: labels equal, "
                      f"boxes within {KERNEL_TOL}, scores within "
                      f"{BF16_SCORE_ULPS} bf16 ulp ({same.item():.6f} of them "
                      f"equal); kernel {k16:.4f} ms, plain {p16:.4f} ms")
            del dets, got

    cases = 0
    for classes, g, anchors, batch in DECODE_ODD:
        names = tuple(f"c{i}" for i in range(classes))
        cfgs = (dataclasses.replace(C.get_config("yolov3"),
                                    custom_classes=names),
                dataclasses.replace(
                    C.get_config("yolov2"), custom_classes=names,
                    anchors=C.V2_COCO_ANCHORS[:anchors]))
        for cfg in cfgs:
            for dtype in (torch.float32, torch.bfloat16):
                dets = decode_heads(gen, dev, batch, dtype, classes,
                                    ((g, tuple(range(anchors))),))
                label = (f"odd decode head {cfg.head} C={classes} G={g} "
                         f"A={anchors} B={batch} {str(dtype)[6:]}")
                off = [(off_boundary(dets[0][0]), dets[0][1])]
                for sd in ((None, torch.bfloat16) if cfg.head == 3
                           else (None,)):
                    tag = " bf16 scores" if sd else ""
                    max_err = max(max_err, decode_check(
                        label + tag, dets, cfg, sd)[0])
                    max_err = max(max_err, decode_check(
                        label + tag + " off a 16-byte boundary", off, cfg,
                        sd)[0])
                    cases += 2
    # three scales in one launch, the middle one off a 16-byte boundary: the
    # element-wise fill beside 16-byte copies, each scale's last tile ragged
    cfg = dataclasses.replace(C.get_config("yolov3"),
                              custom_classes=tuple(f"c{i}" for i in range(7)))
    for dtype in (torch.float32, torch.bfloat16):
        dets = decode_heads(gen, dev, 3, dtype, 7, DECODE_ODD_SCALES)
        dets[1] = (off_boundary(dets[1][0]), dets[1][1])
        max_err = max(max_err, decode_check(
            f"odd decode, scales {DECODE_ODD_SCALES} C=7 B=3 "
            f"{str(dtype)[6:]}, the middle one off a 16-byte boundary", dets,
            cfg)[0])
        cases += 1
    print(f"[3 kernel] {cases} odd decode cases (classes, G, anchors, batch "
          f"of {DECODE_ODD}; sigmoid (also in the bf16 scoring mode) and "
          f"softmax, f32 and bf16, aligned and "
          f"one element off; and three scales {DECODE_ODD_SCALES} with the "
          f"middle one off): one launch each, equal to plain within "
          f"{KERNEL_TOL}, labels equal; max |err| over phase 3 {max_err:.3g}")
    return {"max_abs_err": max_err, **fields}


def int8_shapes(specs, cfg, quantized):
    """Counter of (k, stride, Cin, Cout, H) over the convs whose layer
    indices are in ``quantized``."""
    from yolo_tensorflow_tpu_torch.models import engine
    size = cfg.input_size
    shapes = engine.infer_shapes(specs, (1, size, size, 3))
    out = collections.Counter()
    for i in sorted(quantized):
        spec = specs[i]
        require(spec.act == "leaky", f"layer {i}: act {spec.act}")
        _, h, _, cin = shapes[i - 1] if i else (1, size, size, 3)
        out[(spec.size, spec.stride, cin, spec.filters, h)] += 1
    return out


def int8_operands(gen, dev, batch, k, cin, cout, h, dtype, integer=False):
    """Seeded operands of one int8 conv on the card. ``integer``: inputs in
    [-8, 8], s_x = 1, unit s_w and zero bias, so that the output is the
    int32 accumulator exactly."""
    if integer:
        x = torch.randint(-8, 9, (batch, cin, h, h), generator=gen,
                          device=dev).float()
        s_x, s_w = 1.0, torch.ones(cout, device=dev)
        b = torch.zeros(cout, device=dev)
    else:
        x = torch.randn((batch, cin, h, h), generator=gen, device=dev) * 2
        s_x = 4.0 / 127
        s_w = (torch.rand(cout, generator=gen, device=dev) + 0.5) / 127
        b = torch.randn(cout, generator=gen, device=dev)
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    w_q = torch.randint(-127, 128, (cout, cin, k, k), generator=gen,
                        device=dev).to(torch.int8).contiguous(
                            memory_format=torch.channels_last)
    return x, w_q, s_x, s_w, b


def int8_cost(batch, k, stride, cin, cout, h, in_bytes, out_bytes):
    """(bytes, int8 ops) of one quantized conv: input read once, weights,
    scales and bias read once, output written once; 2 ops per MAC."""
    ho = (h + 2 * (k // 2) - k) // stride + 1
    m = batch * ho * ho
    nbytes = (batch * h * h * cin * in_bytes + cout * k * k * cin + 8 * cout
              + m * cout * out_bytes)
    return nbytes, 2 * m * cout * k * k * cin


def int8_kernel_phase(shapes, dev):
    """Phase 6. Returns the kernel's JSON fields measured here."""
    from yolo_tensorflow_tpu_torch.ops.kernels import conv_int8 as Q8
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    for h, cin, cout in PROBE_SHAPES:
        x, w_q, s_x, s_w, b = int8_operands(gen, dev, KERNEL_BATCH, 3, cin,
                                            cout, h, torch.float32, True)
        got = Q8.conv2d_int8(x, w_q, s_x, s_w, b)
        want = Q8.conv2d_int8_plain(x, w_q, s_x, s_w, b)
        acc = Q8.int8_accumulate(x, w_q, pad=1)
        torch.cuda.synchronize()
        require(acc.abs().max().item() < 2 ** 24 and torch.equal(got, want)
                and torch.equal(got, acc.float()),
                f"int8 probe shape {h}^2 {cin}->{cout}: kernel != int32 "
                "accumulator")
        ms = cuda_ms(lambda: Q8.conv2d_int8(x, w_q, s_x, s_w, b))
        plain = cuda_ms(lambda: Q8.conv2d_int8_plain(x, w_q, s_x, s_w, b),
                        iters=3, warmup=1)
        nbytes, ops = int8_cost(KERNEL_BATCH, 3, 1, cin, cout, h, 4, 4)
        bnd, by = bound_ms(nbytes, ops, INT8_OPS_S)
        print(f"[6 int8 kernel] Pallas probe shape B={KERNEL_BATCH} {h}^2 "
              f"{cin}->{cout} 3x3, f32 integer inputs: equal to the int32 "
              f"accumulator; kernel {ms:.4f} ms ({ops / ms / 1e9:.1f} TOPS), "
              f"bound {bnd:.4f} ms ({by}), plain {plain:.3f} ms")
        del x, w_q, got, want, acc

    max_err, worst_ulps = 0.0, 0
    used = collections.Counter()
    cases = ([(PARITY_BATCH, k, stride, cin, cout, h, False)
              for (k, stride, cin, cout, h) in sorted(shapes)]
             + list(INT8_ODD))
    for (batch, k, stride, cin, cout, h, off) in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x, w_q, s_x, s_w, b = int8_operands(gen, dev, batch, k, cin,
                                                cout, h, dtype)
            if off:
                w_q = unaligned(w_q)
            kw = dict(stride=stride, act="leaky", epilogue_dtype=dtype)
            got = Q8.conv2d_int8(x, w_q, s_x, s_w, b, **kw)
            want = Q8.conv2d_int8_plain(x, w_q, s_x, s_w, b, **kw)
            torch.cuda.synchronize()
            ulps = ulp_distance(got, want)
            require(got.shape == want.shape and ulps <= INT8_ULPS,
                    f"int8 conv B={batch} k{k} s{stride} {cin}->{cout} at "
                    f"{h}^2 {dtype} {Q8.plan(x, w_q)}: {ulps} ulps from "
                    "plain")
            require(torch.equal(Q8.quantize_act(x, s_x),
                                Q8.quantize_act_plain(x, s_x)),
                    f"quantize prologue != plain at {tuple(x.shape)} {dtype}")
            used[Q8.plan(x, w_q)] += 1
            worst_ulps = max(worst_ulps, ulps)
            max_err = max(max_err, (got.float() - want.float()).abs()
                          .max().item())
    x = unaligned(int8_operands(gen, dev, 2, 1, 13, 8, 5, torch.bfloat16)[0])
    require(torch.equal(Q8.quantize_act(x, 0.03),
                        Q8.quantize_act_plain(x, 0.03)),
            "quantize prologue != plain on an unaligned input")
    print(f"[6 int8 kernel] {len(shapes)} distinct quantized convs of "
          f"{MODEL}-416 ({sum(shapes.values())} in all) at B={PARITY_BATCH} "
          f"and {len(INT8_ODD)} odd cases, f32 and bf16, leaky: within "
          f"{worst_ulps} ulp of plain (limit {INT8_ULPS}), max |err| "
          f"{max_err:.3g}; the quantize prologue equal to plain, also "
          f"unaligned; (instance, BN) taken: {dict(used)}")

    tot = collections.Counter()
    for (k, stride, cin, cout, h), n in sorted(shapes.items(),
                                              key=lambda kv: -kv[0][4]):
        x, w_q, s_x, s_w, b = int8_operands(gen, dev, SERVE_BATCH, k, cin,
                                            cout, h, torch.bfloat16)
        kw = dict(stride=stride, act="leaky", epilogue_dtype=torch.bfloat16)
        ms = cuda_ms(lambda: Q8.conv2d_int8(x, w_q, s_x, s_w, b, **kw),
                     iters=10)
        instance, bn = Q8.plan(x, w_q)
        # the direct kernel quantizes in registers: no prologue pass
        quant = (0.0 if instance == "direct" else
                 cuda_ms(lambda: Q8.quantize_act(x, s_x), iters=10))
        plain = cuda_ms(lambda: Q8.conv2d_int8_plain(x, w_q, s_x, s_w, b,
                                                     **kw), iters=1, warmup=1)
        nbytes, ops = int8_cost(SERVE_BATCH, k, stride, cin, cout, h, 2, 2)
        bnd, by = bound_ms(nbytes, ops, INT8_OPS_S)
        if k == 1:
            a = torch.randint(-127, 128, (x.numel() // cin, cin),
                              generator=gen, device=dev).to(torch.int8)
            w2 = w_q.reshape(cout, cin).t()
            lib = cuda_ms(lambda: torch._int_mm(a, w2), iters=10)
            other = f"torch._int_mm {lib:.4f} ms (same int8 GEMM)"
            tot["int_mm"] += n * lib
            tot["ms_1x1"] += n * ms
        else:
            wf = torch.randn((cout, cin, k, k), generator=gen, device=dev,
                             dtype=torch.bfloat16).contiguous(
                                 memory_format=torch.channels_last)
            bf = torch.randn(cout, generator=gen, device=dev,
                             dtype=torch.bfloat16)
            lib = cuda_ms(lambda: F.conv2d(x, wf, bf, stride=stride,
                                           padding=k // 2), iters=10)
            other = f"cuDNN bf16 conv {lib:.4f} ms (context: not the same " \
                    "function)"
            tot["cudnn_3x3"] += n * lib
            tot["ms_3x3"] += n * ms
        tot["ms"] += n * ms
        tot["quant"] += n * quant
        tot["plain"] += n * plain
        tot["bound"] += n * bnd
        tot[f"bound_{by}"] += n * bnd
        print(f"[6 int8 kernel] B={SERVE_BATCH} bf16 k{k} s{stride} "
              f"{cin}->{cout} at {h}^2 x{n}: {instance} BN={bn}, kernel "
              f"{ms:.4f} ms ({ops / ms / 1e9:.1f} TOPS) of which the "
              f"quantize prologue alone {quant:.4f} ms, bound {bnd:.4f} ms "
              f"({by}), plain {plain:.3f} ms; {other}")
        del x, w_q
    by = ("bytes" if tot["bound_bytes"] >= tot["bound_operations"]
          else "operations")
    print(f"[6 int8 kernel] per {MODEL}-416 forward at B={SERVE_BATCH} bf16, "
          f"summed over the {sum(shapes.values())} convs: kernel "
          f"{tot['ms']:.3f} ms (1x1 {tot['ms_1x1']:.3f}, 3x3 "
          f"{tot['ms_3x3']:.3f}; the quantize prologues alone "
          f"{tot['quant']:.3f}), bound {tot['bound']:.3f} ms (bytes-bound "
          f"layers {tot['bound_bytes']:.3f}, operations-bound "
          f"{tot['bound_operations']:.3f}), plain {tot['plain']:.2f} ms; "
          f"torch._int_mm over the 1x1 convs {tot['int_mm']:.3f} ms, cuDNN "
          f"bf16 over the 3x3 convs {tot['cudnn_3x3']:.3f} ms")
    return {"max_abs_err": max_err, "ms": tot["ms"], "plain_ms": tot["plain"],
            "bound_ms": tot["bound"], "bound_by": by, "library_ms": None}


def step_split(det, x, cfg, conf):
    """Device ms of the parts of one serving forward of ``det`` on the
    uint8 images ``x``, from CUDA events with the host kept ahead of the
    card for the short ones: (backbone, decode, NMS: candidate sort +
    gathers + the kernel), and the decode's outputs."""
    from yolo_tensorflow_tpu_torch.models import heads
    from yolo_tensorflow_tpu_torch.ops.kernels import decode as K
    from yolo_tensorflow_tpu_torch.pipeline import normalize_images
    from yolo_tensorflow_tpu_torch.post import nms as NMS
    with torch.inference_mode():
        xn = normalize_images(x, cfg, det.network.dtype)
        net_ms = cuda_ms(lambda: det.network(xn), iters=5)
        feats = det.network(xn)
        if cfg.head == 1:
            def decode():
                boxes, scores, labels = heads.decode_scored(feats, cfg)
                return heads.xywh_to_xyxy(boxes), scores, labels
        else:
            def decode():
                return K.decode_fused(feats, cfg)
        dec_ms = cuda_ms(decode, ahead_cycles=SPIN)
        decoded = decode()
        nms_ms = cuda_ms(lambda: NMS.batched_nms_scored(
            *decoded, conf_threshold=conf, iou_threshold=cfg.iou_threshold,
            max_detections=cfg.max_detections), ahead_cycles=SPIN)
    return net_ms, dec_ms, nms_ms, decoded


def int8_path_phase(specs, cfg, path, imgs, x, dev, float_rate, kind):
    """Phase 7. Returns the int8 conv launches of one forward, the int8
    params, the calibration batches, and the bf16 batch-SERVE_BATCH img/s
    and backbone ms."""
    from yolo_tensorflow_tpu_torch.io import weights as W
    from yolo_tensorflow_tpu_torch.models import engine
    from yolo_tensorflow_tpu_torch.ops import quant as Q
    from yolo_tensorflow_tpu_torch.ops.kernels import conv_int8 as Q8
    from yolo_tensorflow_tpu_torch.ops.kernels import decode as K
    from yolo_tensorflow_tpu_torch.ops.kernels import nms as NK
    from yolo_tensorflow_tpu_torch.pipeline import Detector, normalize_images
    from yolo_tensorflow_tpu_torch.post import nms as NMS

    folded, _ = W.load_darknet_weights(specs, cfg.input_size, path)
    rng = np.random.default_rng(SEED + 7)
    calib = [rng.integers(0, 256, imgs.shape, dtype=np.uint8)
             for _ in range(2)]
    t0 = time.perf_counter()
    scales = Q.calibrate_activations(specs, folded, calib, cfg=cfg,
                                     device=dev)
    qparams = Q.quantize_params(specs, folded, scales)
    quant_s = time.perf_counter() - t0
    shapes = int8_shapes(specs, cfg, {
        i for i in range(len(specs))
        if "w_q" in qparams.get(engine.layer_key(i), {})})
    n_int8 = sum(shapes.values())
    print(f"[7 int8] calibrated on 2 x {imgs.shape[0]} seeded images on the "
          f"card and quantized {n_int8} convs ({len(shapes)} distinct; "
          f"heads {sorted(Q.head_conv_layers(specs))} stay float) in "
          f"{quant_s:.1f} s; s_x in [{min(scales.values()):.4g}, "
          f"{max(scales.values()):.4g}]")

    gpu = Detector(MODEL, params=qparams, device="cuda", conf_threshold=CONF)
    gpu.detect_batch(imgs)                     # warm-up, outside the count
    torch.cuda.synchronize()
    Q8.launches = K.launches = NK.launches = 0
    got = gpu.detect_batch(imgs)               # f32 epilogue: parity mode
    torch.cuda.synchronize()
    launches, dec_launches = Q8.launches, K.launches
    require(launches == n_int8 and dec_launches == NK.launches == 1,
            f"int8 path launched the int8 conv {launches} times (expected "
            f"{n_int8}), the decode {dec_launches} times and NMS "
            f"{NK.launches} times (expected 1 each)")
    cpu = Detector(MODEL, params=qparams, device="cpu", conf_threshold=CONF)
    check_detections("7 int8 f32", gpu, imgs, NMS.fetch_detections(got),
                     NMS.fetch_detections(cpu.detect_batch(imgs)), cfg, kind)
    print(f"[7 int8 f32] one forward launched the int8 conv {launches} times "
          f"and the decode and NMS once each")
    del gpu, cpu

    det = Detector(MODEL, params=qparams, device="cuda",
                   compute_dtype=torch.bfloat16, conf_threshold=CONF)
    torch.cuda.reset_peak_memory_stats()
    step_ms, rates, out = serve_rate(lambda: det.detect_batch(x), len(x))
    out = NMS.fetch_detections(out)
    require(np.isfinite(out.boxes).all() and np.all(out.num > 0),
            "int8 bf16 detections empty or not finite")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counted_forward("7 int8 bf16", lambda: det.detect_batch(x),
                    int8=n_int8, decode=1, nms=1)
    net_ms, dec_ms, nms_ms, _ = step_split(det, x, cfg, CONF)
    with torch.inference_mode():
        xn = normalize_images(x, cfg, torch.bfloat16)
        # the int8 convs' share: CUDA events around each of them
        events = []
        quant = [m for m in det.network.modules()
                 if isinstance(m, engine.QuantConv)]

        def before(*_):
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()

        hooks = [h for m in quant for h in (
            m.register_forward_pre_hook(before),
            m.register_forward_hook(before))]
        for _ in range(5):
            det.network(xn)
        torch.cuda.synchronize()
        for h in hooks:
            h.remove()
        conv_ms = sum(a.elapsed_time(b)
                      for a, b in zip(events[::2], events[1::2])) / 5
    print(f"[7 int8 bf16] detect_batch B={SERVE_BATCH} at {cfg.input_size}: "
          f"{statistics.median(rates):.1f} img/s median of 3 x 5 steps "
          f"(spread {min(rates):.1f}..{max(rates):.1f}), step "
          f"{statistics.median(step_ms):.2f} ms; float bf16 in phase 5: "
          f"{float_rate:.1f} img/s; backbone {net_ms:.2f} ms = int8 convs "
          f"{conv_ms:.2f} ms + the rest {net_ms - conv_ms:.2f} ms, decode "
          f"{dec_ms:.4f} ms, NMS {nms_ms:.4f} ms (device); peak memory "
          f"{peak:.2f} GiB; mean num {out.num.mean():.1f}")
    return launches, qparams, calib, statistics.median(rates), net_ms


def bnstat_shapes(specs, cfg):
    """Counter of (H, Cin, Cout) over the 3x3 stride-1 BN convs, the convs
    whose training forward runs the conv_bnstat kernel."""
    from yolo_tensorflow_tpu_torch.models import engine
    size = cfg.input_size
    shapes = engine.infer_shapes(specs, (1, size, size, 3))
    out = collections.Counter()
    for i, spec in enumerate(specs):
        if engine.uses_conv_bnstat(spec):
            _, h, _, cin = shapes[i - 1] if i else (1, size, size, 3)
            out[(h, cin, spec.filters)] += 1
    return out


def bnstat_case(gen, dev, batch, h, cin, cout, dtype, off=False):
    """Seeded operands of one fused conv (``off``: the input starts off a
    16-byte boundary), its (bytes, flops), and the library yardstick:
    cuDNN's conv and two torch.sum reductions."""
    from yolo_tensorflow_tpu_torch.ops import layers as L
    x = torch.randn((batch, cin, h, h), generator=gen, device=dev).to(
        dtype).contiguous(memory_format=torch.channels_last)
    if off:
        x = unaligned(x)
    w = (torch.randn((cout, cin, 3, 3), generator=gen, device=dev)
         / (3 * cin ** 0.5)).to(dtype).contiguous(
             memory_format=torch.channels_last)
    size = torch.finfo(dtype).bits // 8
    nbytes = (x.numel() + w.numel() + batch * h * h * cout) * size + 8 * cout
    flops = 2 * batch * h * h * cout * 9 * cin

    def library():
        with L.exact_f32_convs():
            y = F.conv2d(x, w, padding=1)
        return (torch.sum(y, (0, 2, 3), dtype=torch.float32),
                torch.sum(torch.square(y), (0, 2, 3), dtype=torch.float32))

    return x, w, nbytes, flops, library


def bnstat_check(label, got, want, dtype, n):
    """conv_bnstat kernel (y, sum, sumsq) against its plain version within
    BNSTAT_TOL; returns max |y err|."""
    tol = BNSTAT_TOL[dtype]
    y, s, q = got
    yp, sp, qp = want
    yf, ypf = y.float(), yp.float()
    err = (yf - ypf).abs()
    lim = tol["y"] * ypf.abs().max() + tol["y_ulp"] * ypf.abs()
    require(y.shape == yp.shape and y.dtype == yp.dtype
            and bool((err <= lim).all()),
            f"{label}: y off its plain version by {err.max().item():.3g}")
    scale = (n * qp.double()).sqrt()
    s_err = ((s.double() - sp.double()).abs() / scale).max().item()
    q_err = ((q - qp).abs() / qp).max().item()
    require(s_err <= BNSTAT_SUM_TOL and q_err <= tol["sq"],
            f"{label}: sum off by {s_err:.3g} of sqrt(n * sumsq), sumsq by "
            f"{q_err:.3g} relative")
    return err.max().item(), s_err, q_err


def bnstat_kernel_phase(specs, cfg, dev):
    """Phase 8. Returns (max |y err|, Counter of the kernel's ms, plain,
    library and bound ms summed over a yolov3-416 training forward's convs,
    bf16, batch TRAIN_BATCH)."""
    from yolo_tensorflow_tpu_torch.ops.kernels import conv_bnstat as BS
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    shapes = bnstat_shapes(specs, cfg)
    cases = ([(BNSTAT_PROBE_BATCH, h, ci, co, 0, False)
              for h, ci, co in PROBE_SHAPES]
             + [(TRAIN_BATCH, h, ci, co, n, False)
                for (h, ci, co), n in sorted(shapes.items(),
                                             key=lambda kv: -kv[0][0])])
    max_err = 0.0
    tot = collections.Counter()
    used = collections.Counter()
    for batch, h, cin, cout, off in BNSTAT_ODD:
        for dtype in (torch.float32, torch.bfloat16):
            x, w, _, _, _ = bnstat_case(gen, dev, batch, h, cin, cout, dtype,
                                        off)
            label = (f"odd case B={batch} {h}^2 {cin}->{cout} "
                     f"{str(dtype)[6:]} {BS.plan(x, w)}")
            err, _, _ = bnstat_check(
                label, BS.conv3x3_bnstat_forward(x, w),
                BS.conv3x3_bnstat_plain(x, w), dtype, batch * h * h)
            max_err = max(max_err, err)
            used[BS.plan(x, w)] += 1
    print(f"[8 bnstat kernel] {len(BNSTAT_ODD)} odd cases, f32 and bf16: "
          f"equal to plain within BNSTAT_TOL; (instance, BN) taken: "
          f"{dict(used)}")
    for batch, h, cin, cout, n, off in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x, w, nbytes, flops, library = bnstat_case(gen, dev, batch, h,
                                                       cin, cout, dtype, off)
            instance, bn = BS.plan(x, w)
            label = (f"B={batch} {h}^2 {cin}->{cout} {str(dtype)[6:]} "
                     f"{instance} BN={bn}"
                     + ("" if n else " (Pallas probe shape)"))
            err, s_err, q_err = bnstat_check(
                label, BS.conv3x3_bnstat_forward(x, w),
                BS.conv3x3_bnstat_plain(x, w), dtype, batch * h * h)
            max_err = max(max_err, err)
            ms = cuda_ms(lambda: BS.conv3x3_bnstat_forward(x, w), iters=10)
            plain = cuda_ms(lambda: BS.conv3x3_bnstat_plain(x, w), iters=2,
                            warmup=1)
            lib = cuda_ms(library, iters=10)
            peak = BF16_OPS_S if dtype == torch.bfloat16 else F32_OPS_S
            bnd, by = bound_ms(nbytes, flops, peak)
            print(f"[8 bnstat kernel] {label}" + (f" x{n}" if n else "")
                  + f": equal to plain (max |y err| {err:.3g}, sum "
                  f"{s_err:.2g}, sumsq {q_err:.2g}); kernel {ms:.4f} ms "
                  f"({flops / ms / 1e9:.1f} TFLOP/s), bound {bnd:.4f} ms "
                  f"({by}), plain {plain:.3f} ms, cuDNN conv + 2 sums "
                  f"{lib:.4f} ms")
            if n and dtype == torch.bfloat16:
                tot["ms"] += n * ms
                tot["plain"] += n * plain
                tot["lib"] += n * lib
                tot["bound"] += n * bnd
                tot[f"bound_{by}"] += n * bnd
                tot["flops"] += n * flops
            del x, w
    print(f"[8 bnstat kernel] per {MODEL}-416 training forward at "
          f"B={TRAIN_BATCH} bf16, summed over the {sum(shapes.values())} "
          f"fused convs ({tot['flops'] / 1e12:.3f} TFLOP): kernel "
          f"{tot['ms']:.3f} ms ({tot['flops'] / tot['ms'] / 1e9:.1f} "
          f"TFLOP/s), bound {tot['bound']:.3f} ms (bytes-bound convs "
          f"{tot['bound_bytes']:.3f}, operations-bound "
          f"{tot['bound_operations']:.3f}), plain {tot['plain']:.2f} ms, "
          f"cuDNN conv + 2 sums {tot['lib']:.3f} ms")
    return max_err, tot


def bnstat_fields(max_err, tots):
    """conv3x3_bnstat's JSON fields: ms, bounds, plain and library times
    summed over the launches of one bf16 step of each model in ``tots``
    (Counters of phases 8 and 19), the worst |y err| of phases 8 and 19."""
    tot = sum(tots, collections.Counter())
    by = ("bytes" if tot["bound_bytes"] >= tot["bound_operations"]
          else "operations")
    return {"max_abs_err": max_err, "ms": tot["ms"], "plain_ms": tot["plain"],
            "bound_ms": tot["bound"], "bound_by": by,
            "library_ms": tot["lib"]}


def train_inputs(cfg, batch, seed):
    """Seeded uint8 images and (B, 30, 5) truths with 8 valid boxes per
    image, drawn as tools/bench_train.py draws them."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (batch, cfg.input_size, cfg.input_size, 3),
                        dtype=np.uint8)
    slots, valid = TRUTHS
    tr = np.zeros((batch, slots, 5), np.float32)
    tr[:, :valid, 0:2] = rng.uniform(0.2, 0.8, (batch, valid, 2))
    tr[:, :valid, 2:4] = rng.uniform(0.05, 0.4, (batch, valid, 2))
    tr[:, :valid, 4] = rng.integers(0, cfg.num_classes, (batch, valid))
    return imgs, tr


def rel_l2(a, b):
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


def grad_floor_check(label, names, g_card, g_alt, g_cpu):
    """Each of ``names`` ((layer, leaf)) of the card's gradients within
    GRAD_FLOOR of the CPU's, against the distance of the card's cuDNN path
    (``g_alt``) from the CPU. Returns a summary for the phase's line."""
    errs = [rel_l2(g_card[k][n], g_cpu[k][n]) for k, n in names]
    floors = [rel_l2(g_alt[k][n], g_cpu[k][n]) for k, n in names]
    mid = statistics.median(floors)
    ratios = [e / max(f, mid, 1e-30) for e, f in zip(errs, floors)]
    worst = max(range(len(names)), key=ratios.__getitem__)
    for (k, n), e, f in zip(names, errs, floors):
        require(e <= GRAD_FLOOR[0] * max(f, mid) + GRAD_FLOOR[1],
                f"{label}: gradient {k}/{n}: relative L2 {e:.3g} from the "
                f"CPU, against {f:.3g} for the cuDNN path (median {mid:.3g})")
    flat = lambda g: torch.cat([g[k][n].flatten() for k, n in names])
    e_all = rel_l2(flat(g_card), flat(g_cpu))
    f_all = rel_l2(flat(g_alt), flat(g_cpu))
    require(e_all <= GRAD_FLOOR[0] * f_all + GRAD_FLOOR[1],
            f"{label}: all gradients: relative L2 {e_all:.3g} against "
            f"{f_all:.3g}")
    return (f"relative L2 per parameter: kernel path median "
            f"{statistics.median(errs):.3g}, max {max(errs):.3g}; cuDNN "
            f"path median {statistics.median(floors):.3g}, max "
            f"{max(floors):.3g}; all parameters {e_all:.3g} vs {f_all:.3g}; "
            f"ratio to the floor median {statistics.median(ratios):.2f}, "
            f"max {ratios[worst]:.2f} at {'/'.join(names[worst])} (limit "
            f"{GRAD_FLOOR[0]} x + {GRAD_FLOOR[1]})")


def train_parity(label, cfg, specs, params, stats, n_fused, dev, *,
                 imgs, tr, seen=0, **loss_kw):
    """One f32 onepass train step on the card against the CPU port from the
    same seeded state: make_train_step's conv_bnstat launches counted (its
    step counter set so that seen = step * batch), then cost, metrics and
    batch statistics within TRAIN_TOL and every gradient within GRAD_FLOOR
    of the CPU's. Returns (launches, card, cuDNN-path and CPU gradients)."""
    from yolo_tensorflow_tpu_torch.models import engine
    from yolo_tensorflow_tpu_torch.ops.kernels import conv_bnstat as BS
    from yolo_tensorflow_tpu_torch.train import loop as TL
    kw = dict(bn_stats="onepass", **loss_kw)
    tx = lambda: TL.make_optimizer(TL.darknet_lr_schedule(1e-3,
                                                          burn_in=1000))

    def grads_on(device):
        st = TL.create_train_state(cfg, tx(), device=device, params=params,
                                   batch_stats=stats, specs=specs)
        g, new, m = TL.loss_and_grads(
            cfg, specs, st.network, torch.as_tensor(imgs, device=device),
            torch.as_tensor(tr, device=device), seen=torch.tensor(seen),
            generator=st.generator, **kw)
        return ({k: {n: v.cpu() for n, v in p.items()} for k, p in g.items()},
                {k: {n: v.cpu() for n, v in p.items()} for k, p in
                 new.items()}, {k: float(v) for k, v in m.items()})

    # the entry point a user calls, with the kernel's launches counted
    opt = tx()
    state = TL.create_train_state(cfg, opt, device=dev, params=params,
                                  batch_stats=stats, specs=specs)
    state.step.fill_(seen // len(imgs))
    step = TL.make_train_step(cfg, opt, specs=specs, **kw)
    torch.cuda.synchronize()
    BS.launches = 0
    state, m = step(state, imgs, tr)
    torch.cuda.synchronize()
    launches = BS.launches
    require(launches == n_fused and np.isfinite(float(m["cost"])),
            f"{label}: make_train_step launched conv_bnstat {launches} times "
            f"(expected {n_fused}), cost {float(m['cost'])}")
    del state, step

    t0 = time.perf_counter()
    g_card, st_card, m_card = grads_on(dev)
    real = engine.uses_conv_bnstat
    engine.uses_conv_bnstat = lambda spec: False   # cuDNN + plain stats
    try:
        g_alt, _, _ = grads_on(dev)
    finally:
        engine.uses_conv_bnstat = real
    t1 = time.perf_counter()
    g_cpu, st_cpu, m_cpu = grads_on("cpu")
    cpu_s = time.perf_counter() - t1
    for key, want in m_cpu.items():
        np.testing.assert_allclose(m_card[key], want, rtol=TRAIN_TOL["rtol"],
                                   err_msg=f"{label}: metric {key}")
    st_err = 0.0
    for k, d in st_cpu.items():
        for n, want in d.items():
            err = (st_card[k][n] - want).abs().max().item()
            lim = TRAIN_TOL["rtol"] * want.abs().max().item() \
                + TRAIN_TOL["atol"]
            require(err <= lim, f"{label}: batch stat {k}/{n}: |err| "
                    f"{err:.3g} > {lim:.3g}")
            st_err = max(st_err, err / max(want.abs().max().item(), 1e-12))
    names = [(k, n) for k in sorted(g_cpu) for n in sorted(g_cpu[k])]
    summary = grad_floor_check(label, names, g_card, g_alt, g_cpu)
    print(f"[{label}] {cfg.name}-{cfg.input_size} B={len(imgs)} onepass, "
          f"seen {seen}: make_train_step "
          f"launched conv_bnstat {launches} times (one per fused conv); "
          f"card vs CPU port ({cpu_s:.1f} s on the CPU, {t1 - t0:.1f} s for "
          f"both card passes): cost {m_card['cost']:.6g} vs "
          f"{m_cpu['cost']:.6g}, metrics within rtol {TRAIN_TOL['rtol']}; "
          f"batch stats within {st_err:.2g} of each leaf's max; gradients, "
          f"{summary}")
    return launches, g_card, g_alt, g_cpu


def train_rate(label, cfg, specs, params, stats, dev, n_fused, smi, *,
               batch, seed, sync_check=False, **step_kw):
    """bf16 onepass training throughput at ``batch``: img/s as the median
    of 3 samples of 5 steps, the step split from CUDA events, peak memory,
    conv_bnstat launches of one step, a finite cost at every step; with
    ``sync_check`` one step under set_sync_debug_mode("error"). Returns
    (launches, the split's dict, median img/s, peak GiB)."""
    from yolo_tensorflow_tpu_torch.ops.kernels import conv_bnstat as BS
    from yolo_tensorflow_tpu_torch.train import loop as TL
    imgs, tr = train_inputs(cfg, batch, seed)
    if cfg.head == 0:
        tr = tr[:, 0, 4]                      # the classifier's labels
    imgs, tr = torch.as_tensor(imgs, device=dev), torch.as_tensor(tr,
                                                                  device=dev)
    tx = TL.make_optimizer(TL.darknet_lr_schedule(1e-3, burn_in=1000))
    state = TL.create_train_state(cfg, tx, device=dev, params=params,
                                  batch_stats=stats, specs=specs)
    events = []

    def mark(name):
        events.append((name, torch.cuda.Event(enable_timing=True)))
        events[-1][1].record()

    step = TL.make_train_step(cfg, tx, specs=specs,
                              compute_dtype=torch.bfloat16,
                              bn_stats="onepass", marks=mark, **step_kw)
    costs = []
    for _ in range(2):                          # warm-up
        state, m = step(state, imgs, tr)
        costs.append(m["cost"])
    torch.cuda.synchronize()
    BS.launches = 0
    if sync_check:
        torch.cuda.set_sync_debug_mode("error")
    try:
        state, m = step(state, imgs, tr)        # the counted step
    finally:
        torch.cuda.set_sync_debug_mode(0)
    costs.append(m["cost"])
    torch.cuda.synchronize()
    launches = BS.launches
    require(launches == n_fused, f"{label}: one step launched conv_bnstat "
            f"{launches} times, expected {n_fused}")
    torch.cuda.reset_peak_memory_stats()
    events.clear()
    step_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            mark("start")
            state, m = step(state, imgs, tr)
            costs.append(m["cost"])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3 / 5)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    split = collections.defaultdict(float)
    for (_, a), (name, b) in zip(events, events[1:]):
        if name != "start":
            split[name] += a.elapsed_time(b) / 15
    costs = torch.stack(costs).cpu().numpy()
    require(np.all(np.isfinite(costs)), f"{label}: cost not finite: "
            f"{costs}")
    rates = sorted(batch * 1e3 / ms for ms in step_ms)
    rate = statistics.median(rates)
    print(f"[{label}] {cfg.name}-{cfg.input_size} B={batch} onepass, "
          f"images on the card: {rate:.1f} "
          f"img/s median of 3 x 5 steps (spread {rates[0]:.1f}.."
          f"{rates[-1]:.1f}), step {statistics.median(step_ms):.2f} ms = "
          f"forward {split['forward']:.2f} + loss {split['loss']:.2f} + "
          f"backward {split['backward']:.2f} + optimizer "
          f"{split['optimizer']:.2f} ms (CUDA events); {launches} "
          f"conv_bnstat launches per step"
          + ("; one step under set_sync_debug_mode('error'): no host sync"
             if sync_check else "")
          + f"; peak memory {peak:.2f} GiB; cost finite at all "
          f"{len(costs)} steps, {costs[0]:.5g} -> {costs[-1]:.5g}; on {smi}")
    return launches, dict(split), rate, peak


def darknet19_bnstat_phase(dev):
    """Phase 19 (A). conv_bnstat against its plain version at Darknet-19's
    shapes, f32 and bf16: every distinct 3x3 stride-1 BN conv of yolov2 at
    each of run_training's multi-scale sizes (320..608, grids 10..19; the
    1280 -> 1024 conv after the route among them) at TRAIN_BATCH, and of
    darknet19-256 at CLS_BATCH. The bf16 shapes of yolov2-416 and
    darknet19-256 are timed: kernel, bound, plain and cuDNN's conv + two
    sums, summed over a training forward's launches. Returns (max |y err|,
    {model: Counter of those sums})."""
    import dataclasses
    from yolo_tensorflow_tpu_torch import config as C
    from yolo_tensorflow_tpu_torch.ops.kernels import conv_bnstat as BS
    from yolo_tensorflow_tpu_torch.train import runner
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    v2, cls = C.get_config("yolov2"), C.get_config("darknet19-classifier")
    v2_specs, cls_specs = C.build_specs(v2), C.build_specs(cls)
    require(v2.input_size in runner.MULTISCALE_SIZES,
            f"{v2.input_size} is not a multi-scale size")
    groups = [("yolov2", s, TRAIN_BATCH, bnstat_shapes(
        v2_specs, dataclasses.replace(v2, input_size=s)))
        for s in runner.MULTISCALE_SIZES] + [
        ("darknet19-classifier", cls.input_size, CLS_BATCH,
         bnstat_shapes(cls_specs, cls))]
    require(any(cin == 1280 for (_, cin, _) in groups[0][3]),
            "yolov2 has no 1280 -> 1024 conv after the route")
    max_err, cases, tots = 0.0, 0, collections.defaultdict(
        collections.Counter)
    used = collections.Counter()
    for model, size, batch, shapes in groups:
        timed = size == C.get_config(model).input_size
        name = f"{model}-{size}"
        for (h, cin, cout), n in sorted(shapes.items(),
                                        key=lambda kv: -kv[0][0]):
            for dtype in (torch.float32, torch.bfloat16):
                x, w, nbytes, flops, library = bnstat_case(
                    gen, dev, batch, h, cin, cout, dtype)
                instance, bn = BS.plan(x, w)
                label = (f"{name} B={batch} {h}^2 {cin}->{cout} "
                         f"{str(dtype)[6:]} {instance} BN={bn}")
                err, s_err, q_err = bnstat_check(
                    label, BS.conv3x3_bnstat_forward(x, w),
                    BS.conv3x3_bnstat_plain(x, w), dtype, batch * h * h)
                max_err, cases = max(max_err, err), cases + 1
                used[(instance, bn)] += 1
                if timed and dtype == torch.bfloat16:
                    ms = cuda_ms(lambda: BS.conv3x3_bnstat_forward(x, w),
                                 iters=10)
                    plain = cuda_ms(lambda: BS.conv3x3_bnstat_plain(x, w),
                                    iters=2, warmup=1)
                    lib = cuda_ms(library, iters=10)
                    bnd, by = bound_ms(nbytes, flops, BF16_OPS_S)
                    print(f"[19 bnstat darknet19] {label} x{n}: equal to "
                          f"plain (max |y err| {err:.3g}, sum {s_err:.2g}, "
                          f"sumsq {q_err:.2g}); kernel {ms:.4f} ms "
                          f"({flops / ms / 1e9:.1f} TFLOP/s), bound "
                          f"{bnd:.4f} ms ({by}), plain {plain:.3f} ms, "
                          f"cuDNN conv + 2 sums {lib:.4f} ms")
                    for key, v in (("ms", ms), ("plain", plain),
                                   ("lib", lib), ("bound", bnd),
                                   (f"bound_{by}", bnd), ("flops", flops)):
                        tots[model][key] += n * v
                del x, w
    grids = [s // 32 for s in runner.MULTISCALE_SIZES]
    print(f"[19 bnstat darknet19] {cases} cases (yolov2 at "
          f"{list(runner.MULTISCALE_SIZES)}, head grids {grids}, B="
          f"{TRAIN_BATCH}; darknet19-256 B={CLS_BATCH}; f32 and bf16) equal "
          f"to plain within BNSTAT_TOL, max |y err| {max_err:.3g}; "
          f"(instance, BN) taken: {dict(used)}")
    for model, tot in tots.items():
        cfg = C.get_config(model)
        batch = CLS_BATCH if cfg.head == 0 else TRAIN_BATCH
        n = sum(next(g[3] for g in groups if g[0] == model
                     and g[1] == cfg.input_size).values())
        print(f"[19 bnstat darknet19] per {model}-{cfg.input_size} training "
              f"forward at B={batch} bf16, summed over the {n} fused convs "
              f"({tot['flops'] / 1e12:.3f} TFLOP): kernel {tot['ms']:.3f} ms "
              f"({tot['flops'] / tot['ms'] / 1e9:.1f} TFLOP/s), bound "
              f"{tot['bound']:.3f} ms (bytes-bound convs "
              f"{tot['bound_bytes']:.3f}, operations-bound "
              f"{tot['bound_operations']:.3f}), plain {tot['plain']:.2f} ms, "
              f"cuDNN conv + 2 sums {tot['lib']:.3f} ms")
    return max_err, dict(tots)


def family_model(name, seed, dropout=None):
    """(cfg, specs, params, stats, fused convs) of a zoo model with seeded
    parameters; ``dropout`` replaces the Dropout layers' rate."""
    import dataclasses
    from yolo_tensorflow_tpu_torch import config as C
    from yolo_tensorflow_tpu_torch.models import engine
    from yolo_tensorflow_tpu_torch.models import specs as S
    cfg = C.get_config(name)
    specs = C.build_specs(cfg)
    if dropout is not None:
        specs = tuple(dataclasses.replace(sp, rate=dropout)
                      if isinstance(sp, S.Dropout) else sp for sp in specs)
    params, stats = engine.init_params(specs, cfg.input_size, seed)
    return cfg, specs, params, stats, sum(bnstat_shapes(specs, cfg).values())


def adam_parity(label, cfg, specs, params, stats, grads, dev):
    """One darknet-Adam update from the same state with each of ``grads``
    = (card kernel path, card cuDNN path, CPU): the first moment and the
    parameter change of the kernel path within GRAD_FLOOR of the CPU's,
    against the cuDNN path's distance; every change at most the rate."""
    from yolo_tensorflow_tpu_torch.train import loop as TL
    rate = 1e-3
    out = []
    for g, device in zip(grads, (dev, dev, "cpu")):
        tx = TL.darknet_adam(lambda s: torch.full((), rate, device=s.device),
                             decay=5e-4, batch=TRAIN_PARITY_BATCH)
        st = TL.create_train_state(cfg, tx, device=device, params=params,
                                   batch_stats=stats, specs=specs)
        before = {k: {n: v.detach().clone() for n, v in p.items()}
                  for k, p in st.params.items()}
        opt = tx.apply_(st.params, {k: {n: v.to(device) for n, v in
                                        p.items()} for k, p in g.items()},
                        st.opt_state)
        require(int(opt.count) == 1, f"{label}: Adam count {opt.count}")
        out.append(({k: {n: v.cpu() for n, v in p.items()}
                     for k, p in opt.m.items()},
                    {k: {n: (v.detach() - before[k][n]).cpu()
                         for n, v in p.items()}
                     for k, p in st.params.items()}))
    names = [(k, n) for k in sorted(out[2][0]) for n in sorted(out[2][0][k])]
    biggest = max(d[k][n].abs().max().item() for _, d in out
                  for k, n in names)
    require(biggest <= rate * (1 + 1e-3), f"{label}: an Adam step of "
            f"{biggest:.3g} exceeds the rate {rate}")
    m_sum = grad_floor_check(f"{label} Adam m", names,
                             *(m for m, _ in out))
    d_sum = grad_floor_check(f"{label} Adam step", names,
                             *(d for _, d in out))
    print(f"[{label}] {cfg.name}-{cfg.input_size} one darknet-Adam update "
          f"(batch {TRAIN_PARITY_BATCH}, decay 5e-4, rate {rate}) from the "
          f"same grads: largest step {biggest:.4g}; first moment, {m_sum}; "
          f"parameter step, {d_sum}")


def families_train_parity_phase(dev):
    """Phase 20 (B). f32 onepass steps of yolov2-416 (region loss, seen 0
    and 12800, then one darknet-Adam update), yolov1-448 (dropout rate 0)
    and darknet19-256 on the card against the CPU port, at
    TRAIN_PARITY_BATCH, as phase 9. Returns the conv_bnstat launches of
    the counted steps."""
    launches = {}
    cfg, specs, params, stats, n_fused = family_model("yolov2", SEED + 20)
    imgs, tr = train_inputs(cfg, TRAIN_PARITY_BATCH, SEED + 20)
    for seen in (0, 12800):
        n, g_card, g_alt, g_cpu = train_parity(
            "20 f32 train", cfg, specs, params, stats, n_fused, dev,
            imgs=imgs, tr=tr, seen=seen)
        if seen == 0:
            adam_parity("20 f32 train", cfg, specs, params, stats,
                        (g_card, g_alt, g_cpu), dev)
        del g_card, g_alt, g_cpu
    launches["yolov2"] = n
    cfg, specs, params, stats, n_fused = family_model("yolov1", SEED + 20,
                                                      dropout=0.0)
    imgs, tr = train_inputs(cfg, TRAIN_PARITY_BATCH, SEED + 20)
    launches["yolov1"] = train_parity("20 f32 train", cfg, specs, params,
                                      stats, n_fused, dev, imgs=imgs,
                                      tr=tr)[0]
    cfg, specs, params, stats, n_fused = family_model(
        "darknet19-classifier", SEED + 20)
    imgs, tr = train_inputs(cfg, TRAIN_PARITY_BATCH, SEED + 20)
    launches["darknet19"] = train_parity("20 f32 train", cfg, specs, params,
                                         stats, n_fused, dev, imgs=imgs,
                                         tr=tr[:, 0, 4])[0]
    return launches


def families_train_rate_phase(dev, smi):
    """Phase 21 (C). bf16 onepass training of yolov2-416 and yolov1-448
    (dropout on) at TRAIN_BATCH and darknet19-256 at CLS_BATCH, one step of
    each under set_sync_debug_mode("error"). Returns {model: (conv_bnstat
    launches of one step, split, img/s, peak GiB)}."""
    out = {}
    for name, batch in (("yolov2", TRAIN_BATCH), ("yolov1", TRAIN_BATCH),
                        ("darknet19-classifier", CLS_BATCH)):
        cfg, specs, params, stats, n_fused = family_model(name, SEED + 21)
        out[name] = train_rate("21 bf16 train", cfg, specs, params, stats,
                               dev, n_fused, smi, batch=batch,
                               seed=SEED + 21, sync_check=True)
        del params, stats
        torch.cuda.empty_cache()
    return out


def scenes(n, seed):
    """n synthetic 480x640 RGB scenes of numpy rectangles on a noisy
    background and their darknet label lines (class cx cy w h)."""
    rng = np.random.default_rng(seed)
    imgs, labels = [], []
    for _ in range(n):
        img = rng.integers(0, 64, (480, 640, 3), dtype=np.uint8)
        rows = []
        for _ in range(int(rng.integers(1, 6))):
            w, h = int(rng.integers(40, 320)), int(rng.integers(40, 240))
            x0 = int(rng.integers(0, 640 - w))
            y0 = int(rng.integers(0, 480 - h))
            img[y0:y0 + h, x0:x0 + w] = rng.integers(64, 256, 3)
            rows.append(f"{int(rng.integers(0, 80))} {(x0 + w / 2) / 640:.6f}"
                        f" {(y0 + h / 2) / 480:.6f} {w / 640:.6f} "
                        f"{h / 480:.6f}")
        imgs.append(img)
        labels.append("\n".join(rows) + "\n")
    return imgs, labels


def run_training_phase(dev, smi, tmp):
    """Phase 22 (D). train/runner.run_training on yolov2-416 from a .cfg
    written by specs_to_cfg (random=1: multi-scale) and seeded .weights,
    bf16 onepass, batch RUN_BATCH, RUN_SCENES synthetic 480x640 scenes
    through read_fn and the native pixel kernel (YOLO_NATIVE_LOADER=1): 30
    steps with a checkpoint every 10, then a second call that resumes to
    step 40, each call launching conv_bnstat for every fused conv of every
    step. img/s with the loader in the loop over steps 11-29, with their
    inter-step idle share 1 - (sum of each step's span between CUDA events
    recorded before and after it / wall time): a gap inside a step counts
    as busy, so this is a lower bound. The card's idle share proper,
    1 - (union of the kernel, memcpy and memset intervals of a
    torch.profiler trace / wall time), over the RUN_TRACED steps."""
    import argparse
    import contextlib
    import io
    from yolo_tensorflow_tpu_torch import config as C
    from yolo_tensorflow_tpu_torch.io import cfg as CF
    from yolo_tensorflow_tpu_torch.io import checkpoint as CK
    from yolo_tensorflow_tpu_torch.io import weights as W
    from yolo_tensorflow_tpu_torch.models import engine
    from yolo_tensorflow_tpu_torch.ops.kernels import conv_bnstat as BS
    from yolo_tensorflow_tpu_torch.train import loop as TL
    from yolo_tensorflow_tpu_torch.train import runner
    root = os.path.join(tmp, "run_training")
    for sub in ("images", "labels"):
        os.makedirs(os.path.join(root, sub))
    cfg = C.get_config("yolov2")
    specs = C.build_specs(cfg)
    n_fused = sum(bnstat_shapes(specs, cfg).values())
    text = CF.specs_to_cfg(cfg, specs, batch=RUN_BATCH)
    require("random=0" in text, "specs_to_cfg wrote no random= line")
    with open(os.path.join(root, "yolov2.cfg"), "w") as f:
        f.write(text.replace("random=0", "random=1"))
    params, stats = engine.init_params(specs, cfg.input_size, SEED + 22)
    W.save_darknet_weights(specs, cfg.input_size, params, stats,
                           os.path.join(root, "yolov2.weights"))
    del params, stats
    imgs, labels = scenes(RUN_SCENES, SEED + 22)
    pixels = {}
    for i, (img, lab) in enumerate(zip(imgs, labels)):
        path = os.path.join(root, "images", f"scene{i:03d}.jpg")
        with open(os.path.join(root, "labels", f"scene{i:03d}.txt"),
                  "w") as f:
            f.write(lab)
        pixels[path] = img
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("\n".join(pixels) + "\n")

    steps, saves, traced = [], [], []
    real_step, real_save = TL.make_train_step, CK.save_train_state
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])

    def timed_step(*a, **k):
        inner = real_step(*a, **k)

        def step(state, images, truths):
            if len(steps) in RUN_TRACED:     # the window leaves out the
                torch.cuda.synchronize()     # profiler's start and stop
                if not traced:
                    prof.start()
                traced.append(time.perf_counter())
                if len(traced) == 2:
                    prof.stop()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = inner(state, images, truths)
            end.record()
            steps.append((t0, start, end, images.shape[1]))
            return out
        return step

    def timed_save(*a, **k):
        t0 = time.perf_counter()
        out = real_save(*a, **k)
        saves.append((t0, time.perf_counter()))
        return out

    def call(n_steps):
        args = argparse.Namespace(
            model=None, cfg=os.path.join(root, "yolov2.cfg"), names=None,
            list=os.path.join(root, "train.txt"), val_list=None,
            weights=os.path.join(root, "yolov2.weights"),
            partial_weights=False, ckpt_dir=os.path.join(root, "ckpt"),
            batch_size=None, steps=n_steps, lr=None, burn_in=None,
            input_size=None, multiscale=False, bf16=True, bn_onepass=True,
            num_data=1, num_spatial=1, cache_images=False, save_every=10,
            log_every=10, device=str(dev))
        out = io.StringIO()
        first = len(steps)
        BS.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            state = runner.run_training(args, read_fn=pixels.__getitem__)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for line in out.getvalue().splitlines():
            print(f"[22 run_training] {line}")
        taken = len(steps) - first
        require(BS.launches == n_fused * taken > 0,
                f"run_training launched conv_bnstat {BS.launches} times in "
                f"{taken} steps, expected {n_fused} a step")
        print(f"[22 run_training] steps {first + 1}-{len(steps)}: "
              f"{BS.launches} conv_bnstat launches ({n_fused} a step)")
        return state, out.getvalue(), wall

    os.environ["YOLO_NATIVE_LOADER"] = "1"
    TL.make_train_step, CK.save_train_state = timed_step, timed_save
    try:
        state, log1, wall1 = call(30)
        require(int(state.step) == 30, f"first call ended at step "
                f"{int(state.step)}")
        del state
        torch.cuda.empty_cache()
        # steps 11..29, each timed from its start to the next one's: the
        # host interval holds the loader's wait, the step, and at step 20
        # the checkpoint save.
        torch.cuda.synchronize()
        seen_sizes, rows = set(), []
        for i, (t0, s, e, size) in enumerate(steps[:30]):
            first = size not in seen_sizes
            seen_sizes.add(size)
            if 10 <= i < 29:
                wall = steps[i + 1][0] - t0
                save = sum(b - a for a, b in saves
                           if t0 <= a < steps[i + 1][0])
                rows.append((wall, save, s.elapsed_time(e) / 1e3, first))
        sizes = sorted(seen_sizes)
        state, log2, wall2 = call(40)
    finally:
        TL.make_train_step, CK.save_train_state = real_step, real_save
        os.environ.pop("YOLO_NATIVE_LOADER", None)
    costs = [float(line.split("cost ")[1].split()[0])
             for line in (log1 + log2).splitlines()
             if line.startswith("step ")]
    with open(os.path.join(root, "ckpt", "latest.json")) as f:
        latest = json.load(f)
    require("resumed from step 30" in log2 and latest["step"] == 40
            and int(state.step) == 40 and len(costs) == 4
            and np.all(np.isfinite(costs)) and len(sizes) > 1,
            f"run_training: resumed? {'resumed from step 30' in log2}, "
            f"latest.json {latest}, step {int(state.step)}, costs {costs}, "
            f"sizes {sizes}")
    span = sum(r[0] for r in rows)
    save_s = sum(r[1] for r in rows)
    busy = sum(r[2] for r in rows)
    steady = [r for r in rows if not r[3] and not r[1]]
    firsts = [r for r in rows if r[3]]
    s_wall, s_busy = sum(r[0] for r in steady), sum(r[2] for r in steady)
    rate = RUN_BATCH * len(rows) / span
    # the traced steps: both syncs lie outside them, so every device
    # interval of theirs is in the trace and within the wall window
    dev_busy, n_spans = device_busy(prof, os.path.join(
        tmp, "run_training_trace.json"))
    t_wall = traced[1] - traced[0]
    t_steps = steps[RUN_TRACED[0]:RUN_TRACED[1]]
    t_span = sum(s.elapsed_time(e) / 1e3 for _, s, e, _ in t_steps)
    require(len(traced) == 2 and 0 < dev_busy < t_wall,
            f"run_training's trace: {n_spans} device intervals, "
            f"{dev_busy:.3f} s of {t_wall:.3f} s wall")
    print(f"[22 run_training] yolov2-416 from a cfg (random=1) and seeded "
          f".weights, bf16 onepass B={RUN_BATCH}, {RUN_SCENES} scenes of "
          f"480x640 via read_fn + the native kernel: 30 steps in "
          f"{wall1:.1f} s (sizes {sizes}), then resumed from step 30 to 40 "
          f"in {wall2:.1f} s; latest.json {latest}; cost {costs}")
    print(f"[22 run_training] steps 11-29 with the loader in the loop, "
          f"cudnn.benchmark {torch.backends.cudnn.benchmark}: {rate:.1f} "
          f"img/s ({span / len(rows) * 1e3:.1f} ms a step), the steps' "
          f"spans between CUDA events {busy:.2f} s of {span:.2f} s wall, "
          f"inter-step idle share {1 - busy / span:.3f}; of the wall the "
          f"checkpoint save {save_s:.2f} s and {len(firsts)} steps first at "
          f"their size (span "
          f"{sum(r[2] for r in firsts) / max(len(firsts), 1) * 1e3:.0f} ms "
          f"each); the other {len(steady)} steps: "
          f"{RUN_BATCH * len(steady) / s_wall:.1f} img/s, "
          f"{s_wall / len(steady) * 1e3:.1f} ms a step, span "
          f"{s_busy / len(steady) * 1e3:.1f} ms, inter-step idle share "
          f"{1 - s_busy / s_wall:.3f}; on {smi}")
    print(f"[22 run_training] steps {RUN_TRACED[0] + 1}-{RUN_TRACED[1]} "
          f"traced by torch.profiler (CUDA activity only) at "
          f"{t_steps[0][3]}^2: {RUN_BATCH * len(t_steps) / t_wall:.1f} img/s "
          f"({t_wall / len(t_steps) * 1e3:.1f} ms a step); device busy "
          f"(union of {n_spans} kernel, memcpy and memset intervals) "
          f"{dev_busy * 1e3 / len(t_steps):.1f} ms a step, idle share "
          f"{1 - dev_busy / t_wall:.3f}; spans between CUDA events "
          f"{t_span / len(t_steps) * 1e3:.1f} ms a step, inter-step idle "
          f"share {1 - t_span / t_wall:.3f}")
    return rate, 1 - dev_busy / t_wall


def crafted_region_params(cfg, specs):
    """Darknet-form parameters of the hand-made yolov2 head (CRAFTED): every
    array zero, BN an identity (gamma 1, mean 0, var 1), each conv's centre
    tap 1 from the channel that carries the input's red channel (followed
    through routes; the reorg branch carries none) to its output channel 0,
    and the head conv's objectness and class biases per CRAFTED with the
    objectness weight 1 on that channel."""
    from yolo_tensorflow_tpu_torch.models import engine
    from yolo_tensorflow_tpu_torch.models import specs as S
    size = cfg.input_size
    params, stats = engine.init_params(specs, size, SEED)
    shapes = engine.infer_shapes(specs, (1, size, size, 3))
    carrier = []             # per layer: the channel that carries the signal
    for i, spec in enumerate(specs):
        key = engine.layer_key(i)
        prev = carrier[i - 1] if i else 0
        if isinstance(spec, S.Conv):
            p = params[key]
            for v in p.values():
                v[...] = 0
            if spec.bn:
                p["gamma"][:] = 1
                stats[key]["mean"][:] = 0
                stats[key]["var"][:] = 1
            if isinstance(specs[i + 1], S.Detect):
                row = 5 + cfg.num_classes          # anchor-major blocks
                for anchor, cls, obj, logit in CRAFTED:
                    p["w"][anchor * row + 4, prev, 0, 0] = 1
                    p["b"][anchor * row + 4] = obj
                    p["b"][anchor * row + 5 + cls] = logit
                carrier.append(None)
            elif prev is None:
                carrier.append(None)
            else:
                p["w"][0, prev, spec.size // 2, spec.size // 2] = 1
                carrier.append(0)
        elif isinstance(spec, S.Route):
            offset, found = 0, None
            for r in spec.refs:
                j = S.resolve_ref(r, i)
                if found is None and carrier[j] is not None:
                    found = offset + carrier[j]
                offset += shapes[j][3]
            carrier.append(found)
        elif isinstance(spec, S.Reorg):
            carrier.append(None)
        else:
            carrier.append(prev)
    return params, stats


def crafted_images(batch, size):
    """uint8 images whose red channel is constant over each 32 x 32 cell
    and distinct between cells: 16 * column + row, and the transpose."""
    cell = np.arange(size) // 32
    red = 16 * cell[None, :] + cell[:, None]
    imgs = np.zeros((batch, size, size, 3), np.uint8)
    for i in range(batch):
        imgs[i, :, :, 0] = red if i % 2 == 0 else red.T
    return imgs


def check_crafted(label, got, imgs, cfg):
    """The hand-made head's Detections against their hand-computed values:
    each box an anchor-0 or anchor-4 box on its cell's centre, score
    sigmoid(objectness) * softmax best within 1e-3."""
    grid = cfg.input_size // 32
    worst = 0.0
    # every anchor-0 box is kept (they do not overlap), so num is D
    want_num = min(cfg.max_detections, grid * grid)
    require(np.all(got.num >= want_num),
            f"{label}: num {got.num}, expected at least {want_num} each")
    for img, n in enumerate(got.num):
        for box, score, cls in zip(got.boxes[img, :n], got.scores[img, :n],
                                   got.classes[img, :n]):
            anchor, _, obj, logit = {c[1]: c for c in CRAFTED}[int(cls)]
            cx, cy = (box[0] + box[2]) / 2, (box[1] + box[3]) / 2
            col, row = int(cx * grid), int(cy * grid)
            red = int(imgs[img, 32 * row, 32 * col, 0])
            best = 1.0 / (1.0 + (cfg.num_classes - 1) * np.exp(-logit))
            want = best / (1.0 + np.exp(-(obj + red / 255.0)))
            aw, ah = cfg.anchors[anchor]
            require(abs(cx - (col + 0.5) / grid) < 1e-5
                    and abs(cy - (row + 0.5) / grid) < 1e-5
                    and abs(box[2] - box[0] - aw / grid) < 1e-5
                    and abs(box[3] - box[1] - ah / grid) < 1e-5,
                    f"{label}: box {box} is not anchor {anchor} on cell "
                    f"({row}, {col})")
            worst = max(worst, abs(float(score) - want))
    require(worst < 1e-3, f"{label}: scores {worst:.3g} from the hand-"
            "computed ones")
    print(f"[{label}] hand-made head at threshold {cfg.conf_threshold}: "
          f"num {got.num.tolist()}, classes "
          f"{sorted(set(got.classes[got.valid].tolist()))}, each box the "
          f"anchor's on its cell's centre, scores "
          f"{got.scores.min():.5f}..{got.scores.max():.5f} within "
          f"{worst:.2g} of the hand-computed ones")


def family_phases(name, numbers, dev, kind, smi, tmp):
    """Phases 11-12 (yolov2) and 13 (yolov1): the f32 Detector at batch
    PARITY_BATCH on the card against the CPU port, with the decode kernel's
    launches counted around one forward, then bf16 serving at SERVE_BATCH
    with its split and the device time of the layers this family adds.
    ``numbers`` = (f32 phase label, bf16 phase label). Returns the decode
    launches of the counted forward and the path of the seeded .weights
    file, written into ``tmp``. yolov2 also runs the hand-made head
    (CRAFTED) at its own threshold of 0.5 beside the seeded weights."""
    from yolo_tensorflow_tpu_torch import config as C
    from yolo_tensorflow_tpu_torch.io import weights as W
    from yolo_tensorflow_tpu_torch.models import engine
    from yolo_tensorflow_tpu_torch.models import specs as S
    from yolo_tensorflow_tpu_torch.ops import layers as L
    from yolo_tensorflow_tpu_torch.ops.kernels import decode as K
    from yolo_tensorflow_tpu_torch.ops.kernels import nms as NK
    from yolo_tensorflow_tpu_torch.pipeline import Detector
    from yolo_tensorflow_tpu_torch.post import nms as NMS
    f32, bf16 = numbers
    size_bias, conf = REGION[name]
    cfg = C.get_config(name)
    specs = C.build_specs(cfg)
    size = cfg.input_size
    want_launches = 0 if cfg.head == 1 else 1
    path = os.path.join(tmp, f"{name}-seed{SEED}.weights")
    params, stats = engine.init_params(specs, size, SEED,
                                       size_bias=size_bias)
    W.save_darknet_weights(specs, size, params, stats, path)
    mbytes = os.path.getsize(path) / 2 ** 20
    del params, stats
    rng = np.random.default_rng(SEED + 11)
    imgs = rng.integers(0, 256, (PARITY_BATCH, size, size, 3),
                        dtype=np.uint8)
    torch.backends.cudnn.benchmark = False
    gpu = Detector(name, path, device="cuda", conf_threshold=conf)
    gpu.detect_batch(imgs)                 # warm-up, outside the count
    torch.cuda.synchronize()
    K.launches = NK.launches = 0
    got = gpu.detect_batch(imgs)           # f32, TF32 off in the network
    torch.cuda.synchronize()
    launches = K.launches
    require(launches == want_launches and NK.launches == 1,
            f"{name}: the decode kernel launched {launches} times in one "
            f"forward (expected {want_launches}), NMS {NK.launches} "
            "(expected 1)")
    cpu = Detector(name, path, device="cpu", conf_threshold=conf)
    t0 = time.perf_counter()
    want = NMS.fetch_detections(cpu.detect_batch(imgs))
    cpu_s = time.perf_counter() - t0
    check_detections(f32, gpu, imgs, NMS.fetch_detections(got), want, cfg,
                     kind, conf)
    print(f"[{f32}] {name}-{size} from a seeded {mbytes:.0f} MiB "
          f".weights file: decode kernel launches {launches} "
          + ("(the grid head decodes in plain PyTorch)" if cfg.head == 1
             else "(softmax classes, one launch)")
          + f"; the CPU port took {cpu_s:.1f} s")
    del gpu, cpu

    if name == "yolov2":
        # the hand-made head, at the model's own threshold
        crafted = os.path.join(tmp, f"{name}-crafted.weights")
        W.save_darknet_weights(specs, size,
                               *crafted_region_params(cfg, specs),
                               crafted)
        imgs = crafted_images(PARITY_BATCH, size)
        gpu = Detector(name, crafted, device="cuda")
        got = NMS.fetch_detections(gpu.detect_batch(imgs))
        cpu = Detector(name, crafted, device="cpu")
        check_detections(f"{f32} hand-made", gpu, imgs, got,
                         NMS.fetch_detections(cpu.detect_batch(imgs)),
                         cfg, kind, cfg.conf_threshold)
        check_crafted(f"{f32} hand-made", got, imgs, cfg)
        del gpu, cpu

    torch.backends.cudnn.benchmark = True
    det = Detector(name, path, device="cuda",
                   compute_dtype=torch.bfloat16, conf_threshold=conf)
    x = torch.as_tensor(rng.integers(0, 256, (SERVE_BATCH, size, size, 3),
                                     dtype=np.uint8), device=dev)
    torch.cuda.reset_peak_memory_stats()
    step_ms, rates, out = serve_rate(lambda: det.detect_batch(x), len(x))
    out = NMS.fetch_detections(out)
    require(np.isfinite(out.boxes).all() and np.all(out.num > 0),
            f"{name} bf16 detections empty or not finite")
    counted_forward(bf16, lambda: det.detect_batch(x),
                    decode=want_launches, nms=1)
    net_ms, dec_ms, nms_ms, _ = step_split(det, x, cfg, conf)
    how = "plain PyTorch" if cfg.head == 1 else "the kernel"
    with torch.inference_mode():
        # the layers this family adds, at the shapes the forward gives them
        shapes = engine.infer_shapes(specs, (SERVE_BATCH, size, size, 3))
        extra = []
        for i, spec in enumerate(specs):
            if isinstance(spec, S.Reorg):
                b, h, w, c = shapes[i - 1]
                t = torch.randn((b, c, h, w), device=dev).to(
                    torch.bfloat16).contiguous(
                        memory_format=torch.channels_last)
                ms = cuda_ms(lambda: L.darknet_reorg(t, spec.stride))
                extra.append(f"darknet_reorg {h}^2 x {c} -> "
                             f"{shapes[i][1]}^2 x {shapes[i][3]}: {ms:.4f} ms")
            elif isinstance(spec, S.Dense):
                layer = det.network.dense[engine.layer_key(i)]
                t = torch.randn((SERVE_BATCH, layer.w.shape[0]),
                                device=dev).to(layer.w.dtype)
                ms = cuda_ms(lambda: layer(t))
                extra.append(f"dense {layer.w.shape[0]} -> "
                             f"{layer.w.shape[1]} ({str(layer.w.dtype)[6:]} "
                             f"weights): {ms:.4f} ms")
    step = statistics.median(step_ms)
    print(f"[{bf16}] {name} detect_batch B={SERVE_BATCH} at {size}, images "
          f"on the card: {statistics.median(rates):.1f} img/s median of 3 x "
          f"5 steps (spread {min(rates):.1f}..{max(rates):.1f}), step "
          f"{step:.2f} ms; backbone {net_ms:.2f} ms, decode {dec_ms:.4f} ms "
          f"({how}), NMS {nms_ms:.4f} ms (device: candidate sort + the "
          f"kernel), the "
          f"rest {step - net_ms - dec_ms - nms_ms:.2f} ms; "
          f"{'; '.join(extra)}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; mean num "
          f"{out.num.mean():.1f}; on {smi}")
    return launches, path


def nms_odd_case(name, rng, dev):
    """(boxes, scores, labels) on the card and the NMS options of one odd
    case of NMS_ODD; scores distinct (tests/test_torch_nms.py builds the
    same cases)."""
    def random(batch=3, n=300):
        centers = rng.uniform(0.4, 0.6, (batch, n, 2))    # heavy overlap
        half = rng.uniform(0.05, 0.2, (batch, n, 2))
        boxes = np.concatenate([centers - half, centers + half], -1)
        scores = rng.permutation(batch * n).reshape(batch, n) / (batch * n)
        return boxes, scores, rng.integers(0, 4, (batch, n))

    def fixed(boxes, scores):
        return np.asarray([boxes]), np.asarray([scores]), np.zeros(
            (1, len(scores)))

    kw = {}
    if name == "batch 1":
        b, s, c = random(batch=1)
    elif name == "K > N":
        b, s, c = random(n=98)
        kw = dict(num_candidates=256)
    elif name == "D > K":
        b, s, c = random()
        kw = dict(num_candidates=8, max_detections=20)
    elif name == "none active":
        b, s, c = random()
        s = s * 0.29
    elif name == "all active":
        b, s, c = random(n=64)
        s = s + 0.5
    elif name == "chain":
        # A suppresses B (IoU 1/3), B would suppress C: A and C are kept
        b, s, c = fixed([[0, 0, 2, 1], [1, 0, 3, 1], [2, 0, 4, 1],
                         [5, 5, 6, 6]], [0.9, 0.8, 0.7, 0.6])
        kw = dict(iou_threshold=0.3)
    elif name == "IoU at the threshold":
        # IoU exactly 0.5 is no overlap (> thr); 0.5 + 2**-10 is
        b, s, c = fixed([[0, 0, 1, 1], [0, 0, 1, 0.5],
                         [0, 0, 1, 0.5009765625], [0, 0, 1, 1]],
                        [0.9, 0.8, 0.7, 0.6])
        kw = dict(iou_threshold=0.5)
    elif name == "degenerate":
        b, s, c = random(n=64)
        b[:, ::4, 2] = b[:, ::4, 0]                    # zero width
        b[:, 1::4, 3] = b[:, 1::4, 1]                  # zero height
        b[:, 2::4, [0, 2]] = b[:, 2::4, [2, 0]]        # inverted in x
        b[:, 3::8, :] = 0.0                            # a point at 0
    else:                                              # "K = 8" ...
        k = int(name.split()[-1])
        b, s, c = random(n=max(k, 1200) if k > 300 else 300)
        kw = dict(num_candidates=k)
    return ((torch.as_tensor(b, dtype=torch.float32, device=dev),
             torch.as_tensor(s, dtype=torch.float32, device=dev),
             torch.as_tensor(c, dtype=torch.int32, device=dev)),
            dict(NMS_ODD_KW, **kw))


def nms_check(label, candidates, kw):
    """One batched_nms_scored (exactly one kernel launch) against
    batched_nms_scored_plain on the same CUDA tensors: all five fields
    exactly equal. Returns the kernel's Detections."""
    from yolo_tensorflow_tpu_torch.ops.kernels import nms as NK
    from yolo_tensorflow_tpu_torch.post import nms as NMS
    before = NK.launches
    got = NMS.batched_nms_scored(*candidates, **kw)
    count = NK.launches - before
    want = NMS.batched_nms_scored_plain(*candidates, **kw)
    torch.cuda.synchronize()
    require(count == 1, f"{label}: batched_nms_scored launched the NMS "
            f"kernel {count} times, expected 1")
    for field in NMS.Detections._fields:
        require(torch.equal(getattr(got, field), getattr(want, field)),
                f"{label}: kernel != plain in {field}")
    return got


def nms_ious(top, kw):
    """IoUs the greedy walk of this data needs: for each of an image's
    first D - 1 kept candidates, one with each later active candidate."""
    from yolo_tensorflow_tpu_torch.ops.kernels import nms as NK
    boxes, scores, labels = top
    keep = NK.greedy_keep_plain(
        boxes, scores, labels, conf_threshold=kw["conf_threshold"],
        iou_threshold=kw["iou_threshold"], class_aware=kw["class_aware"])
    active = (scores > kw["conf_threshold"]).int()
    later = active.flip(1).cumsum(1).flip(1) - active   # active j > i
    walks = keep & (keep.int().cumsum(1) < kw["max_detections"])
    return int((later * walks).sum()), int(active.sum()), int(keep.sum())


def nms_kernel_phase(decoded, cfg, dev):
    """Phase 14. The NMS kernel against its plain version at the main
    path's shapes (phase 5's decode of yolov3-416, batch 64) and the odd
    cases; times at the main path. Returns the kernel's JSON fields."""
    from yolo_tensorflow_tpu_torch.ops.kernels import nms as NK
    from yolo_tensorflow_tpu_torch.post import nms as NMS
    boxes, scores, labels = decoded
    batch, n = scores.shape
    fields = None
    for conf in (CONF, 0.05):
        for aware in (False, True):
            kw = dict(conf_threshold=conf, iou_threshold=cfg.iou_threshold,
                      max_detections=cfg.max_detections, num_candidates=256,
                      class_aware=aware)
            got = nms_check(f"NMS B={batch} N={n} conf {conf} class-aware "
                            f"{aware}", decoded, kw)
            top = NMS.select_candidates(boxes, scores, labels,
                                        conf_threshold=conf,
                                        num_candidates=256)
            sel_kw = {k: v for k, v in kw.items() if k != "num_candidates"}
            topk_ms = cuda_ms(lambda: NMS.select_candidates(
                boxes, scores, labels, conf_threshold=conf,
                num_candidates=256), ahead_cycles=SPIN)
            ms = cuda_ms(lambda: NK.greedy_select(*top, **sel_kw),
                         ahead_cycles=SPIN)
            plain_ms = statistics.median(
                wall_ms(lambda: NK.greedy_select_plain(*top, **sel_kw), 3)
                for _ in range(3))
            whole_ms = wall_ms(lambda: NMS.batched_nms_scored_plain(
                boxes, scores, labels, **kw), 3)
            loop_ms = wall_ms(lambda: [NMS.batched_nms_scored_plain(
                boxes[i:i + 1], scores[i:i + 1], labels[i:i + 1], **kw)
                for i in range(batch)], 1)
            ious, active, kept = nms_ious(top, kw)
            k = top[1].shape[1]
            d = cfg.max_detections
            nbytes = batch * (k * 24 + d * 25 + 4)
            bnd, by = bound_ms(nbytes, ious * NMS_FLOPS + batch * k * 3,
                               F32_OPS_S)
            print(f"[14 nms kernel] {MODEL}-{cfg.input_size} decode "
                  f"B={batch} N={n} K={k} "
                  f"D={d} conf {conf} class-aware {aware}: kernel == plain in "
                  f"all five fields, 1 launch; {active} active candidates, "
                  f"{kept} kept, num {got.num.sum().item()} in all; "
                  f"candidate sort + gathers {topk_ms:.4f} ms, kernel "
                  f"{ms:.4f} ms (device, "
                  f"host kept ahead); bound {bnd:.6f} ms ({by}: {nbytes} bytes, "
                  f"{ious} IoUs walked, K^2/2 = {batch * k * k // 2} at "
                  f"most); plain greedy step {plain_ms:.2f} ms, plain top-k "
                  f"+ greedy {whole_ms:.2f} ms, the former per-image loop "
                  f"{loop_ms:.1f} ms (host clock, they sync)")
            if conf == CONF and not aware:
                fields = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
                          "bound_by": by, "library_ms": None}
    rng = np.random.default_rng(SEED + 14)
    cases = 0
    for name in NMS_ODD:
        for aware in (False, True):
            candidates, kw = nms_odd_case(name, rng, dev)
            got = nms_check(f"odd NMS case {name!r} class-aware {aware}",
                            candidates, dict(kw, class_aware=aware))
            if name == "chain":
                require(got.num.tolist() == [3], "chain: C was not kept")
            if name == "IoU at the threshold":
                require(got.num.tolist() == [2], "IoU at the threshold: "
                        f"num {got.num.tolist()}, expected 2")
            cases += 1
    big = NK.shared_bytes(NMS_BIG_K, NMS_ODD_KW["max_detections"])
    candidates, kw = nms_odd_case(f"K = {NMS_BIG_K}", rng, dev)
    nms_check(f"NMS K = {NMS_BIG_K} (dynamic shared memory above 48 KB)",
              candidates, kw)
    print(f"[14 nms kernel] {cases} odd cases ({', '.join(NMS_ODD)}; each "
          f"class-aware off and on) and K = {NMS_BIG_K} ({big} bytes of "
          "shared memory): one launch each, equal to plain in all five "
          "fields")
    return {"max_abs_err": 0.0, **fields}


def fused_check(label, det, cpu, canvas, sizes, got, want, scores_fn=None):
    """Fused-letterbox Detections of the card against the CPU port's, per
    image: num, classes and valid equal, pixel boxes and scores within
    FUSED_TOL, unless the image's active top-256 scores hold exact ties
    (then the comparison would depend on tie order: such an image is held
    only to finite boxes inside it). ``scores_fn``: the card's scores
    before NMS of the letterboxed input, where they are not its plain
    decode's (TTA). The letterbox itself within
    LETTERBOX_TOL of the CPU port's. Returns max |err| of boxes."""
    from yolo_tensorflow_tpu_torch.models import heads
    from yolo_tensorflow_tpu_torch.ops import preprocess as P
    from yolo_tensorflow_tpu_torch.pipeline import normalization_fold
    cfg = det.cfg
    rescale, offset = normalization_fold(cfg)
    lb = [P.letterbox_device_batch(torch.as_tensor(canvas, device=d),
                                   torch.as_tensor(sizes, device=d),
                                   cfg.input_size, rescale=rescale,
                                   offset=offset)
          for d in (det.device, cpu.device)]
    lb_err = (lb[0].cpu() - lb[1]).abs().max().item()
    lb_diff = int((lb[0].cpu() != lb[1]).sum())
    require(lb_err <= LETTERBOX_TOL, f"{label}: letterbox card vs CPU "
            f"{lb_err:.3g}")
    if scores_fn is not None:           # the card's scores before NMS
        scores = scores_fn(lb[0])
    else:
        with torch.inference_mode():
            scores = heads.decode_scored(det.network(lb[0]), cfg)[1]
    top = torch.topk(scores, min(256, scores.shape[1]), dim=1).values
    err, compared = 0.0, []
    for i, row in enumerate(top):
        active = row[row > cfg.conf_threshold]
        h, w = sizes[i]
        require(np.isfinite(got.boxes[i]).all()
                and (got.boxes[i][:, [0, 2]] <= w).all()
                and (got.boxes[i][:, [1, 3]] <= h).all()
                and (got.boxes[i] >= 0).all(),
                f"{label}: image {i} boxes not finite or outside the image")
        if torch.unique(active).numel() < active.numel():
            print(f"[{label}] image {i} ({h}x{w}): exact ties among its "
                  f"{active.numel()} active top scores; num {got.num[i]} on "
                  f"the card, {want.num[i]} on the CPU; boxes finite and "
                  "inside the image")
            continue
        compared.append(i)
        for name in ("num", "classes", "valid"):
            require(np.array_equal(getattr(got, name)[i],
                                   getattr(want, name)[i]),
                    f"{label}: image {i}: card and CPU {name} differ")
        for name in ("boxes", "scores"):
            np.testing.assert_allclose(getattr(got, name)[i],
                                       getattr(want, name)[i], **FUSED_TOL)
        err = max(err, float(np.abs(got.boxes[i] - want.boxes[i]).max()))
    require(compared and sum(got.num[i] for i in compared) > 0,
            f"{label}: no image with detections to compare")
    print(f"[{label}] canvas {canvas.shape[1]}, images (h, w) "
          f"{[tuple(v) for v in sizes.tolist()]}: letterbox card vs CPU max "
          f"|err| {lb_err:.3g} ({lb_diff} values differ); Detections of "
          f"images {compared} equal to the CPU port (num {got.num.tolist()}), "
          f"max |err| of pixel boxes {err:.3g} (tol {FUSED_TOL})")
    return err


def fused_canvases(rng, side, sizes):
    canvas = np.zeros((len(sizes), side, side, 3), np.uint8)
    for i, (h, w) in enumerate(sizes):
        canvas[i, :h, :w] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    return canvas, np.asarray(sizes, np.int32)


def letterbox_phase(cfg, path, qparams, n_int8, dev, smi):
    """Phase 15, the fused letterbox: f32 against the CPU port, bf16 serving
    at SERVE_BATCH with its split, one int8 bf16 step."""
    from yolo_tensorflow_tpu_torch.ops import preprocess as P
    from yolo_tensorflow_tpu_torch.ops.kernels import decode as K
    from yolo_tensorflow_tpu_torch.pipeline import (Detector,
                                                    normalization_fold)
    from yolo_tensorflow_tpu_torch.post import nms as NMS
    rng = np.random.default_rng(SEED + 15)
    torch.backends.cudnn.benchmark = False
    gpu = Detector(MODEL, path, device="cuda", conf_threshold=CONF,
                   letterbox=True, fused=True)
    cpu = Detector(MODEL, path, device="cpu", conf_threshold=CONF,
                   letterbox=True, fused=True)
    for side, sizes in LETTERBOX_PARITY:
        canvas, sz = fused_canvases(rng, side, sizes)
        got = NMS.fetch_detections(gpu.detect_batch_fused(canvas, sz))
        want = NMS.fetch_detections(cpu.detect_batch_fused(canvas, sz))
        fused_check("15 fused f32", gpu, cpu, canvas, sz, got, want)
    del gpu, cpu

    torch.backends.cudnn.benchmark = True
    side, (h, w) = LETTERBOX_SERVE
    canvas, sz = fused_canvases(rng, side, [(h, w)] * SERVE_BATCH)
    canvas = torch.as_tensor(canvas, device=dev)
    sz = torch.as_tensor(sz, device=dev)
    det = Detector(MODEL, path, device="cuda", compute_dtype=torch.bfloat16,
                   conf_threshold=CONF, letterbox=True, fused=True)
    require(det.letterbox_dtype == torch.bfloat16,
            "bf16 serving did not default to the bf16 letterbox")
    torch.cuda.reset_peak_memory_stats()
    step_ms, rates, out = serve_rate(
        lambda: det.detect_batch_fused(canvas, sz), SERVE_BATCH)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    out = NMS.fetch_detections(out)
    require(np.isfinite(out.boxes).all() and np.all(out.num > 0),
            "fused bf16 detections empty or not finite")
    counted_forward("15 fused bf16", lambda: det.detect_batch_fused(
        canvas, sz), decode=1, nms=1)
    rescale, offset = normalization_fold(cfg)
    size = cfg.input_size
    with torch.inference_mode():
        def letterbox():
            return P.letterbox_device_batch(
                canvas, sz, size, compute_dtype=torch.bfloat16,
                rescale=rescale, offset=offset)
        lb_ms = cuda_ms(letterbox, iters=10)
        x = letterbox().to(torch.bfloat16)
        net_ms = cuda_ms(lambda: det.network(x), iters=5)
        feats = det.network(x)
        dec_ms = cuda_ms(lambda: K.decode_fused(feats, cfg),
                         ahead_cycles=SPIN)
        decoded = K.decode_fused(feats, cfg)
        nms_ms = cuda_ms(lambda: NMS.batched_nms_scored(
            *decoded, conf_threshold=CONF, iou_threshold=cfg.iou_threshold,
            max_detections=cfg.max_detections), ahead_cycles=SPIN)
        dets = NMS.batched_nms_scored(
            *decoded, conf_threshold=CONF, iou_threshold=cfg.iou_threshold,
            max_detections=cfg.max_detections)
        unmap_ms = cuda_ms(lambda: P.unmap_boxes_device(
            dets.boxes, sz[:, 0], sz[:, 1], size), ahead_cycles=SPIN)
    step = statistics.median(step_ms)
    parts = lb_ms + net_ms + dec_ms + nms_ms + unmap_ms
    print(f"[15 fused bf16] detect_batch_fused B={SERVE_BATCH}, {h}x{w} "
          f"frames in {side}^2 canvases on the card, bf16 letterbox: "
          f"{statistics.median(rates):.1f} img/s median of 3 x 5 steps "
          f"(spread {min(rates):.1f}..{max(rates):.1f}), step {step:.2f} ms; "
          f"letterbox {lb_ms:.3f} + backbone {net_ms:.2f} + decode "
          f"{dec_ms:.4f} + NMS {nms_ms:.4f} + unmap {unmap_ms:.4f} = "
          f"{parts:.2f} ms (device), the rest {step - parts:.2f} ms; peak "
          f"memory {peak:.2f} GiB; mean num {out.num.mean():.1f}; on {smi}")
    del det

    det = Detector(MODEL, params=qparams, device="cuda",
                   compute_dtype=torch.bfloat16, conf_threshold=CONF,
                   letterbox=True, fused=True)
    require(det.letterbox_dtype == torch.bfloat16,
            "int8 params did not default to the bf16 letterbox")
    det.detect_batch_fused(canvas, sz)          # warm-up
    out = NMS.fetch_detections(counted_forward(
        "15 fused int8 bf16", lambda: det.detect_batch_fused(canvas, sz),
        int8=n_int8, decode=1, nms=1))
    require(np.isfinite(out.boxes).all() and np.all(out.num > 0),
            "fused int8 detections empty or not finite")
    ms = wall_ms(lambda: det.detect_batch_fused(canvas, sz), 3)
    print(f"[15 fused int8 bf16] B={SERVE_BATCH}: the bf16 letterbox (the "
          f"default for int8 params) into the int8 network, {ms:.2f} ms a "
          f"step over 3 steps; mean num {out.num.mean():.1f}")


def tta_scores(det, x_norm, mode):
    """The scores a TTA Detector hands to NMS for normalized input (the
    port's own pipeline.tta_decode): what the tie check reads."""
    from yolo_tensorflow_tpu_torch.pipeline import tta_decode
    with torch.inference_mode():
        return tta_decode(det.network, x_norm.to(det.network.dtype), det.cfg,
                          mode)[1]


def tta_parity(label, name, source, imgs, mode, kind, conf, want):
    """Detector(name, tta=True, tta_mode=mode) at float32 on the card
    against the same on the CPU, ``source`` its weights path or params;
    ``want``: the launches of one forward (counted after a warm-up)."""
    from yolo_tensorflow_tpu_torch.pipeline import Detector, normalize_images
    from yolo_tensorflow_tpu_torch.post import nms as NMS
    kw = dict(conf_threshold=conf, tta=True, tta_mode=mode, **source)
    gpu = Detector(name, device="cuda", **kw)
    gpu.detect_batch(imgs)                      # warm-up, outside the count
    torch.cuda.synchronize()
    reset_counts()
    got = gpu.detect_batch(imgs)
    torch.cuda.synchronize()
    launched = {k: v for k, v in counts().items() if k in want}
    require(launched == want, f"{label}: one forward launched {launched}, "
            f"expected {want}")
    cpu = Detector(name, device="cpu", **kw)
    scores = tta_scores(gpu, normalize_images(
        torch.as_tensor(imgs, device=gpu.device), gpu.cfg), mode)
    check_detections(label, gpu, imgs, NMS.fetch_detections(got),
                     NMS.fetch_detections(cpu.detect_batch(imgs)), gpu.cfg,
                     kind, conf, scores=scores)
    print(f"[{label}] tta_mode {mode!r}: one forward (a doubled batch of "
          f"{2 * len(imgs)}) launched {launched}")


def tta_phase(cfg, path, v2_path, qparams, n_int8, dev, kind, smi):
    """Phase 16, flip-TTA: f32 parity of yolov3 in both modes, yolov2
    (width 13: the darknet mode skips the middle column), int8 params and
    the fused letterbox against the CPU port; bf16 serving at SERVE_BATCH
    with its split."""
    from yolo_tensorflow_tpu_torch.pipeline import (
        Detector, activate_heads, decode_activated, flip_average,
        normalize_images)
    from yolo_tensorflow_tpu_torch.post import nms as NMS
    rng = np.random.default_rng(SEED + 16)
    size = cfg.input_size
    imgs = rng.integers(0, 256, (PARITY_BATCH, size, size, 3),
                        dtype=np.uint8)
    torch.backends.cudnn.benchmark = False
    for mode in ("darknet", "corrected"):
        tta_parity("16 tta f32", MODEL, dict(weights_path=path), imgs, mode,
                   kind, CONF, dict(decode=0, nms=1))
    v2_conf = REGION["yolov2"][1]
    tta_parity("16 tta yolov2 f32", "yolov2", dict(weights_path=v2_path),
               imgs, "darknet", kind, v2_conf, dict(decode=0, nms=1))
    tta_parity("16 tta int8 f32", MODEL, dict(params=qparams), imgs,
               "darknet", kind, CONF, dict(int8=n_int8, decode=0, nms=1))

    # the fused letterbox: the letterboxed tensor is mirrored
    side, sizes = LETTERBOX_PARITY[0]
    canvas, sz = fused_canvases(rng, side, sizes)
    kw = dict(conf_threshold=CONF, letterbox=True, fused=True, tta=True)
    gpu = Detector(MODEL, path, device="cuda", **kw)
    cpu = Detector(MODEL, path, device="cpu", **kw)
    got = NMS.fetch_detections(gpu.detect_batch_fused(canvas, sz))
    want = NMS.fetch_detections(cpu.detect_batch_fused(canvas, sz))
    fused_check("16 tta fused f32", gpu, cpu, canvas, sz, got, want,
                scores_fn=lambda x: tta_scores(gpu, x, "darknet"))
    del gpu, cpu

    torch.backends.cudnn.benchmark = True
    det = Detector(MODEL, path, device="cuda", compute_dtype=torch.bfloat16,
                   conf_threshold=CONF, tta=True)
    x = torch.as_tensor(rng.integers(0, 256, (SERVE_BATCH, size, size, 3),
                                     dtype=np.uint8), device=dev)
    torch.cuda.reset_peak_memory_stats()
    step_ms, rates, out = serve_rate(lambda: det.detect_batch(x), len(x))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    out = NMS.fetch_detections(out)
    require(np.isfinite(out.boxes).all() and np.all(out.num > 0),
            "bf16 TTA detections empty or not finite")
    counted_forward("16 tta bf16", lambda: det.detect_batch(x), decode=0,
                    nms=1)
    with torch.inference_mode():
        xn = normalize_images(x, cfg, torch.bfloat16)
        x2 = torch.cat([xn, torch.flip(xn, dims=[3])]).contiguous(
            memory_format=torch.channels_last)
        net_ms = cuda_ms(lambda: det.network(x2), iters=5)
        dets2 = det.network(x2)

        def average():
            return flip_average(activate_heads(dets2, cfg), SERVE_BATCH, cfg,
                                "darknet")

        avg_ms = cuda_ms(average, ahead_cycles=SPIN)
        avgs = average()
        specs = [d for _, d in dets2]
        dec_ms = cuda_ms(lambda: decode_activated(avgs, specs, cfg),
                         ahead_cycles=SPIN)
        decoded = decode_activated(avgs, specs, cfg)
        nms_ms = cuda_ms(lambda: NMS.batched_nms_scored(
            *decoded, conf_threshold=CONF, iou_threshold=cfg.iou_threshold,
            max_detections=cfg.max_detections), ahead_cycles=SPIN)
    step = statistics.median(step_ms)
    parts = net_ms + avg_ms + dec_ms + nms_ms
    print(f"[16 tta bf16] detect_batch(tta=True) B={SERVE_BATCH} at {size}, "
          f"images on the card: {statistics.median(rates):.1f} img/s median "
          f"of 3 x 5 steps (spread {min(rates):.1f}..{max(rates):.1f}), step "
          f"{step:.2f} ms; backbone over the doubled batch {net_ms:.2f} + "
          f"activate and flip-average {avg_ms:.4f} + decode {dec_ms:.4f} + "
          f"NMS {nms_ms:.4f} = {parts:.2f} ms (device), the rest "
          f"{step - parts:.2f} ms; peak memory {peak:.2f} GiB; mean num "
          f"{out.num.mean():.1f}; on {smi}")


def smooth_check(label, got, want):
    """One smoothed call's Detections, card against CPU: num, classes and
    valid equal, boxes and scores within PARITY_TOL."""
    for name in ("num", "classes", "valid"):
        require(np.array_equal(getattr(got, name), getattr(want, name)),
                f"{label}: card and CPU {name} differ")
    for name in ("boxes", "scores"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   **PARITY_TOL)
    return float(np.abs(got.boxes - want.boxes).max())


def smoothing_phase(cfg, paths, dev, smi):
    """Phase 17, rolling-average smoothing (avg_frames SMOOTH_AVG):
    SMOOTH_FRAMES frames as batches of PARITY_BATCH with the state carried,
    card against the CPU port, for yolov3, yolov2 and yolov1; identical
    frames after warm-up against detect_batch; bf16 serving at
    SERVE_BATCH with the state carried."""
    from yolo_tensorflow_tpu_torch import config as C
    from yolo_tensorflow_tpu_torch.pipeline import Detector
    from yolo_tensorflow_tpu_torch.post import nms as NMS
    rng = np.random.default_rng(SEED + 17)
    torch.backends.cudnn.benchmark = False
    for name, path in paths.items():
        conf = CONF if name == MODEL else REGION[name][1]
        size = C.get_config(name).input_size
        frames = rng.integers(0, 256, (SMOOTH_FRAMES, size, size, 3),
                              dtype=np.uint8)
        gpu = Detector(name, path, device="cuda", conf_threshold=conf)
        cpu = Detector(name, path, device="cpu", conf_threshold=conf)
        sg = sc = None
        nums, err = [], 0.0
        for j in range(0, SMOOTH_FRAMES, PARITY_BATCH):
            got, sg = gpu.detect_batch_smoothed(
                frames[j:j + PARITY_BATCH], sg, avg_frames=SMOOTH_AVG)
            want, sc = cpu.detect_batch_smoothed(
                frames[j:j + PARITY_BATCH], sc, avg_frames=SMOOTH_AVG)
            got, want = NMS.fetch_detections(got), NMS.fetch_detections(want)
            err = max(err, smooth_check(f"17 smoothing {name}", got, want))
            nums += got.num.tolist()
        require(all(t.device.type == "cuda" for t in sg),
                f"{name}: the smoothing state left the card")
        tail_err = max((g.cpu() - c).abs().max().item()
                       for g, c in zip(sg, sc))
        for g, c in zip(sg, sc):
            torch.testing.assert_close(g.cpu(), c, **TAIL_TOL)
        require(sum(nums[SMOOTH_AVG - 1:]) > 0,
                f"{name}: no detections once the window is full")
        # identical frames: once the window is full, the mean of equal
        # activations is that activation to a rounding
        same = np.stack([frames[0]] * (SMOOTH_AVG + 1))
        plain = NMS.fetch_detections(gpu.detect_batch(same))
        sm = NMS.fetch_detections(gpu.detect_batch_smoothed(
            same, avg_frames=SMOOTH_AVG)[0])
        b = SMOOTH_AVG
        require(sm.num[b] == plain.num[b] and np.array_equal(
            sm.classes[b], plain.classes[b]),
            f"{name}: steady-state smoothing != detect_batch")
        np.testing.assert_allclose(sm.boxes[b], plain.boxes[b], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(sm.scores[b], plain.scores[b], rtol=1e-5)
        print(f"[17 smoothing {name}] {SMOOTH_FRAMES} frames as batches of "
              f"{PARITY_BATCH}, state carried on the card, avg_frames "
              f"{SMOOTH_AVG}: Detections equal to the CPU port's (num "
              f"{nums}), max |err| boxes {err:.3g}, tails {tail_err:.3g}; "
              f"frame {b} of {b + 1} identical ones equals detect_batch "
              f"(num {int(plain.num[b])})")
        del gpu, cpu

    torch.backends.cudnn.benchmark = True
    det = Detector(MODEL, paths[MODEL], device="cuda",
                   compute_dtype=torch.bfloat16, conf_threshold=CONF)
    size = cfg.input_size
    x = torch.as_tensor(rng.integers(0, 256, (SERVE_BATCH, size, size, 3),
                                     dtype=np.uint8), device=dev)
    state = [det.detect_batch_smoothed(x)[1]]

    def step():
        out, state[0] = det.detect_batch_smoothed(x, state[0])
        return out

    step_ms, rates, out = serve_rate(step, SERVE_BATCH)
    out = NMS.fetch_detections(out)
    require(np.isfinite(out.boxes).all() and np.all(out.num > 0),
            "bf16 smoothed detections empty or not finite")
    counted_forward("17 smoothing bf16", step, decode=0, nms=1)
    print(f"[17 smoothing bf16] detect_batch_smoothed B={SERVE_BATCH} at "
          f"{size}, state carried: {statistics.median(rates):.1f} img/s "
          f"median of 3 x 5 steps (spread {min(rates):.1f}.."
          f"{max(rates):.1f}), step {statistics.median(step_ms):.2f} ms; "
          f"mean num {out.num.mean():.1f}; on {smi}")


def int8_q_operands(gen, dev, batch, k, cin, cout, h, integer=False):
    """Seeded operands of one int8-in conv on the card: int8 xq, s_in, w_q,
    s_w, b, s_out. ``integer``: xq in [-8, 8] and unit scales, zero bias,
    no out scale: the float32 output is the int32 accumulator."""
    lo = -8 if integer else -127
    xq = torch.randint(lo, -lo + 1, (batch, cin, h, h), generator=gen,
                       device=dev).to(torch.int8).contiguous(
                           memory_format=torch.channels_last)
    w_q = torch.randint(-127, 128, (cout, cin, k, k), generator=gen,
                        device=dev).to(torch.int8).contiguous(
                            memory_format=torch.channels_last)
    if integer:
        return (xq, 1.0, w_q, torch.ones(cout, device=dev),
                torch.zeros(cout, device=dev), None)
    s_w = (torch.rand(cout, generator=gen, device=dev) + 0.5) / 127
    b = torch.randn(cout, generator=gen, device=dev)
    return xq, 0.02, w_q, s_w, b, 0.9


def int8_q_check(label, ops, stride, used):
    """conv2d_int8_q against its plain twin on the same card tensors: the
    int8 out equal, the float32 out (no out scale) within INT8_ULPS.
    Returns (max |err| of the float32 out, its ulps)."""
    from yolo_tensorflow_tpu_torch.ops.kernels import conv_int8 as Q8
    xq, s_in, w_q, s_w, b, s_out = ops
    kw = dict(stride=stride, act="leaky")
    got = Q8.conv2d_int8_q(xq, s_in, w_q, s_w, b, s_out=s_out, **kw)
    want = Q8.conv2d_int8_q_plain(xq, s_in, w_q, s_w, b, s_out=s_out, **kw)
    f_got = Q8.conv2d_int8_q(xq, s_in, w_q, s_w, b, **kw)
    f_want = Q8.conv2d_int8_q_plain(xq, s_in, w_q, s_w, b, **kw)
    torch.cuda.synchronize()
    require(got.dtype == torch.int8 and torch.equal(got, want),
            f"{label} {Q8.plan_q(xq, w_q)}: int8 out != plain "
            f"({int((got != want).sum())} differ)")
    ulps = ulp_distance(f_got, f_want)
    require(f_got.dtype == torch.float32 and ulps <= INT8_ULPS,
            f"{label} {Q8.plan_q(xq, w_q, False)}: float32 out {ulps} ulps "
            "from plain")
    used[Q8.plan_q(xq, w_q)] += 1
    return (f_got - f_want).abs().max().item(), ulps


def int8_act_phase(specs, cfg, path, shapes, qparams, calib, imgs, dev,
                   mixed_rate, mixed_net_ms, kind, smi):
    """Phase 18, the all-int8-activation path. Returns the int8-in
    entry's launches in one forward and its JSON fields."""
    from yolo_tensorflow_tpu_torch.io import weights as W
    from yolo_tensorflow_tpu_torch.models import engine, heads
    from yolo_tensorflow_tpu_torch.models import specs as S
    from yolo_tensorflow_tpu_torch.ops import layers as L
    from yolo_tensorflow_tpu_torch.ops import quant as Q
    from yolo_tensorflow_tpu_torch.ops.kernels import conv_int8 as Q8
    from yolo_tensorflow_tpu_torch.pipeline import normalize_images
    from yolo_tensorflow_tpu_torch.post import nms as NMS
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    used = collections.Counter()
    for h, cin, cout in PROBE_SHAPES:
        ops = int8_q_operands(gen, dev, KERNEL_BATCH, 3, cin, cout, h, True)
        got = Q8.conv2d_int8_q(*ops[:5], s_out=ops[5])
        acc = Q8.int8_accumulate(ops[0], ops[2], pad=1)
        torch.cuda.synchronize()
        require(acc.abs().max().item() < 2 ** 24
                and torch.equal(got, acc.float()),
                f"int8-in probe shape {h}^2 {cin}->{cout}: kernel != int32 "
                "accumulator")
        int8_q_check(f"int8-in probe shape {h}^2 {cin}->{cout}",
                     int8_q_operands(gen, dev, KERNEL_BATCH, 3, cin, cout,
                                     h), 1, used)
    max_err, worst = 0.0, 0
    cases = ([(PARITY_BATCH, k, stride, cin, cout, h, False)
              for (k, stride, cin, cout, h) in sorted(shapes)]
             + list(INT8_ODD))
    for (batch, k, stride, cin, cout, h, off) in cases:
        ops = list(int8_q_operands(gen, dev, batch, k, cin, cout, h))
        if off:
            ops[2] = unaligned(ops[2])
        label = f"int8-in B={batch} k{k} s{stride} {cin}->{cout} at {h}^2"
        err, ulps = int8_q_check(label, ops, stride, used)
        max_err, worst = max(max_err, err), max(worst, ulps)
        if off:           # and an input off a 16-byte boundary
            ops[0] = unaligned(ops[0])
            err, ulps = int8_q_check(label + " unaligned input", ops, stride,
                                     used)
            max_err, worst = max(max_err, err), max(worst, ulps)
    print(f"[18 int8-act kernel] the int8-in entry against its plain twin: "
          f"the Pallas probe shapes {PROBE_SHAPES} with integer inputs equal "
          f"to the int32 accumulator; {len(shapes)} distinct quantized convs "
          f"of {MODEL}-416 at B={PARITY_BATCH} and {len(INT8_ODD)} odd "
          f"cases, leaky: int8 out equal, float32 out within {worst} ulp "
          f"(limit {INT8_ULPS}), max |err| {max_err:.3g}; (instance, BN) "
          f"taken: {dict(used)}")

    # the shortcut's fused add on the card
    t = torch.randint(-127, 128, (1 << 20,), generator=gen,
                      device=dev).float()
    o = torch.randn(1 << 20, generator=gen, device=dev)
    fused = torch.add(o, t, alpha=0.0312345)
    exact = Q8.fma_f32(t, torch.tensor(float(np.float32(0.0312345))), o)
    add_same = int((fused == exact).sum())
    print(f"[18 int8-act] torch.add(alpha=) on the card equals one fma in "
          f"{add_same} of {t.numel()} elements (the shortcut's dequantize + "
          "add; the CPU port and the TPU package's CPU program fuse it)")

    folded, _ = W.load_darknet_weights(specs, cfg.input_size, path)
    t0 = time.perf_counter()
    outs = Q.calibrate_outputs(specs, folded, calib, cfg=cfg, device=dev)
    cal_s = time.perf_counter() - t0
    outs_cpu = Q.calibrate_outputs(specs, folded, calib[:1], cfg=cfg)
    outs_gpu1 = Q.calibrate_outputs(specs, folded, calib[:1], cfg=cfg,
                                    device=dev)
    cal_err = max(abs(outs_gpu1[k] - outs_cpu[k]) / outs_cpu[k]
                  for k in outs_cpu)
    require(outs.keys() == outs_cpu.keys() and cal_err < 1e-4,
            f"calibrate_outputs card vs CPU: relative difference {cal_err}")
    print(f"[18 int8-act] calibrate_outputs on the card over "
          f"{len(calib)} x {calib[0].shape[0]} seeded images: {len(outs)} "
          f"scales in {cal_s:.1f} s; one batch card vs CPU within "
          f"{cal_err:.2g} relative")

    fwd = Q.make_int8_forward(cfg, specs, outs, conf_threshold=CONF)
    gpu_params = Q.int8_params_to(qparams, dev)
    cpu_params = Q.int8_params_to(qparams, "cpu")
    n_q = sum(shapes.values())
    x2 = torch.as_tensor(imgs, device=dev)
    fwd(gpu_params, x2)                         # warm-up
    got = NMS.fetch_detections(counted_forward(
        "18 int8-act f32", lambda: fwd(gpu_params, x2), int8_q=n_q, int8=0,
        decode=1, nms=1))
    want = NMS.fetch_detections(fwd(cpu_params, torch.as_tensor(imgs)))
    with torch.inference_mode():
        xn = normalize_images(x2, cfg)
        dets, layers = Q.apply_int8_layers(specs, gpu_params, outs, xn)
        _, cpu_layers = Q.apply_int8_layers(specs, cpu_params, outs,
                                            xn.cpu())
        scores = heads.decode_scored(dets, cfg)[1]
    diff = sum(int((g.cpu() != c).sum()) for (g, s), (c, _)
               in zip(layers, cpu_layers) if s is not None)
    total = sum(g.numel() for g, s in layers if s is not None)
    check_detections("18 int8-act f32", None, imgs, got, want, cfg, kind,
                     scores=scores)
    print(f"[18 int8-act f32] make_int8_forward B={PARITY_BATCH}: "
          f"Detections equal to the CPU port's; int8 activations card vs "
          f"CPU: {diff} of {total} elements differ; one forward launched "
          f"the int8-in conv {n_q} times, the decode and NMS once, the "
          "mixed int8 conv (and its quantize pass) never")

    rng = np.random.default_rng(SEED + 18)
    size = cfg.input_size
    x = torch.as_tensor(rng.integers(0, 256, (SERVE_BATCH, size, size, 3),
                                     dtype=np.uint8), device=dev)
    torch.cuda.reset_peak_memory_stats()
    step_ms, rates, out = serve_rate(lambda: fwd(gpu_params, x), SERVE_BATCH)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    out = NMS.fetch_detections(out)
    require(np.isfinite(out.boxes).all() and np.all(out.num > 0),
            "int8-activation detections empty or not finite")
    counted_forward("18 int8-act serve", lambda: fwd(gpu_params, x),
                    int8_q=n_q, int8=0, decode=1, nms=1)
    with torch.inference_mode():
        xn = normalize_images(x, cfg)
        net_ms = cuda_ms(lambda: Q.apply_int8(specs, gpu_params, outs, xn),
                         iters=5)
        # the eager steps around the kernel: each shortcut's dequantize +
        # add + requantize, and the float32 head convs
        _, layers = Q.apply_int8_layers(specs, gpu_params, outs, xn)
        add_ms = head_ms = 0.0
        for i, spec in enumerate(specs):
            if isinstance(spec, S.Shortcut):
                pair = (layers[i - 1], layers[S.resolve_ref(spec.ref, i)])
                add_ms += cuda_ms(lambda: Q._requant_from(
                    Q._add(*pair), None, outs[i]), iters=5)
            elif i in Q.head_conv_layers(specs):
                p = gpu_params[engine.layer_key(i)]
                with L.exact_f32_convs():
                    head_ms += cuda_ms(lambda: Q._conv_int8(
                        spec, p, *layers[i - 1], None, False), iters=5)
        del layers
    print(f"[18 int8-act serve] make_int8_forward B={SERVE_BATCH} at "
          f"{size}: {statistics.median(rates):.1f} img/s median of 3 x 5 "
          f"steps (spread {min(rates):.1f}..{max(rates):.1f}), step "
          f"{statistics.median(step_ms):.2f} ms, backbone (apply_int8) "
          f"{net_ms:.2f} ms; the mixed int8 path of phase 7 (bf16 between "
          f"convs): {mixed_rate:.1f} img/s, backbone {mixed_net_ms:.2f} ms; "
          f"peak memory {peak:.2f} GiB; mean num {out.num.mean():.1f}; on "
          f"{smi}")

    tot = collections.Counter()
    for (k, stride, cin, cout, h), n in sorted(shapes.items(),
                                              key=lambda kv: -kv[0][4]):
        xq, s_in, w_q, s_w, b, s_out = int8_q_operands(
            gen, dev, SERVE_BATCH, k, cin, cout, h)
        kw = dict(stride=stride, act="leaky")
        ms = cuda_ms(lambda: Q8.conv2d_int8_q(xq, s_in, w_q, s_w, b,
                                              s_out=s_out, **kw), iters=10)
        xb = (xq.float() * 0.02).to(torch.bfloat16)
        mixed = cuda_ms(lambda: Q8.conv2d_int8(
            xb, w_q, 0.02, s_w, b, epilogue_dtype=torch.bfloat16, **kw),
            iters=10)
        plain = cuda_ms(lambda: Q8.conv2d_int8_q_plain(
            xq, s_in, w_q, s_w, b, s_out=s_out, **kw), iters=1, warmup=1)
        nbytes, ops = int8_cost(SERVE_BATCH, k, stride, cin, cout, h, 1, 1)
        bnd, by = bound_ms(nbytes, ops, INT8_OPS_S)
        for key, v in (("ms", ms), ("mixed", mixed), ("plain", plain),
                       ("bound", bnd), (f"bound_{by}", bnd)):
            tot[key] += n * v
        print(f"[18 int8-act kernel] B={SERVE_BATCH} int8 in and out k{k} "
              f"s{stride} {cin}->{cout} at {h}^2 x{n}: "
              f"{Q8.plan_q(xq, w_q)}, kernel {ms:.4f} ms "
              f"({ops / ms / 1e9:.1f} TOPS), bound {bnd:.4f} ms ({by}), "
              f"plain {plain:.3f} ms; the mixed kernel (bf16 in and out, "
              f"quantize pass + GEMM) {mixed:.4f} ms")
        del xq, w_q, xb
    by = ("bytes" if tot["bound_bytes"] >= tot["bound_operations"]
          else "operations")
    rest = net_ms - tot["ms"] - add_ms - head_ms
    print(f"[18 int8-act serve] backbone (apply_int8) {net_ms:.2f} ms = the "
          f"int8-in convs {tot['ms']:.2f} (timed alone, below) + shortcuts' "
          f"dequantize, add and requantize {add_ms:.2f} + float32 head convs "
          f"{head_ms:.2f} + the rest {rest:.2f} ms (device)")
    print(f"[18 int8-act kernel] per {MODEL}-416 forward at B={SERVE_BATCH}, "
          f"summed over the {sum(shapes.values())} convs: the int8-in entry "
          f"{tot['ms']:.3f} ms, the mixed kernel {tot['mixed']:.3f} ms, "
          f"bound (int8 in and out) {tot['bound']:.3f} ms (bytes-bound "
          f"layers {tot['bound_bytes']:.3f}, operations-bound "
          f"{tot['bound_operations']:.3f}), plain {tot['plain']:.2f} ms; on "
          f"{smi}")
    return n_q, {"max_abs_err": max_err, "ms": tot["ms"],
                        "plain_ms": tot["plain"], "bound_ms": tot["bound"],
                        "bound_by": by, "library_ms": None}


def k7_case(gen, dev, batch, stride, cout, h, off, dtype):
    """Operands of one 7x7 int8 conv on the card (Cin 3): phase 6's
    int8_operands, the input and weights moved off a 16-byte boundary with
    ``off``."""
    x, w_q, s_x, s_w, b = int8_operands(gen, dev, batch, 7, 3, cout, h,
                                        dtype)
    if off:
        x, w_q = unaligned(x), unaligned(w_q)
    return x, w_q, s_x, s_w, b


def k7_check(label, ops, stride, used):
    """Both entries of the int8 kernel at one 7x7 conv against their plain
    twins, leaky and linear: the f32/bf16-in entry's output, the int8-in
    entry's int8 and float32 outputs, all equal (0 ulp)."""
    from yolo_tensorflow_tpu_torch.ops.kernels import conv_int8 as Q8
    x, w_q, s_x, s_w, b = ops
    dtype = x.dtype
    for act in ("leaky", "linear"):
        kw = dict(stride=stride, act=act)
        got = Q8.conv2d_int8(x, w_q, s_x, s_w, b, epilogue_dtype=dtype,
                             **kw)
        want = Q8.conv2d_int8_plain(x, w_q, s_x, s_w, b,
                                    epilogue_dtype=dtype, **kw)
        xq = Q8.quantize_act(x, s_x)
        outs = [(Q8.conv2d_int8_q(xq, s_x, w_q, s_w, b, s_out=s_out, **kw),
                 Q8.conv2d_int8_q_plain(xq, s_x, w_q, s_w, b, s_out=s_out,
                                        **kw))
                for s_out in (0.9, None)]
        torch.cuda.synchronize()
        require(got.shape == want.shape and torch.equal(got, want),
                f"{label} {act} {Q8.plan(x, w_q)}: "
                f"{ulp_distance(got, want)} ulps from plain")
        for g, w in outs:
            require(torch.equal(g, w), f"{label} {act} int8-in "
                    f"{Q8.plan_q(xq, w_q, g.dtype == torch.int8)} "
                    f"{g.dtype}: {int((g != w).sum())} differ from plain")
        used[Q8.plan(x, w_q)] += 1


def int8_k7_phase(dev, kind, smi, v1_path):
    """Phase 23. The int8 kernel at yolov1's 7x7 stride-2 first conv, both
    entries, against their plain twins and timed; int8 yolov1-448 (all 24
    convs quantized, the connected head float) f32 against the CPU port,
    and bf16 serving beside float yolov1's. Returns the int8 params and the
    kernel's numbers at the first conv."""
    from yolo_tensorflow_tpu_torch import config as C
    from yolo_tensorflow_tpu_torch.io import weights as W
    from yolo_tensorflow_tpu_torch.models import engine
    from yolo_tensorflow_tpu_torch.ops import quant as Q
    from yolo_tensorflow_tpu_torch.ops.kernels import conv_int8 as Q8
    from yolo_tensorflow_tpu_torch.pipeline import Detector
    from yolo_tensorflow_tpu_torch.post import nms as NMS
    cfg = C.get_config("yolov1")
    specs = C.build_specs(cfg)
    size = cfg.input_size
    first = specs[0]
    require((first.size, first.stride, first.filters) == (7, 2, 64),
            f"yolov1's first conv is {first}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    used = collections.Counter()
    cases = [(SERVE_BATCH, 2, 64, size, False)] + list(K7_ODD)
    for (batch, stride, cout, h, off) in cases:
        for dtype in (torch.float32, torch.bfloat16):
            k7_check(f"23 int8 k7 B={batch} s{stride} 3->{cout} at {h}^2 "
                     f"{dtype}{' unaligned' if off else ''}",
                     k7_case(gen, dev, batch, stride, cout, h, off, dtype),
                     stride, used)
    print(f"[23 int8 k7] yolov1's first conv (7x7 s2, 3->64 at {size}^2) "
          f"at B={SERVE_BATCH} and {len(K7_ODD)} odd cases, f32 and bf16, "
          f"leaky and linear, both entries (int8 and float32 out for the "
          f"int8-in one): equal to the plain twins, 0 ulp; (instance, BN) "
          f"taken: {dict(used)}")

    x, w_q, s_x, s_w, b = k7_case(gen, dev, SERVE_BATCH, 2, 64, size, False,
                                  torch.bfloat16)
    kw = dict(stride=2, act="leaky")
    ms = cuda_ms(lambda: Q8.conv2d_int8(x, w_q, s_x, s_w, b,
                                        epilogue_dtype=torch.bfloat16, **kw),
                 iters=10)
    quant = cuda_ms(lambda: Q8.quantize_act(x, s_x), iters=10)
    plain = cuda_ms(lambda: Q8.conv2d_int8_plain(
        x, w_q, s_x, s_w, b, epilogue_dtype=torch.bfloat16, **kw), iters=1,
        warmup=1)
    nbytes, ops = int8_cost(SERVE_BATCH, 7, 2, 3, 64, size, 2, 2)
    bnd, by = bound_ms(nbytes, ops, INT8_OPS_S)
    xq = Q8.quantize_act(x, s_x)
    q_ms = cuda_ms(lambda: Q8.conv2d_int8_q(xq, s_x, w_q, s_w, b, s_out=0.9,
                                            **kw), iters=10)
    q_plain = cuda_ms(lambda: Q8.conv2d_int8_q_plain(
        xq, s_x, w_q, s_w, b, s_out=0.9, **kw), iters=1, warmup=1)
    q_bytes, _ = int8_cost(SERVE_BATCH, 7, 2, 3, 64, size, 1, 1)
    q_bnd, q_by = bound_ms(q_bytes, ops, INT8_OPS_S)
    wf = torch.randn((64, 3, 7, 7), generator=gen, device=dev,
                     dtype=torch.bfloat16).contiguous(
                         memory_format=torch.channels_last)
    cudnn = cuda_ms(lambda: F.conv2d(x, wf, stride=2, padding=3), iters=10)
    print(f"[23 int8 k7] B={SERVE_BATCH} bf16 7x7 s2 3->64 at {size}^2: "
          f"{Q8.plan(x, w_q)}, kernel {ms:.4f} ms ({ops / ms / 1e9:.1f} "
          f"TOPS) of which the quantize pass alone {quant:.4f} ms, bound "
          f"{bnd:.4f} ms ({by}; {nbytes / 1e6:.0f} MB, {ops / 1e9:.1f} G "
          f"int8 ops), plain {plain:.3f} ms; the int8-in entry (int8 in and "
          f"out) {q_ms:.4f} ms, bound {q_bnd:.4f} ms ({q_by}), plain "
          f"{q_plain:.3f} ms; cuDNN bf16 conv {cudnn:.4f} ms (context: not "
          f"the same function); on {smi}")
    del x, w_q, xq, wf

    folded, _ = W.load_darknet_weights(specs, size, v1_path)
    rng = np.random.default_rng(SEED + 23)
    calib = [rng.integers(0, 256, (PARITY_BATCH, size, size, 3),
                          dtype=np.uint8) for _ in range(2)]
    scales = Q.calibrate_activations(specs, folded, calib, cfg=cfg,
                                     device=dev)
    qparams = Q.quantize_params(specs, folded, scales)
    n_int8 = sum("w_q" in p for p in qparams.values())
    require(n_int8 == 24 and "w_q" in qparams[engine.layer_key(0)],
            f"yolov1: {n_int8} convs quantized, expected all 24")
    conf = REGION["yolov1"][1]
    imgs = rng.integers(0, 256, (PARITY_BATCH, size, size, 3),
                        dtype=np.uint8)
    gpu = Detector("yolov1", params=qparams, device="cuda",
                   conf_threshold=conf)
    x2 = torch.as_tensor(imgs, device=dev)
    gpu.detect_batch(x2)                   # warm-up, outside the count
    got = NMS.fetch_detections(counted_forward(
        "23 int8 yolov1 f32", lambda: gpu.detect_batch(x2), int8=n_int8,
        decode=0, nms=1))
    cpu = Detector("yolov1", params=qparams, device="cpu",
                   conf_threshold=conf)
    t0 = time.perf_counter()
    want = NMS.fetch_detections(cpu.detect_batch(imgs))
    cpu_s = time.perf_counter() - t0
    check_detections("23 int8 yolov1 f32", gpu, imgs, got, want, cfg, kind,
                     conf)
    print(f"[23 int8 yolov1 f32] int8 yolov1-{size} (24 quantized convs, "
          f"the 7x7 first one among them; the connected head float): "
          f"Detections equal to the CPU port's (num {got.num.tolist()}); "
          f"the CPU port took {cpu_s:.1f} s")
    del gpu, cpu

    torch.backends.cudnn.benchmark = True
    x = torch.as_tensor(rng.integers(0, 256, (SERVE_BATCH, size, size, 3),
                                     dtype=np.uint8), device=dev)
    rates = {}
    for label, params in (("int8", qparams), ("float", folded)):
        det = Detector("yolov1", params=params, device="cuda",
                       compute_dtype=torch.bfloat16, conf_threshold=conf)
        step_ms, r, out = serve_rate(lambda: det.detect_batch(x), len(x))
        out = NMS.fetch_detections(out)
        require(np.isfinite(out.boxes).all(),
                f"yolov1 {label} bf16 boxes not finite")
        rates[label] = (statistics.median(r), min(r), max(r),
                        statistics.median(step_ms))
        if label == "int8":
            counted_forward("23 int8 yolov1 bf16",
                            lambda: det.detect_batch(x), int8=n_int8,
                            decode=0, nms=1)
        del det
    print(f"[23 int8 yolov1 bf16] detect_batch B={SERVE_BATCH} at {size}: "
          + "; ".join(f"{k} {v[0]:.1f} img/s (spread {v[1]:.1f}..{v[2]:.1f},"
                      f" step {v[3]:.2f} ms)" for k, v in rates.items())
          + f"; on {smi}")
    return qparams, dict(ms=ms, bound_ms=bnd, plain_ms=plain)


def device_busy(prof, path):
    """(device busy s, intervals) of a stopped torch.profiler run: the union
    of its kernel, memcpy and memset intervals, from the chrome trace
    exported to ``path``."""
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy_us, end = 0.0, -float("inf")
    for a, b in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy_us / 1e6, len(spans)


def eval_samples_of(paths, results, sizes, rng):
    """Samples whose ground truth is each image's first detections (pixel
    boxes), jittered by up to 10 % of the box and relabelled now and then,
    so that the mAP of a comparison is no trivial 0."""
    from yolo_tensorflow_tpu_torch.data.datasets import Sample
    samples = []
    for path, res, (h, w) in zip(paths, results, sizes):
        rows = []
        for r in res[:5]:
            x0, y0, x1, y1 = r["box"]
            bw, bh = max(x1 - x0, 1.0), max(y1 - y0, 1.0)
            cx = (x0 + x1) / 2 + rng.uniform(-0.1, 0.1) * bw
            cy = (y0 + y1) / 2 + rng.uniform(-0.1, 0.1) * bh
            cls = r["class_id"] if rng.random() < 0.8 else 0
            rows.append([cx / w, cy / h, bw / w, bh / h, cls])
        samples.append(Sample(path, np.asarray(rows, np.float32).reshape(
            -1, 5)))
    return samples


def eval_parity(label, gpu, cpu, paths, read_fn, want_counts):
    """evaluate_samples on the card against the CPU port over ``paths``
    (ground truth from the card's own first pass): per image num and
    classes equal, pixel boxes and scores within FUSED_TOL, the ground
    truth and the mAP equal; the kernels' launches counted around the
    card's run. Returns the mAP."""
    from yolo_tensorflow_tpu_torch.eval import batched as EB
    from yolo_tensorflow_tpu_torch.eval import map as EM
    first, sizes = EB.detect_paths(gpu, paths, batch_size=EVAL_BATCH,
                                   read_fn=read_fn)
    samples = eval_samples_of(paths, first, sizes,
                              np.random.default_rng(SEED + 24))
    torch.cuda.synchronize()
    reset_counts()
    got = EB.evaluate_samples(gpu, samples, batch_size=EVAL_BATCH,
                              read_fn=read_fn)
    torch.cuda.synchronize()
    launched = {k: v for k, v in counts().items() if k in want_counts}
    require(launched == want_counts, f"{label}: evaluate_samples launched "
            f"{launched}, expected {want_counts}")
    t0 = time.perf_counter()
    want = EB.evaluate_samples(cpu, samples, batch_size=EVAL_BATCH,
                               read_fn=read_fn)
    cpu_s = time.perf_counter() - t0
    (dets, gts, results, _), (cdets, cgts, cresults, _) = got, want
    err = 0.0
    for i, (d, c) in enumerate(zip(dets, cdets)):
        require(len(d["classes"]) == len(c["classes"])
                and np.array_equal(d["classes"], c["classes"]),
                f"{label}: image {i}: card classes {d['classes']} CPU "
                f"{c['classes']}")
        np.testing.assert_allclose(d["boxes"], c["boxes"], **FUSED_TOL)
        np.testing.assert_allclose(d["scores"], c["scores"], **FUSED_TOL)
        if len(d["boxes"]):
            err = max(err, float(np.abs(d["boxes"] - c["boxes"]).max()))
    for g, c in zip(gts, cgts):
        require(np.array_equal(g["boxes"], c["boxes"])
                and np.array_equal(g["classes"], c["classes"]),
                f"{label}: ground truth differs")
    m = EM.evaluate_detections(dets, gts, gpu.cfg.num_classes)
    cm = EM.evaluate_detections(cdets, cgts, cpu.cfg.num_classes)
    n = sum(len(r) for r in results)
    require(m["map"] == cm["map"] and m["map"] > 0 and n > 0,
            f"{label}: mAP card {m['map']} CPU {cm['map']}, {n} detections")
    print(f"[{label}] evaluate_samples over {len(paths)} images in batches "
          f"of {EVAL_BATCH} through read_fn: {n} detections, classes equal "
          f"to the CPU port's, max |err| of pixel boxes {err:.3g} (tol "
          f"{FUSED_TOL}); mAP@0.5 {m['map']:.6f} ({m['num_classes_evaluated']}"
          f" classes) on the card and on the CPU; launches {launched}; the "
          f"CPU port took {cpu_s:.1f} s")
    return m["map"]


def eval_rate(label, det, samples, read_fn, tmp, smi):
    """bf16 evaluate_samples at batch SERVE_BATCH over every sample, after
    a warm-up pass over them all (files read once, kernels built): img/s of
    the whole pipeline (read_fn, canvases, the card, the fetch, the
    un-mapping), then the same pass traced, for the card's idle share, 1 -
    (union of the kernel, memcpy and memset intervals of a torch.profiler
    trace / wall time)."""
    from yolo_tensorflow_tpu_torch.eval import batched as EB

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = EB.evaluate_samples(det, samples, batch_size=SERVE_BATCH,
                                  read_fn=read_fn)[0]
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    run()
    _, untraced = run()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    dets, wall = run()
    prof.stop()
    busy, n_spans = device_busy(prof, os.path.join(
        tmp, label.replace(" ", "_") + ".json"))
    require(len(dets) == len(samples) and 0 < busy < wall,
            f"{label}: {len(dets)} results, device busy {busy:.3f} s of "
            f"{wall:.3f} s")
    print(f"[{label}] evaluate_samples bf16 B={SERVE_BATCH} over "
          f"{len(samples)} scenes of 480x640 through read_fn: "
          f"{len(samples) / untraced:.1f} img/s untraced, "
          f"{len(samples) / wall:.1f} img/s traced; device busy (union of "
          f"{n_spans} kernel, memcpy and memset intervals) {busy:.3f} s of "
          f"{wall:.3f} s, idle share {1 - busy / wall:.3f}; "
          f"{sum(len(d['scores']) for d in dets)} detections; on {smi}")
    return len(samples) / untraced, 1 - busy / wall


def eval_phase(dev, kind, smi, tmp, v2_path, v1_qparams):
    """Phase 24. evaluate_samples on the card: a fused yolov2-416 Detector
    (seeded, and the hand-made head of phase 11) and a fused int8 yolov1
    one, f32 against the CPU port (detections and mAP), then bf16 batch
    SERVE_BATCH img/s of the whole pipeline with the card's idle share."""
    from yolo_tensorflow_tpu_torch import config as C
    from yolo_tensorflow_tpu_torch.data.datasets import Sample
    from yolo_tensorflow_tpu_torch.pipeline import Detector
    root = os.path.join(tmp, "eval")
    os.makedirs(root)
    imgs, labels = scenes(EVAL_SCENES, SEED + 24)
    paths, samples = [], []
    for i, (img, lab) in enumerate(zip(imgs, labels)):
        path = os.path.join(root, f"scene{i:03d}.npy")
        np.save(path, img)
        rows = np.asarray([[float(v) for v in line.split()[1:]]
                           + [int(line.split()[0]) % 20]
                           for line in lab.splitlines()], np.float32)
        paths.append(path)
        samples.append(Sample(path, rows))
    crops = []
    for i in range(EVAL_PARITY // 2):
        path = os.path.join(root, f"crop{i:03d}.npy")
        np.save(path, imgs[i][:448, :448])
        crops.append(path)
    crafted = []
    cfg2 = C.get_config("yolov2")
    for i, img in enumerate(crafted_images(EVAL_BATCH, cfg2.input_size)):
        path = os.path.join(root, f"crafted{i:03d}.npy")
        np.save(path, img)
        crafted.append(path)
    del imgs
    read_fn = np.load
    torch.backends.cudnn.benchmark = False
    batches = -(-EVAL_PARITY // EVAL_BATCH)
    fused = dict(letterbox=True, fused=True)
    conf2, conf1 = REGION["yolov2"][1], REGION["yolov1"][1]
    maps = {}
    for label, args, kw, imgs_of, want in (
            ("24 eval yolov2 f32", (v2_path,), dict(conf_threshold=conf2),
             paths[:EVAL_PARITY], dict(decode=batches, nms=batches)),
            ("24 eval yolov2 hand-made f32",
             (os.path.join(tmp, "yolov2-crafted.weights"),), {}, crafted,
             dict(decode=1, nms=1)),
            ("24 eval int8 yolov1 f32", (), dict(params=v1_qparams,
                                                 conf_threshold=conf1),
             crops, dict(decode=0, nms=1, int8=24))):
        name = "yolov1" if "yolov1" in label else "yolov2"
        gpu = Detector(name, *args, device="cuda", **fused, **kw)
        cpu = Detector(name, *args, device="cpu", **fused, **kw)
        maps[label] = eval_parity(label, gpu, cpu, imgs_of, read_fn, want)
        del gpu, cpu
    torch.backends.cudnn.benchmark = True
    rates = {}
    for label, name, args, kw in (
            ("24 eval yolov2 bf16", "yolov2", (v2_path,),
             dict(conf_threshold=conf2)),
            ("24 eval int8 yolov1 bf16", "yolov1", (),
             dict(params=v1_qparams, conf_threshold=conf1))):
        det = Detector(name, *args, device="cuda",
                       compute_dtype=torch.bfloat16, **fused, **kw)
        rates[label] = eval_rate(label, det, samples, read_fn, tmp, smi)
        del det
    return maps, rates


def classifier_phase(dev, kind, smi, tmp):
    """Phase 25. Every Classifier mode on darknet19-256 in f32 against the
    CPU port (probabilities within CLS_TOL, the top 5 equal), then bf16
    classify_batch_center_crop at batch SERVE_BATCH."""
    from yolo_tensorflow_tpu_torch import config as C
    from yolo_tensorflow_tpu_torch.eval import classify as EV
    from yolo_tensorflow_tpu_torch.io import weights as W
    from yolo_tensorflow_tpu_torch.models import engine
    from yolo_tensorflow_tpu_torch.pipeline import Classifier
    name = "darknet19-classifier"
    cfg = C.get_config(name)
    specs = C.build_specs(cfg)
    path = os.path.join(tmp, f"{name}-seed{SEED}.weights")
    params, stats = engine.init_params(specs, cfg.input_size, SEED + 25)
    W.save_darknet_weights(specs, cfg.input_size, params, stats, path)
    del params, stats
    rng = np.random.default_rng(SEED + 25)
    imgs = [scenes(1, SEED + 25 + i)[0][0][:h, :w]
            for i, (h, w) in enumerate(CLS_SIZES)]
    torch.backends.cudnn.benchmark = False
    gpu = Classifier(name, path, device="cuda")
    cpu = Classifier(name, path, device="cpu")
    rows = []
    for mode, buckets in (("single", None), ("crop", None),
                          ("10crop", None), ("full", None),
                          ("full", "snap32"), ("multi", None),
                          ("multi", "snap32")):
        got = EV._chunk_probs(gpu, imgs, mode, buckets)
        t0 = time.perf_counter()
        want = EV._chunk_probs(cpu, imgs, mode, buckets)
        cpu_s = time.perf_counter() - t0
        np.testing.assert_allclose(got, want, **CLS_TOL)
        top, ctop = EV.topk_indices(got, 5), EV.topk_indices(want, 5)
        srt = -np.sort(-want, axis=1)
        gap = float((srt[:, :5] - srt[:, 1:6]).min())
        require(np.array_equal(top, ctop), f"25 classifier {mode}: top-5 "
                f"card {top.tolist()} CPU {ctop.tolist()} (least gap of the "
                f"CPU's top 6 {gap:.3g})")
        rows.append(f"{mode}{'/' + buckets if buckets else ''} max |err| "
                    f"{np.abs(got - want).max():.3g} (top-5 gap >= "
                    f"{gap:.2g}; CPU {cpu_s:.1f} s)")
    print(f"[25 classifier f32] {name}-{cfg.input_size} from a seeded "
          f".weights file, images (h, w) {list(CLS_SIZES)}: every mode's "
          f"probabilities within {CLS_TOL} of the CPU port's and the top 5 "
          f"equal: {'; '.join(rows)}")
    del gpu, cpu

    torch.backends.cudnn.benchmark = True
    clf = Classifier(name, path, device="cuda", compute_dtype=torch.bfloat16)
    frames = [scenes(1, SEED + 250 + i)[0][0] for i in range(4)]
    batch = [frames[i % 4] for i in range(SERVE_BATCH)]
    step_ms, rates, probs = serve_rate(
        lambda: clf.classify_batch_center_crop(batch), SERVE_BATCH)
    probs = probs.float().cpu().numpy()
    require(probs.shape == (SERVE_BATCH, cfg.num_classes)
            and np.isfinite(probs).all()
            and np.allclose(probs.sum(1), 1, atol=1e-2),
            "bf16 center-crop probabilities not finite or not summing to 1")
    x = torch.as_tensor(rng.integers(0, 256, (SERVE_BATCH, cfg.input_size,
                                              cfg.input_size, 3),
                                     dtype=np.uint8), device=dev)
    net_ms, _, _ = serve_rate(lambda: clf.classify_batch(x), SERVE_BATCH)
    print(f"[25 classifier bf16] classify_batch_center_crop B={SERVE_BATCH} "
          f"of 480x640 host images (host crop into a 512 canvas, the resize "
          f"on the card): {statistics.median(rates):.1f} img/s median of 3 x "
          f"5 (spread {min(rates):.1f}..{max(rates):.1f}), step "
          f"{statistics.median(step_ms):.2f} ms; classify_batch of images "
          f"at {cfg.input_size} already on the card: "
          f"{SERVE_BATCH * 1e3 / statistics.median(net_ms):.1f} img/s; on "
          f"{smi}")
    return statistics.median(rates)


def run_training_eval_phase(dev, smi, tmp):
    """Phase 26. run_training on darknet19-256 (bf16 onepass, batch
    CLS_BATCH) with val_list and eval_every 2 through read_fn: the top-1 of
    each evaluation round (the Classifier in mode 'crop', its resize on the
    card) and conv_bnstat launched for every fused conv of every step,
    none in the evaluations."""
    import argparse
    import contextlib
    import io
    from yolo_tensorflow_tpu_torch import config as C
    from yolo_tensorflow_tpu_torch.ops.kernels import conv_bnstat as BS
    from yolo_tensorflow_tpu_torch.train import runner
    name = "darknet19-classifier"
    cfg = C.get_config(name)
    specs = C.build_specs(cfg)
    n_fused = sum(bnstat_shapes(specs, cfg).values())
    root = os.path.join(tmp, "run_training_eval")
    os.makedirs(root)
    rng = np.random.default_rng(SEED + 26)
    pixels, lists = {}, {"train": [], "val": []}
    for i in range(2 * RUN_CLS_IMAGES):
        cls = i % 8
        img = np.clip(rng.integers(0, 64, (96, 128, 3))
                      + 24 * np.asarray([cls, 7 - cls, cls % 3]), 0,
                      255).astype(np.uint8)
        split = "train" if i < RUN_CLS_IMAGES else "val"
        path = os.path.join(root, f"{cfg.classes[cls]}_{i:04d}.jpg")
        pixels[path] = img
        lists[split].append(path)
    for split, paths in lists.items():
        with open(os.path.join(root, f"{split}.txt"), "w") as f:
            f.write("\n".join(paths) + "\n")
    args = argparse.Namespace(
        model=name, cfg=None, names=None,
        list=os.path.join(root, "train.txt"),
        val_list=os.path.join(root, "val.txt"), eval_every=2, weights=None,
        ckpt_dir=os.path.join(root, "ckpt"), batch_size=CLS_BATCH,
        steps=RUN_CLS_STEPS, lr=1e-3, burn_in=10, input_size=None,
        multiscale=False, bf16=True, bn_onepass=True, num_data=1,
        num_spatial=1, cache_images=False, save_every=100, log_every=2,
        device=str(dev))
    out = io.StringIO()
    BS.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        state = runner.run_training(args, read_fn=pixels.__getitem__)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = BS.launches
    for line in out.getvalue().splitlines():
        print(f"[26 run_training eval] {line}")
    tops = [float(line.split("= ")[1]) for line in out.getvalue().splitlines()
            if ": val top-1 = " in line]
    require(int(state.step) == RUN_CLS_STEPS
            and launches == n_fused * RUN_CLS_STEPS
            and len(tops) == RUN_CLS_STEPS // 2
            and all(0 <= t <= 1 for t in tops),
            f"run_training with eval: step {int(state.step)}, conv_bnstat "
            f"launches {launches} (expected {n_fused} a step), top-1 {tops}")
    print(f"[26 run_training eval] {name}-{cfg.input_size} bf16 onepass "
          f"B={CLS_BATCH}, {RUN_CLS_STEPS} steps with val_list "
          f"({RUN_CLS_IMAGES} images) and eval_every 2 through read_fn in "
          f"{wall:.1f} s: val top-1 {tops}; conv_bnstat launched {launches} "
          f"times ({n_fused} a step, none in the evaluations); on {smi}")
    return tops


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    try:
        import yolo_tensorflow_tpu_torch  # noqa: F401
    except ModuleNotFoundError:
        print("chip_smoke: the package yolo_tensorflow_tpu_torch is not "
              "beside this script; run it from the repository's root",
              file=sys.stderr)
        return 1
    from yolo_tensorflow_tpu_torch import config as C
    from yolo_tensorflow_tpu_torch.io import weights as W
    from yolo_tensorflow_tpu_torch.models import engine
    from yolo_tensorflow_tpu_torch.models import specs as S
    from yolo_tensorflow_tpu_torch.ops import quant as Q
    from yolo_tensorflow_tpu_torch.ops.kernels import build
    from yolo_tensorflow_tpu_torch.ops.kernels import decode as K
    from yolo_tensorflow_tpu_torch.ops.kernels import nms as NK
    from yolo_tensorflow_tpu_torch.pipeline import Detector
    from yolo_tensorflow_tpu_torch.post import nms as NMS

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"[1 device] {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible")
    dev = torch.device("cuda", 0)

    # 2. build
    t0 = time.perf_counter()
    lib_path = build.build(force=True)
    build_s = time.perf_counter() - t0
    build.load()
    print(f"[2 build] nvcc built {[s.name for s in build.sources()]} -> "
          f"{lib_path.name} in {build_s:.2f} s")

    # 3. decode kernel vs plain at the v3 and region head shapes
    cfg = C.get_config(MODEL)
    specs = C.build_specs(cfg)
    decode_fields = decode_kernel_phase(dev)

    with tempfile.TemporaryDirectory() as tmp:
        # 4. main path, f32 parity
        path = os.path.join(tmp, f"{MODEL}-seed{SEED}.weights")
        params, stats = engine.init_params(specs, cfg.input_size, SEED,
                                           obj_bias=OBJ_BIAS)
        W.save_darknet_weights(specs, cfg.input_size, params, stats, path)
        del params, stats
        rng = np.random.default_rng(SEED + 1)
        imgs = rng.integers(0, 256, (PARITY_BATCH, cfg.input_size,
                                     cfg.input_size, 3), dtype=np.uint8)
        gpu = Detector(MODEL, path, device="cuda", conf_threshold=CONF)
        gpu.detect_batch(imgs)                 # warm-up, outside the count
        torch.cuda.synchronize()
        K.launches = NK.launches = 0
        got = gpu.detect_batch(imgs)           # f32, TF32 off in the network
        torch.cuda.synchronize()
        launches, nms_launches = K.launches, NK.launches
        require(launches == nms_launches == 1,
                f"the main path launched the decode kernel {launches} times "
                f"and NMS {nms_launches} times, expected one each (one "
                "decode launch for the three head scales)")
        cpu = Detector(MODEL, path, device="cpu", conf_threshold=CONF)
        check_detections("4 f32", gpu, imgs, NMS.fetch_detections(got),
                         NMS.fetch_detections(cpu.detect_batch(imgs)), cfg,
                         kind)
        print(f"[4 f32] decode kernel launches {launches}, NMS kernel "
              f"launches {nms_launches}")
        del gpu, cpu

        # 5. main path, bf16 serving
        torch.backends.cudnn.benchmark = True
        det = Detector(MODEL, path, device="cuda",
                       compute_dtype=torch.bfloat16, conf_threshold=CONF)
        x = torch.as_tensor(rng.integers(0, 256, (SERVE_BATCH, cfg.input_size,
                                                  cfg.input_size, 3),
                                         dtype=np.uint8), device=dev)
        torch.cuda.reset_peak_memory_stats()
        step_ms, rates, out = serve_rate(lambda: det.detect_batch(x), len(x))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        out = NMS.fetch_detections(out)
        require(np.isfinite(out.boxes).all() and np.all(out.num > 0),
                "bf16 detections empty or not finite")
        counted_forward("5 bf16", lambda: det.detect_batch(x), decode=1,
                        nms=1)
        net_ms, dec_ms, nms_ms, decoded = step_split(det, x, cfg, CONF)
        step = statistics.median(step_ms)
        float_rate = statistics.median(rates)
        print(f"[5 bf16] detect_batch B={SERVE_BATCH} at {cfg.input_size}, "
              f"images on the card: {float_rate:.1f} img/s median of 3 x 5 "
              f"steps (spread {min(rates):.1f}..{max(rates):.1f}), step "
              f"{step:.2f} ms; backbone {net_ms:.2f} ms, decode "
              f"{dec_ms:.4f} ms, NMS {nms_ms:.4f} ms (device: candidate sort "
              f"+ the kernel), the rest "
              f"{step - net_ms - dec_ms - nms_ms:.2f} ms; "
              f"peak memory {peak:.2f} GiB; mean num {out.num.mean():.1f}; "
              f"on {smi}")
        del det

        # 6. int8 conv kernel vs plain, at the shapes the int8 path runs
        convs = {i for i, sp in enumerate(specs) if isinstance(sp, S.Conv)}
        int8_fields = int8_kernel_phase(
            int8_shapes(specs, cfg, convs - Q.head_conv_layers(specs)), dev)

        # 7. the int8 main path
        int8_launches, qparams, calib, int8_rate, int8_net_ms = \
            int8_path_phase(specs, cfg, path, imgs, x, dev, float_rate, kind)
        del x

        # 8. conv_bnstat kernel vs plain, at the shapes training runs
        v3_err, v3_bnstat = bnstat_kernel_phase(specs, cfg, dev)

        # 9. the f32 training path against the CPU port
        n_fused = sum(bnstat_shapes(specs, cfg).values())
        params, stats = engine.init_params(specs, cfg.input_size, SEED,
                                           obj_bias=OBJ_BIAS)
        torch.backends.cudnn.benchmark = False
        imgs9, tr9 = train_inputs(cfg, TRAIN_PARITY_BATCH, SEED + 9)
        train_parity("9 f32 train", cfg, specs, params, stats, n_fused, dev,
                     imgs=imgs9, tr=tr9)

        # 10. the bf16 training path
        torch.backends.cudnn.benchmark = True
        bnstat_launches = train_rate("10 bf16 train", cfg, specs, params,
                                     stats, dev, n_fused, smi,
                                     batch=TRAIN_BATCH, seed=SEED + 10)[0]
        del params, stats

        # 11-12. yolov2-416: the region head on its real path; 13. yolov1
        v2_launches, v2_path = family_phases(
            "yolov2", ("11 yolov2 f32", "12 yolov2 bf16"), dev, kind, smi,
            tmp)
        _, v1_path = family_phases(
            "yolov1", ("13 yolov1 f32", "13 yolov1 bf16"), dev, kind, smi,
            tmp)
        require(launches == v2_launches == 1, "decode launches per forward: "
                f"yolov3 {launches}, yolov2 {v2_launches}, expected 1 each")

        # 14. the NMS kernel vs plain at phase 5's decode and odd cases
        nms_fields = nms_kernel_phase(decoded, cfg, dev)
        del decoded

        # 15. the fused letterbox
        letterbox_phase(cfg, path, qparams, int8_launches, dev, smi)

        # 16. flip-TTA
        tta_phase(cfg, path, v2_path, qparams, int8_launches, dev, kind, smi)

        # 17. rolling-average smoothing
        smoothing_phase(cfg, {MODEL: path, "yolov2": v2_path,
                              "yolov1": v1_path}, dev, smi)

        # 18. the all-int8-activation path and the int8-in kernel entry
        q_launches, q_fields = int8_act_phase(
            specs, cfg, path, int8_shapes(
                specs, cfg, convs - Q.head_conv_layers(specs)),
            qparams, calib, imgs, dev, int8_rate, int8_net_ms, kind, smi)
        del qparams, calib

        # 19-22. training of the region, grid and classifier families:
        # conv_bnstat at Darknet-19's shapes, f32 parity, bf16 throughput
        # and run_training end to end
        dn_err, dn_bnstat = darknet19_bnstat_phase(dev)
        torch.backends.cudnn.benchmark = False
        families_train_parity_phase(dev)
        torch.backends.cudnn.benchmark = True
        family_rates = families_train_rate_phase(dev, smi)
        # one step each of yolov3 (phase 10), yolov2 and darknet19 (phase
        # 21); phase 19 timed the same launches
        bnstat_launches += (family_rates["yolov2"][0]
                            + family_rates["darknet19-classifier"][0])
        bnstat_entry = bnstat_fields(max(v3_err, dn_err), [
            v3_bnstat, dn_bnstat["yolov2"],
            dn_bnstat["darknet19-classifier"]])
        # run_training leaves cudnn.benchmark as it finds it: a user's
        # default is False
        torch.backends.cudnn.benchmark = False
        run_training_phase(dev, smi, tmp)

        # 23. the int8 kernel at yolov1's 7x7 first conv; int8 yolov1
        v1_qparams, _ = int8_k7_phase(dev, kind, smi, v1_path)

        # 24-26. evaluation, the classifier, in-training evaluation
        eval_phase(dev, kind, smi, tmp, v2_path, v1_qparams)
        del v1_qparams
        classifier_phase(dev, kind, smi, tmp)
        torch.backends.cudnn.benchmark = False
        run_training_eval_phase(dev, smi, tmp)

    print(json.dumps({"kernels": [{
        "name": "decode_fused", "route": "cuda",
        "source": "yolo_tensorflow_tpu_torch/csrc/decode.cu",
        "replaces": "yolo_tensorflow_tpu/ops/pallas/decode.py:82",
        "launches": launches, **decode_fields}, {
        "name": "conv2d_int8", "route": "cuda",
        "source": "yolo_tensorflow_tpu_torch/csrc/conv_int8.cu",
        "replaces": "tools/probe_int8_3x3.py:35",
        "launches": int8_launches, **int8_fields}, {
        "name": "conv2d_int8_q", "route": "cuda",
        "source": "yolo_tensorflow_tpu_torch/csrc/conv_int8.cu",
        "replaces": "tools/probe_int8_3x3.py:35",
        "launches": q_launches, **q_fields}, {
        "name": "conv3x3_bnstat", "route": "cuda",
        "source": "yolo_tensorflow_tpu_torch/csrc/conv_bnstat.cu",
        "replaces": "tools/probe_conv_bnstat.py:47",
        "launches": bnstat_launches, **bnstat_entry}, {
        "name": "greedy_nms", "route": "cuda",
        "source": "yolo_tensorflow_tpu_torch/csrc/nms.cu",
        "replaces": "yolo_tensorflow_tpu/post/nms.py:103",
        "launches": nms_launches, **nms_fields}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
