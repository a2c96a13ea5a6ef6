#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU, and check them.

    python3 chip_smoke.py          # from the repository root; needs one card
    python3 chip_smoke.py --parent DIR   # also times DIR's kernels

``--parent DIR``: an earlier checkout of the repository (``git archive``),
whose csrc/conv_int8.cu and csrc/nms.cu are built beside this one's: its
first-conv kernel is timed in turns with this one's (phases 6, 18 and 23)
and its NMS stage (phase 14); without it those times print as "not
measured".

Phases, one line or more each (a failed phase exits nonzero, and no phase's
failure is caught):
  1. device: the card, as nvidia-smi reports its name and power limit;
  2. build:  nvcc builds the CUDA kernels (decode, int8 conv, fused conv +
             BN statistics, the NMS stage; the two convs share
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
             bit for bit; the direct first-conv kernel at the 3x3 cases of
             DIRECT_ODD (tile edges), both entries, 0 ulp, and at yolov3's
             first conv at batch 64 (bf16 in and out): ms, bound, plain,
             cuDNN's bf16 conv and the parent's kernel in turns. Then, per
             shape at batch 64 in bf16: the kernel
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
 14. nms kernel: the NMS stage, one kernel from the decode to the
             Detections, against its plain version (stable sort, gathers,
             the batched fixpoint) on the card, all five Detections fields
             exactly equal: at the decodes of phases 5, 12 and 13
             (yolov3-416, also in the bf16 scoring mode with its ties, and
             yolov2-416 and yolov1-448, batch 64, K = 256), class-aware off
             and on, yolov3-416 at batch 1 and 8 and at conf 0.05, and at
             the odd cases of NMS_ODD (ties across the K-th, +-0.0, NaN,
             A against K, N = 60000) and K = 9000; the device kernels of
             one call from a torch.profiler trace (the NMS kernel alone);
             at each main-path case the stage's device ms, in turns with
             the parent's stage (with --parent), its bound and the plain
             version's host ms;
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
             mixed kernel's, its plain ms and its bound; the direct kernel
             at yolov3's first conv, int8 in and out, beside the parent's,
             and (with --parent) the other convs' sum beside the parent
             build's, in turns, outputs equal.
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
             K7_ODD and the 7x7 cases of DIRECT_ODD, both entries, f32 and
             bf16, against the plain twins (0 ulp); both entries' times
             beside their bounds, plain times, cuDNN's bf16 conv and the
             parent's kernel; int8
             yolov1-448 (24 quantized convs, the connected head float) f32
             against the CPU port with the int8 conv launched 24 times a
             forward, and bf16 batch-64 img/s beside float yolov1's;
             then the kernel at 5x5, padding-0, stride-3 and the
             GEOM_ODD geometries (a 7x7 stride-9 first conv among them,
             direct or gather by its shared memory), both entries against
             the plain twins
             (0 ulp), timed beside plain and a cuDNN bf16 conv, and a cfg
             whose int8 convs include the first three: one counted
             forward launches the kernel for each of its 5 int8 convs,
             its detections equal to the CPU port's;
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
 27. export: what the yolo_torch operators cost (bf16 and int8 bf16
             detect_batch at batch 64, phases 5 and 7, and at batch 8, the
             server's, through the operators and with their CUDA
             implementations called directly, in turns); then the CLI's
             convert and export (python3 -m yolo_tensorflow_tpu_torch, two
             processes at once) of the bf16 fused letterbox Detector (batch
             8, canvas 832) and the int8 bf16 one (batch 8); each artifact
             loaded with LoadedArtifact: all five outputs equal to the
             Detector's bit for bit, decode 1, NMS 1 and int8 conv 72 (int8)
             launches a call with no host sync, and its call time beside
             the Detector's;
 28. server: serve_http on 127.0.0.1 (batch 8, queue 64, .npy bodies)
             over 16 seeded images of 200-800 px. f32 fused Detector (TF32
             off): 16 clients post every image, each response with
             Detector.detect's classes for the image, boxes within
             FUSED_TOL. Then the bf16 fused Detector and the int8 bf16
             one, each first split (batch_split: B=8 against B=1 on
             identical inputs: the fused letterbox, decode and NMS
             kernels, 8 copies of an image against its row of a mixed
             batch, and the letterbox and detections at two canvas sides,
             all required equal bit for bit; the first layer that differs
             and the end-to-end B=1 gap printed), then 32 client threads
             for 3 s, every 200 response bit for bit a row the card
             computed for the image, and every row served equal bit for
             bit to the serving thread's forward of 8 copies of the image
             at the same canvas; req/s, latency p50/p95, batch
             occupancy and the card's idle share (torch.profiler trace); a
             burst past the queue with the batcher stalled gets 503 with
             Retry-After, a body past the cap 413, and /stats reconciles
             with the responses;
 29. stream: stream_detect over 64 .npy frames of 416^2 through read_fn at
             batch 8, f32: plain, equal to detect_batch of the same frames,
             and smoothed (avg_frames=3), against detect_batch_smoothed
             frame by frame; frames/s.
 30. cli:    the command line through cli.main in this process, at full
             width: yolov2-416 train --npy-images --bf16 --bn-onepass
             (batch 32, 20 steps, --eval-every, --save-every) twice and
             with --remat-every 4 (conv_bnstat 15 launches a step, the
             losses against the spread of the two runs, peak GiB);
             export-darknet --ckpt and eval --npy-images of the trained
             checkpoint over 64 scenes (JSON equal to evaluate_samples,
             decode and NMS once a batch); classify darknet19-256 over
             .npy images; summary, ops, speed (Hz), inspect; partial,
             export-darknet and denormalize of yolov3, and the Detector on
             the denormalized pair against the CPU port; three yolov2-416
             steps whose optimizer runs a cfg's policy=random under
             set_sync_debug_mode("error"), the rates the host table's.
 31. yolov1-darknet: darknet's cfg/yolov1.cfg (YOLOV1_CFG: 24 BN convs,
             [local] 3x3 256 over 7x7x1024, [dropout], [connected] 1715,
             [detection] side 7 num 3) through config_from_cfg and
             Detector(cfg, specs=) from a seeded .weights file: f32 batch 2
             against the CPU port (NMS launched once); bf16 batch 64 img/s
             with the split into backbone, the local layer, the connected
             layer, decode and NMS, one forward counted (nms=1, no host
             sync); then EXOTIC_CFG ([crop], [normalization], BN
             [deconvolutional], [local], [l2norm], [logistic], unfolded-BN
             conv and connected) f32 against the CPU port, folded and with
             running statistics;
 32. char-RNN: darknet's cfg/rnn.cfg (three 1024-wide BN [rnn], 256
             symbols) and the same widths with [gru] and [lstm], seeded
             .weights through textgen.load_charrnn: 512 characters after a
             seed on the card with set_sync_debug_mode("error") around the
             sampling loop, the text equal to the CPU port's for the same
             rng_seed, every step's probabilities within PROB_TOL of the
             CPU port's (both fed the same characters); characters/s
             priming and sampling and the card's idle share over a traced
             run; then two [crnn] layers at 32^2 on the card against the CPU
             port, the state carried across two calls;
 33. qat:    quantization-aware training of yolov3-416 (ops/qat.py): one
             f32 QAT step through make_train_step (33 conv_bnstat
             launches, every scale warmed from zero), each conv on the CPU
             port's inputs against the CPU port (act_ranges equal;
             outputs, batch statistics and gradients within
             LAYER_GRAD_TOL), the whole step's act_ranges, scales, batch
             statistics and gradients against the CPU port by the floor
             of the card's cuDNN path (QAT_TOL, GRAD_FLOOR); bf16 batch-32
             QAT steps in turns with the plain bf16 step (ms each, peak
             GiB, one QAT step's launches, no host sync in it);
             run_training --qat from phase 4's seeded .weights over
             416^2 synthetic scenes (one
             in-training evaluation of the int8 export, a resume, the
             int8-qat.npz it ships); that npz served through the int8
             Detector (f32 epilogue against the CPU port; bf16 batch 64
             img/s and one counted forward: 72 int8 convs, the direct one
             among them, decode and NMS once); each quantized conv of the
             trained fake-quant network against its int8 export's kernel
             (the TPU package's 2e-2 bound) and against the CPU port;
 34. train layers: EXOTIC_CFG less its [crop], one f32 TrainNetwork step
             on the card against the CPU port (heads, batch statistics,
             gradients); rnn.cfg and its [gru]/[lstm] twins at 1024: one
             f32 step at CHARRNN_PARITY against the CPU port, then
             textgen.train_char_rnn at CHARRNN_TRAIN on CORPUS's bytes
             (the loss falling, characters/s trained, the idle share of a
             traced run) and the trained weights' text equal to the CPU
             port's; the CLI's rnn-train, its .weights loaded by generate;
 35. tree, dream: yolov2's region loss with a hand-written softmax tree
             on the card against the CPU port (value, metrics, gradient);
             dream (DREAM_OCTAVES x DREAM_ITERS) on the seeded yolov3-416's
             prefix to DREAM_LAYER, the objective history against the CPU
             port's;
 36. data parallel (parallel/mesh.py): (a) one rank on the card over NCCL:
             make_sharded_train_step against make_train_step, f32 onepass
             at DP_PARITY_BATCH (its 33 conv_bnstat launches counted,
             metrics, running statistics and gradients), bf16 onepass steps
             at DP_RATE_BATCH in turns with the plain step (what the
             collectives cost on one card), the collectives of one step
             counted on the host and in a torch.profiler trace; (b) two
             ranks on the one card (gloo over CUDA tensors: NCCL refuses a
             second rank on a device), each on half of a DP_TWO_BATCH f32
             batch: both ranks' parameters, running statistics and
             gradients equal, and equal to the one-process step over the
             whole batch; (c) run_training over a coordinator of one rank,
             phase 22's yolov2-416 setup for DP_RUN_STEPS steps, its costs
             against the plain run's;
 37. shapes: the synthetic-shapes tools (yolo_tensorflow_tpu_torch/tools/):
             (a) SHAPES_SCENES hard scenes at 416 and at 160 rendered on the
             host without cv2, every box inside its image with positive
             extent, scenes/s, no cv2 module loaded; (b) the in-process demo
             (synthetic_train_demo.main(DEMO_STEPS, "yolov3-tiny"), the easy
             task in f32 from scratch): its float mAP@0.5 on the held-out
             scenes at least DEMO_FLOOR, the flip-TTA, int8 PTQ and int8
             QAT legs in [0, 1], every hand kernel it launches counted (the
             counts join the kernels line); (c) flagship_train at yolov3-416
             cut to FLAGSHIP_PLUMBING in its own process: three fresh CLI
             processes (the run, its resume, the QAT leg), the resume from
             the halfway checkpoint, int8-qat.npz, and the five-leg suite's
             JSON as its last line.
Then a JSON line describing each kernel (conv3x3_bnstat: launches, ms,
bound, plain and library ms all over one step each of yolov3 (phases 8 and
10), yolov2-416 and darknet19-256 (phases 19 and 21), its launches also
over phase 33's QAT step, phase 36's sharded step and phase 37's demo;
conv_int8_direct: its launches in phase 7's int8 forward and phase 37's
demo, its numbers at yolov3's first conv from phase 6; decode, NMS and
conv2d_int8: their launches also over phase 37's demo), and last the JSON
result line.

The weights are random, drawn from a numpy seed (there are no pretrained
weights in the repository), at full width and depth: Darknet-53 + FPN
(yolov3), Darknet-19 + passthrough (yolov2), 80 classes each, the
24-conv + 3-connected yolov1 with 20, and the darknet19 classifier with
1000.
Imports nothing of JAX: the machine with the card has none.
"""

import collections
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

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
# to the JAX package on the first 13 and its transcription of the kernel on
# the others but the last): each with class-aware NMS off and on, the
# kernel equal to the plain version in all five fields. "N = 60000" runs
# the kernel's other layout (keys read again each pass, candidates in
# scratch), as K = NMS_BIG_K does.
NMS_ODD = ("batch 1", "K > N", "D > K", "none active", "all active",
           "chain", "IoU at the threshold", "degenerate", "K = 8", "K = 64",
           "K = 256", "K = 300", "K = 1024", "ties at the K-th", "+0 and -0",
           "NaN and inf", "A < K", "A = K", "A > K", "N = 60000")
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
# Phases 27-29, the serving surface: the HTTP server's default batch, which
# the artifacts and the stream also run at; the fused artifact's canvas (2x
# the input); the HTTP load (client threads, seconds, a pool of seeded
# images of mixed sizes, the queue depth and body cap); the stream's frames
SERVE_HTTP_BATCH = 8
EXPORT_CANVAS = 832
HTTP_CLIENTS = 32
HTTP_SECONDS = 3.0
HTTP_POOL = 16
HTTP_SIDES = (200, 800)
HTTP_QUEUE = 64
HTTP_BODY_CAP = 4 << 20
STREAM_FRAMES = 64
SPLIT_BATCH = 8          # phase 28's split: the server's batch
CLI_BATCH = 32           # phase 30: train's batch
CLI_STEPS = 20
CLI_REMAT = 4
CLI_SCENES = 64          # synthetic 416x416 scenes, .npy
CLI_EVAL_BATCH = 16
CLI_CLASSIFY = 4
CLI_TICS = 50            # speed's forwards
CLI_ECHO = 4             # output lines of each command echoed
DENORM_DRIFT = 1e-3      # denormalize's sqrt(var + 1e-5) against the BN form
GEOM_CONF = 0.3          # phase 23's shallow int8 geometry net
# The direct first-conv kernel (Cin 3) at its tile edges, (batch, k,
# stride, pad, Cout, H, W): H and W off every multiple of its 8 x 32 output
# tile times the stride (M ragged at the CTA), Cout 8 to the most, stride 3
# and padding 0 and k - 1, 1x1 images. Phase 6 runs the 3x3 ones, phase 23
# the 7x7 ones, both entries against the plain twins, 0 ulp.
DIRECT_ODD = ((3, 3, 1, 1, 8, 37, 45), (3, 3, 2, 1, 24, 29, 70),
              (3, 3, 3, 0, 16, 23, 101), (3, 3, 1, 0, 32, 9, 33),
              (1, 3, 1, 1, 16, 1, 1), (3, 7, 2, 3, 48, 47, 66),
              (3, 7, 1, 0, 8, 15, 40), (3, 7, 3, 2, 24, 30, 100),
              (2, 7, 2, 6, 64, 11, 13), (1, 7, 2, 3, 64, 1, 1))
# phase 23's odd geometries (k, stride, pad, Cin, Cout, side, batch): a
# Cin-3 first conv at 5x5 (gather), at 3x3 stride 3 and at 3x3 padding 0
# (the direct kernel), at 7x7 stride 9 (the direct kernel's patch passes
# its shared memory with float32 out, so f32 and the int8-in entry's
# float32 out take gather, bf16 and int8 out the direct kernel), an even
# 2x2 stride-2 conv, padding past k // 2, a 5x5 stride 2, ragged Cout
GEOM_ODD = ((5, 1, 2, 3, 32, 37, 2), (3, 3, 1, 3, 32, 40, 2),
            (3, 1, 0, 3, 16, 23, 3), (7, 9, 3, 3, 64, 100, 2),
            (2, 2, 0, 16, 32, 19, 2), (3, 1, 2, 16, 24, 11, 2),
            (5, 2, 2, 64, 72, 30, 2), (1, 3, 0, 32, 40, 17, 1))


def _conv_section(filters, size, stride):
    return ("[convolutional]\nbatch_normalize=1\n"
            f"filters={filters}\nsize={size}\nstride={stride}\npad=1\n"
            "activation=leaky\n")


_MAXPOOL = "[maxpool]\nsize=2\nstride=2\n"
# darknet's cfg/yolov1.cfg (pjreddie/darknet): 448^2, 24 BN convs, then
# [local] 3x3 256 over 7x7x1024, [dropout], [connected] 1715 and
# [detection] side 7 num 3 classes 20. Its sections in file order, the
# convs from a table ((filters, size, stride) or a maxpool).
YOLOV1_CONVS = ((64, 7, 2), "M", (192, 3, 1), "M", (128, 1, 1), (256, 3, 1),
                (256, 1, 1), (512, 3, 1), "M") + ((256, 1, 1),
                                                   (512, 3, 1)) * 4 + (
    (512, 1, 1), (1024, 3, 1), "M") + ((512, 1, 1), (1024, 3, 1)) * 2 + (
    (1024, 3, 1), (1024, 3, 2), (1024, 3, 1), (1024, 3, 1))
YOLOV1_CFG = ("""[net]
batch=64
subdivisions=64
height=448
width=448
channels=3
momentum=0.9
decay=0.0005
saturation=1.5
exposure=1.5
hue=.1

learning_rate=0.0005
policy=steps
steps=200,400,600,20000,30000
scales=2.5,2,2,.1,.1
max_batches = 40000

""" + "\n".join(_MAXPOOL if c == "M" else _conv_section(*c)
                 for c in YOLOV1_CONVS) + """
[local]
size=3
stride=1
pad=1
filters=256
activation=leaky

[dropout]
probability=.5

[connected]
output= 1715
activation=linear

[detection]
classes=20
coords=4
rescore=1
side=7
num=3
softmax=0
sqrt=1
jitter=.2

object_scale=1
noobject_scale=.5
class_scale=1
coord_scale=5
""")
V1_FULL_CONF = 0.2       # config_from_cfg's [detection] threshold
# every other new section in one narrow net: tests/test_oracle_parity.py's
# EXOTIC_CFG with batch norm in a conv, the deconv and a connected layer,
# and an unfolded-BN conv and connected layer run from running statistics
EXOTIC_CFG = """[net]
height=96
width=96
channels=3

[crop]
crop_height=88
crop_width=88

[convolutional]
batch_normalize=1
filters=32
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
filters=16
size=3
stride=1
pad=1
activation=relu

[normalization]
size=5

[local]
filters=8
size=3
stride=1
pad=1
activation=leaky

[deconvolutional]
batch_normalize=1
filters=12
size=4
stride=2
padding=1
activation=leaky

[l2norm]

[logistic]

[convolutional]
batch_normalize=1
filters=16
size=3
stride=2
pad=1
activation=leaky

[connected]
batch_normalize=1
output=64
activation=leaky

[connected]
output=10
activation=linear
"""
EXOTIC_BATCH = 4
EXOTIC_TOL = dict(rtol=1e-4, atol=1e-5)
# darknet's cfg/rnn.cfg: a char-RNN over 256 byte symbols, three 1024-wide
# BN [rnn] layers, [connected] 256, [softmax]; the same widths with [gru]
# and with [lstm] in its place
RNN_NET = """[net]
subdivisions=1
inputs=256
batch = 1
momentum=0.9
decay=0.001
max_batches = 2000
time_steps=1
learning_rate=0.1
policy=steps
steps=1000,1500
scales=.1,.1

"""
RNN_TAIL = """[connected]
output=256
activation=leaky

[softmax]

[cost]
type=sse
"""
CHARRNN_CELLS = {
    "rnn": "[rnn]\nbatch_normalize=1\noutput = 1024\nhidden=1024\n"
           "activation=leaky\n",
    "gru": "[gru]\nbatch_normalize=1\noutput = 1024\n",
    "lstm": "[lstm]\nbatch_normalize=1\noutput = 1024\n"}
CHARRNN_SEED = ("In the beginning the darknet framework read a config file "
                "and a weights file, and then it wrote text. ")
CHARRNN_N = 512          # characters sampled
CHARRNN_TEMP = 0.7
PROB_TOL = dict(rtol=1e-5, atol=1e-8)
# a [crnn] at a narrow feature map: 2 layers, 32x32, batch 4, 8 steps
CRNN_CFG = """[net]
height=32
width=32
channels=3

[crnn]
batch_normalize=1
output_filters=32
hidden_filters=32
activation=leaky

[crnn]
batch_normalize=1
output_filters=16
hidden_filters=32
activation=leaky
"""
CRNN_STEPS, CRNN_BATCH = 8, 4
# its outputs after 8 steps of 3x3 convs through the state: cuDNN's and the
# CPU's float32 sums differ by up to 2.3e-5 (measured on one
# NVIDIA H100 80GB HBM3, 700.00 W), so TAIL_TOL's atol
CRNN_TOL = dict(rtol=1e-4, atol=1e-4)
# Phase 33, quantization-aware training of yolov3-416: the card's step
# against the CPU port's (f32, onepass, batch 2). A fake-quantized net
# carries a rounding tie of its float32 sums over to a whole lattice step
# (one input an ulp from a tie snaps the other way), and each step moves
# the inputs of the next quantized conv and more of them snap: over 72
# quantized convs two correct float32 evaluations drift apart (on the CPU
# at 64^2, the kernel path and the cuDNN path's costs 449.47 and 452.45,
# their gradients a relative L2 of 1.1 apart). So each conv is held on its
# own inputs (qat_layer_parity, LAYER_GRAD_TOL), and the whole step's
# act_ranges, scales and batch statistics, each as one vector, within a
# relative L2 of QAT_TOL (TRAIN_TOL for the statistics) of the CPU port's
# or GRAD_FLOOR[0] x the distance of the card's cuDNN path (no kernel)
# from it, whichever is larger, the gradients by GRAD_FLOOR; the cost is
# printed beside both.
QAT_TOL = dict(ranges=1e-6)
QAT_SCENES = 32          # 416x416 scenes: the evaluation needs no resize
QAT_RUN_BATCH = 8
QAT_RUN_STEPS = (12, 20)  # the first call (its evaluation at 12), resumed
# from phase 4's seeded .weights at a small rate: at 1e-3 the objectness of
# a 20-step run collapsed to 0 in some runs and not in others, and the
# export then had nothing to detect
QAT_RUN_LR = 1e-5
QAT_CONF = 0.005
# Phase 34, training darknet's other layers: the exotic cfg less its [crop]
# (train-time crops are the data pipeline's) and the char-RNN family, card
# against the CPU port; gradients within 1e-4 of each leaf's largest (the
# port's CPU tests hold the JAX package there)
LAYER_GRAD_TOL = 1e-4
CHARRNN_PARITY = (4, 8)  # (batch, time steps) of the card-vs-CPU step
# phase 34's text: a pinned copy of an earlier README.md, so that editing
# the documentation does not change the phase's input. Its card-vs-CPU step
# holds each gradient to GRAD_FLOOR[0] x the CPU port's own float64
# distance; the windows a later README.md gives put one leaf of [rnn]'s BN
# over 4 rows past that bound whatever the port's code (ROADMAP.md, Queue
# 3)
CORPUS = "chip_smoke_corpus.txt"
CHARRNN_TRAIN = (32, 64)  # train_char_rnn's default batch and steps
CHARRNN_ITERS = {"rnn": 30, "gru": 10, "lstm": 10}
# a 4-row batch norm in each step divides by a 4-sample deviation:
# outputs and statistics at the recurrent tests' train tolerance
CHARRNN_TOL = dict(rtol=1e-4, atol=1e-5)
CHARRNN_GEN = 128        # characters the trained weights generate
# Phase 35: a hand-written softmax tree (YOLO9000's WordTree form: "name
# parent" lines) and dream on a yolov3-416 prefix
TREE_TEXT = ("n0 -1\nn1 -1\nn2 0\nn3 0\nn4 1\nn5 3\nn6 3\nn7 4\nn8 4\n"
             "n9 4\n")
TREE_TOL = dict(rtol=1e-5, atol=1e-7)
DREAM_LAYER = 10         # yolov3's 11th layer: 104x104x128, after the
                         # second residual stage's first block
DREAM_OCTAVES, DREAM_ITERS = 2, 3
# the objective is 0.5 sum(out^2) over the outputs above mean + sigma:
# float32 sums of ~1.4 M terms in another order, and an output within an
# ulp of the threshold may fall on either side. Such an output's gradient
# is in the mask on one device and not on the other, and moves the pixels
# it sees by several levels after the update's normalization (up to 4 on
# an H100): the images are held by the share of pixels more than a level
# apart
DREAM_TOL = 1e-4
DREAM_PIXELS = 1e-3
DP_PARITY_BATCH = 2      # phase 36 (a): f32, phase 9's batch
DP_RATE_BATCH = 32       # phase 36 (a): bf16, phase 10's batch
DP_TWO_BATCH = 4         # phase 36 (b): two ranks of two rows on one card
DP_RUN_STEPS = 4         # phase 36 (c): run_training steps of each run
# phase 36 (b): tests/test_torch_parallel.py's tolerances for parameters
# and running statistics after one step
DP_LEAF_TOL = dict(rtol=5e-4, atol=5e-6)
SHAPES_SCENES = 64       # phase 37 (a): hard scenes at each of 416, 160
DEMO_STEPS = 1200        # phase 37 (b): the demo's easy run, f32
DEMO_FLOOR = 0.25        # its float mAP@0.5: half the TPU record's 0.52 at
                         # 1200 steps, both runs from scratch
FLAGSHIP_PLUMBING = dict(n_train=32, n_val=8, steps=4, qat_steps=2, every=2)


def require(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, iters=20, warmup=3, ahead_cycles=0):
    """The port's utils/profiling.cuda_ms: mean device time of fn() in ms
    from CUDA events (``ahead_cycles``: the card spins first, so that the
    host has queued every call before the first one runs)."""
    from yolo_tensorflow_tpu_torch.utils.profiling import cuda_ms as timed
    return timed(fn, iters, warmup, ahead_cycles)


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
            "int8": (Q8, "launches"), "int8_q": (Q8, "launches_q"),
            "int8_direct": (Q8, "launches_direct")}


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


def int8_cost(batch, k, stride, cin, cout, h, in_bytes, out_bytes,
              pad=None):
    """(bytes, int8 ops) of one quantized conv (padding ``pad``, by default
    k // 2): input read once, weights, scales and bias read once, output
    written once; 2 ops per MAC."""
    pad = k // 2 if pad is None else pad
    ho = (h + 2 * pad - k) // stride + 1
    m = batch * ho * ho
    nbytes = (batch * h * h * cin * in_bytes + cout * k * k * cin + 8 * cout
              + m * cout * out_bytes)
    return nbytes, 2 * m * cout * k * k * cin


def int8_kernel_phase(shapes, dev, smi, parent):
    """Phase 6. Returns the kernel's JSON fields measured here, and the
    direct first-conv kernel's at yolov3's first conv (timed beside
    ``parent``'s, where given)."""
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
    direct_odd_check("6 int8 direct", dev, (3,))
    (k, stride, _, cout, h), = [s for s in shapes if s[2] == 3]
    direct_fields = direct_times("6 int8 direct", k, stride, cout, h, 0, dev,
                                 smi, parent)

    tot = collections.Counter()
    for (k, stride, cin, cout, h), n in sorted(shapes.items(),
                                              key=lambda kv: -kv[0][4]):
        x, w_q, s_x, s_w, b = int8_operands(gen, dev, SERVE_BATCH, k, cin,
                                            cout, h, torch.bfloat16)
        kw = dict(stride=stride, act="leaky", epilogue_dtype=torch.bfloat16)
        ms = cuda_ms(lambda: Q8.conv2d_int8(x, w_q, s_x, s_w, b, **kw),
                     iters=10)
        instance, bn = Q8.plan(x, w_q)
        # the direct kernel quantizes in shared memory: no prologue pass
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
    return ({"max_abs_err": max_err, "ms": tot["ms"],
             "plain_ms": tot["plain"], "bound_ms": tot["bound"],
             "bound_by": by, "library_ms": None}, direct_fields)


def step_split(det, x, cfg, conf):
    """Device ms of the parts of one serving forward of ``det`` on the
    uint8 images ``x``, from CUDA events with the host kept ahead of the
    card for the short ones: (backbone, decode, NMS: the one kernel of the
    stage), and the decode's outputs."""
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
    """Phase 7. Returns the int8 conv launches of one forward (all, and
    those of the direct first-conv kernel), the int8 params, the
    calibration batches, and the bf16 batch-SERVE_BATCH img/s and backbone
    ms."""
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
    Q8.launches = Q8.launches_direct = K.launches = NK.launches = 0
    got = gpu.detect_batch(imgs)               # f32 epilogue: parity mode
    torch.cuda.synchronize()
    launches, dec_launches = Q8.launches, K.launches
    direct_launches = Q8.launches_direct
    require(launches == n_int8 and direct_launches == 1
            and dec_launches == NK.launches == 1,
            f"int8 path launched the int8 conv {launches} times (expected "
            f"{n_int8}), the direct first-conv kernel {direct_launches} "
            f"times, the decode {dec_launches} times and NMS "
            f"{NK.launches} times (expected 1 each)")
    cpu = Detector(MODEL, params=qparams, device="cpu", conf_threshold=CONF)
    check_detections("7 int8 f32", gpu, imgs, NMS.fetch_detections(got),
                     NMS.fetch_detections(cpu.detect_batch(imgs)), cfg, kind)
    print(f"[7 int8 f32] one forward launched the int8 conv {launches} times "
          f"(the direct first-conv kernel {direct_launches} of them) and the "
          f"decode and NMS once each")
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
                    int8=n_int8, int8_direct=1, decode=1, nms=1)
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
    return (launches, direct_launches, qparams, calib,
            statistics.median(rates), net_ms)


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


def grad_floor_check(label, names, g_card, g_alt, g_cpu,
                     what=("kernel path", "cuDNN path")):
    """Each of ``names`` ((layer, leaf)) of the card's gradients within
    GRAD_FLOOR of the CPU's, against the distance of the card's cuDNN path
    (``g_alt``) from the CPU. ``what`` names the two in the summary it
    returns for the phase's line."""
    errs = [rel_l2(g_card[k][n], g_cpu[k][n]) for k, n in names]
    floors = [rel_l2(g_alt[k][n], g_cpu[k][n]) for k, n in names]
    mid = statistics.median(floors)
    ratios = [e / max(f, mid, 1e-30) for e, f in zip(errs, floors)]
    worst = max(range(len(names)), key=ratios.__getitem__)
    for (k, n), e, f in zip(names, errs, floors):
        require(e <= GRAD_FLOOR[0] * max(f, mid) + GRAD_FLOOR[1],
                f"{label}: gradient {k}/{n}: relative L2 {e:.3g} from the "
                f"CPU, against {f:.3g} for the {what[1]} (median "
                f"{mid:.3g})")
    flat = lambda g: torch.cat([g[k][n].flatten() for k, n in names])
    e_all = rel_l2(flat(g_card), flat(g_cpu))
    f_all = rel_l2(flat(g_alt), flat(g_cpu))
    require(e_all <= GRAD_FLOOR[0] * f_all + GRAD_FLOOR[1],
            f"{label}: all gradients: relative L2 {e_all:.3g} against "
            f"{f_all:.3g}")
    return (f"relative L2 per parameter: {what[0]} median "
            f"{statistics.median(errs):.3g}, max {max(errs):.3g}; {what[1]} "
            f"median {statistics.median(floors):.3g}, max "
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


def random_policy_phase(dev, smi):
    """Phase 30 (random): yolov2-416 bf16 onepass steps at batch 2 whose
    optimizer comes from a [net] section with policy=random (the rate
    table goes to the card at the first step); three more steps under
    set_sync_debug_mode("error"), and the schedule's rates on the card
    equal to threefry.random_policy_rates bit for bit."""
    from yolo_tensorflow_tpu_torch.train import loop as TL
    from yolo_tensorflow_tpu_torch.train import threefry
    cfg, specs, params, stats, _ = family_model("yolov2", SEED + 30)
    net = {"policy": "random", "learning_rate": "0.001", "power": "4",
           "burn_in": "0", "max_batches": "1000"}
    opts = TL.NetTrainOptions.from_net(net)
    tx = TL.optimizer_from_net(opts, batch=2)
    state = TL.create_train_state(cfg, tx, device=dev, params=params,
                                  batch_stats=stats, specs=specs)
    imgs, tr = (torch.as_tensor(a, device=dev)
                for a in train_inputs(cfg, 2, SEED + 30))
    step = TL.make_train_step(cfg, tx, specs=specs,
                              compute_dtype=torch.bfloat16,
                              bn_stats="onepass")
    state, m = step(state, imgs, tr)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            state, m = step(state, imgs, tr)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    cost = float(m["cost"])
    got = tx.schedule(torch.arange(1000, device=dev)).cpu().numpy()
    want = threefry.random_policy_rates(1e-3, 4.0, np.arange(1000))
    require(np.isfinite(cost) and np.array_equal(got.view(np.int32),
                                                 want.view(np.int32)),
            f"30 random: cost {cost}, rates {got[:3]} vs {want[:3]}")
    print(f"[30 random] yolov2-{cfg.input_size} B=2 bf16 onepass, "
          f"policy=random: 3 steps under set_sync_debug_mode('error'), no "
          f"host sync, cost {cost:.5g}; the schedule's rates on the card "
          f"for steps 0..999 equal to the host's bit for bit; on {smi}")
    del state, params, stats
    torch.cuda.empty_cache()


def scenes(n, seed, height=480, width=640):
    """n synthetic RGB scenes (480x640 by default) of numpy rectangles on a
    noisy background and their darknet label lines (class cx cy w h)."""
    rng = np.random.default_rng(seed)
    imgs, labels = [], []
    for _ in range(n):
        img = rng.integers(0, 64, (height, width, 3), dtype=np.uint8)
        rows = []
        for _ in range(int(rng.integers(1, 6))):
            w = int(rng.integers(40, min(320, width - 8)))
            h = int(rng.integers(40, min(240, height - 8)))
            x0 = int(rng.integers(0, width - w))
            y0 = int(rng.integers(0, height - h))
            img[y0:y0 + h, x0:x0 + w] = rng.integers(64, 256, 3)
            rows.append(f"{int(rng.integers(0, 80))} "
                        f"{(x0 + w / 2) / width:.6f} "
                        f"{(y0 + h / 2) / height:.6f} {w / width:.6f} "
                        f"{h / height:.6f}")
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
    net_ms, dec_ms, nms_ms, decoded = step_split(det, x, cfg, conf)
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
          f"({how}), NMS {nms_ms:.4f} ms (device: one kernel), the "
          f"rest {step - net_ms - dec_ms - nms_ms:.2f} ms; "
          f"{'; '.join(extra)}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; mean num "
          f"{out.num.mean():.1f}; on {smi}")
    return launches, path, (decoded, conf)


def nms_odd_case(name, rng, dev):
    """(boxes, scores, labels) on the card and the NMS options of one odd
    case of NMS_ODD; scores distinct but in the tie, +-0 and NaN cases
    (tests/test_torch_nms.py builds the same cases)."""
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
    elif name == "ties at the K-th":
        # bf16-rounded scores: exact ties, across the K-th among them
        b, s, c = random()
        s = torch.from_numpy(rng.uniform(0.3, 0.9, s.shape).astype(
            np.float32)).to(torch.bfloat16).float().numpy()
    elif name == "+0 and -0":
        # all active at conf -0.5; the K-th among many +-0.0 in any order
        b, s, c = random()
        s = rng.choice(np.float32([0.5, 0.25, 0.0, -0.0, -0.25]), s.shape,
                       p=[0.05, 0.05, 0.3, 0.3, 0.3])
        kw = dict(conf_threshold=-0.5)
    elif name == "NaN and inf":
        b, s, c = random()
        s[:, ::7] = np.nan
        s[:, 3::11] = np.inf
        s[:, 5::13] = -np.inf
        b[:, 1::17, 2] = np.nan                        # NaN and inf boxes
        b[:, 2::19, 3] = np.inf
    elif name in ("A < K", "A = K", "A > K"):
        # K = 64 of 300, exactly 40, 64 or 100 active in each image
        b, s, c = random()
        a = {"A < K": 40, "A = K": 64, "A > K": 100}[name]
        s = s * 0.29
        for img in range(s.shape[0]):
            on = rng.choice(s.shape[1], a, replace=False)
            s[img, on] = rng.permutation(a) / a * 0.6 + 0.35
    elif name == "N = 60000":
        b, s, c = random(n=60000)
        kw = dict(num_candidates=256)
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
    equal bit for bit. Returns the kernel's Detections."""
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
        require(same_bits(getattr(got, field), getattr(want, field)),
                f"{label}: kernel != plain in {field}")
    return got


def same_bits(a, b):
    """Equal shapes, dtypes and bits (a NaN equals itself, -0.0 does not
    equal +0.0)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and torch.equal(a, b)


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


def parent_nms(parent):
    """Start nvcc on ``parent``'s csrc/nms.cu alone; returns a function that
    waits for it and gives (library with yolo_nms declared, whether its
    yolo_nms takes ranked candidates: the kernel before this one)."""
    from yolo_tensorflow_tpu_torch.ops.kernels import build
    from yolo_tensorflow_tpu_torch.ops.kernels import direct_probe as DP
    csrc = os.path.join(parent, "yolo_tensorflow_tpu_torch", "csrc")
    with open(os.path.join(csrc, "nms.cu")) as f:
        params = re.search(r'extern "C" int yolo_nms\(([^)]*)\)',
                           f.read()).group(1).count(",") + 1
    job = DP.start_build("parent_nms", csrc, source="nms.cu")

    def finish():
        lib = DP.finish_build(job)
        vp, i, f32 = build.VP, build.INT, build.F32
        ranked = params == 15
        lib.yolo_nms.argtypes = ([vp] * 3 + [i] * 3 + [f32, f32, i]
                                 + [vp] * 6 if ranked
                                 else build.SIGNATURES["yolo_nms"][0])
        lib.yolo_nms.restype = i
        return lib, ranked
    return finish


def parent_stage(parent, decoded, kw):
    """The parent's NMS stage on ``decoded``, launched directly: its
    candidate sort and gathers, then its own csrc/nms.cu on the ranked
    candidates (or, a parent with this design, its one launch)."""
    from yolo_tensorflow_tpu_torch.ops.kernels import nms as NK
    lib, ranked = parent
    boxes, scores, labels = decoded
    b, n = scores.shape
    d = kw["max_detections"]
    out = NK._outputs(b, d, boxes.device)
    stream = torch.cuda.current_stream().cuda_stream
    opts = (kw["conf_threshold"], kw["iou_threshold"], int(kw["class_aware"]))
    if ranked:
        cb, cs, cl = (t.contiguous() for t in NK.select_candidates(
            boxes, scores, labels, conf_threshold=kw["conf_threshold"],
            num_candidates=kw["num_candidates"]))
        err = lib.yolo_nms(cb.data_ptr(), cs.data_ptr(), cl.data_ptr(), b,
                           cs.shape[1], d, *opts,
                           *(t.data_ptr() for t in out), stream)
    else:
        p = NK.plan(n, kw["num_candidates"], d)
        scratch = None if p.staged else torch.empty(
            (b * p.scratch_bytes,), dtype=torch.uint8, device=boxes.device)
        err = lib.yolo_nms(boxes.data_ptr(), scores.data_ptr(),
                           labels.data_ptr(), b, n, p.candidates, d, *opts,
                           None if scratch is None else scratch.data_ptr(),
                           *(t.data_ptr() for t in out), stream)
    require(err == 0, f"the parent's nms kernel failed: CUDA error {err}")
    return out


def nms_stage_times(label, decoded, kw, got, parent, smi):
    """Phase 14's times of one NMS stage: the kernel's device ms with the
    host kept ahead, in turns with the parent's stage where there is one
    (parent, kernel, kernel, parent; its Detections equal the kernel's),
    the plain version's host ms, and the bound of this data. Returns the
    kernels line's fields."""
    from yolo_tensorflow_tpu_torch.ops.kernels import nms as NK
    from yolo_tensorflow_tpu_torch.post import nms as NMS
    boxes, scores, labels = decoded
    batch, n = scores.shape
    conf, d = kw["conf_threshold"], kw["max_detections"]
    turns = [("kernel", lambda: NMS.batched_nms_scored(*decoded, **kw))] * 2
    if parent is not None:
        par = parent_stage(parent, decoded, kw)
        torch.cuda.synchronize()
        for name, a, b in zip(NMS.Detections._fields, par, got):
            require(same_bits(a, b), f"{label}: the parent's stage "
                    f"differs in {name}")
        par_fn = (lambda: parent_stage(parent, decoded, kw))
        turns = [("parent", par_fn)] + turns + [("parent", par_fn)]
    times = collections.defaultdict(list)
    for name, fn in turns:
        times[name].append(cuda_ms(fn, ahead_cycles=SPIN))
    ms = statistics.mean(times["kernel"])
    plain_ms = statistics.median(
        wall_ms(lambda: NMS.batched_nms_scored_plain(*decoded, **kw), 3)
        for _ in range(3))
    top = NK.select_candidates(boxes, scores, labels, conf_threshold=conf,
                               num_candidates=kw["num_candidates"])
    ious, selected, kept = nms_ious(top, kw)
    active = int((scores > conf).sum())
    nbytes = batch * n * 4 + selected * 20 + batch * (d * 25 + 4)
    bnd, by = bound_ms(nbytes, ious * NMS_FLOPS, F32_OPS_S)
    parent_ms = (statistics.mean(times["parent"]) if parent is not None
                 else None)
    par_txt = ("the parent's stage (stable sort + gathers + its nms.cu) "
               + " / ".join(f"{t:.4f}" for t in times["parent"])
               + f" ms, {parent_ms / ms:.2f}x the kernel's, Detections "
               "equal" if parent is not None
               else "the parent's stage not measured (no --parent)")
    print(f"[14 nms kernel] {label}: N={n} K={top[1].shape[1]} D={d} conf "
          f"{conf} class-aware {kw['class_aware']}: {active} active, "
          f"{selected} selected, {kept} kept, num {got[4].sum().item()} in "
          f"all; the stage {' / '.join(f'{t:.4f}' for t in times['kernel'])}"
          f" ms (device, host kept ahead, one launch); bound {bnd:.6f} ms "
          f"({by}: {nbytes} bytes, {ious} IoUs walked), {ms / bnd:.0f}x it; "
          f"{par_txt}; plain {plain_ms:.2f} ms (host clock: it syncs); on "
          f"{smi}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
            "bound_by": by, "library_ms": None, "parent_ms": parent_ms}


def nms_stage_kernels(decoded, kw):
    """Names of the device kernels of one batched_nms_scored call, from a
    torch.profiler trace with CUDA activity only (memcpy and memset
    included)."""
    from yolo_tensorflow_tpu_torch.post import nms as NMS
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        NMS.batched_nms_scored(*decoded, **kw)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "nms.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return [e["name"] for e in events
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def nms_kernel_phase(mains, cfg, dev, smi, parent):
    """Phase 14. The NMS kernel against its plain version, all five fields
    exactly equal: at the main paths' decodes (``mains``: label ->
    (decoded, conf); yolov3-416 batch 64 also in the bf16 scoring mode, at
    batch 1 and 8), class-aware off and on, the odd cases and K =
    NMS_BIG_K; the device kernels of one call from a profiler trace; the
    stage's times (``nms_stage_times``) at the main paths. Returns the
    kernels line's fields (yolov3-416, batch 64, CONF)."""
    from yolo_tensorflow_tpu_torch.ops.kernels import nms as NK
    from yolo_tensorflow_tpu_torch.post import nms as NMS
    base = dict(iou_threshold=cfg.iou_threshold,
                max_detections=cfg.max_detections, num_candidates=256)
    main = f"{MODEL}-{cfg.input_size}"
    v3, _ = mains[main]
    runs = [(label, decoded, conf, aware)
            for label, (decoded, conf) in mains.items()
            for aware in (False, True)]
    runs += [(main, tuple(t[:b] for t in v3), CONF, False) for b in (1, 8)]
    runs += [(main, v3, 0.05, aware) for aware in (False, True)]
    fields = None
    for label, decoded, conf, aware in runs:
        kw = dict(base, conf_threshold=conf, class_aware=aware)
        scores = decoded[1]
        top = torch.sort(torch.where(scores > conf, scores, -1.0), dim=1,
                         descending=True).values
        k = min(256, scores.shape[1])
        ties = (int(((top[:, k - 1] == top[:, k]) & (top[:, k] > conf))
                    .sum()) if k < scores.shape[1] else 0)
        got = nms_check(f"NMS {label} B={scores.shape[0]} conf {conf} "
                        f"class-aware {aware} ({ties} images with a tie "
                        "across the K-th)", decoded, kw)
        times = nms_stage_times(f"{label}, B={scores.shape[0]}", decoded,
                                kw, got, parent, smi)
        if fields is None:                 # the main path: runs[0]
            fields = times
    names = nms_stage_kernels(v3, dict(base, conf_threshold=CONF,
                                       class_aware=False))
    require(len(names) == 1 and "nms_kernel" in names[0],
            f"one batched_nms_scored call ran {names} on the card, "
            "expected the NMS kernel alone")
    print(f"[14 nms kernel] the device kernels of one batched_nms_scored "
          f"call (torch.profiler, CUDA activity): {names}")
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
    big = NK.plan(NMS_BIG_K, NMS_BIG_K, NMS_ODD_KW["max_detections"])
    candidates, kw = nms_odd_case(f"K = {NMS_BIG_K}", rng, dev)
    nms_check(f"NMS K = {NMS_BIG_K} (candidates in scratch)", candidates, kw)
    print(f"[14 nms kernel] {cases} odd cases ({', '.join(NMS_ODD)}; each "
          f"class-aware off and on) and K = {NMS_BIG_K} ({big.shared_bytes} "
          f"bytes of shared memory, {big.scratch_bytes} of scratch an "
          "image): one launch each, equal to plain in all five fields")
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
                   mixed_rate, mixed_net_ms, kind, smi, parent):
    """Phase 18, the all-int8-activation path. Returns the int8-in
    entry's launches in one forward and its JSON fields."""
    from yolo_tensorflow_tpu_torch.io import weights as W
    from yolo_tensorflow_tpu_torch.models import engine, heads
    from yolo_tensorflow_tpu_torch.models import specs as S
    from yolo_tensorflow_tpu_torch.ops import layers as L
    from yolo_tensorflow_tpu_torch.ops import quant as Q
    from yolo_tensorflow_tpu_torch.ops.kernels import build
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
    outs_cpu = Q.calibrate_outputs(specs, folded, calib[:1], cfg=cfg,
                                   device="cpu")
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
        int8_direct=1, decode=1, nms=1))
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
                    int8_q=n_q, int8=0, int8_direct=1, decode=1, nms=1)
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
        fn = lambda: Q8.conv2d_int8_q(xq, s_in, w_q, s_w, b, s_out=s_out,
                                      **kw)
        ms = cuda_ms(fn, iters=10)
        if parent is not None and Q8.plan_q(xq, w_q)[0] != "direct":
            # this build's wgmma / gather instances and the parent build's,
            # launched the same way (no operator dispatch) with the host
            # kept ahead, in turns: kernel, parent, kernel, parent
            def launcher(lib):
                return lambda: Q8._launch_q(xq, s_in, w_q, s_w, b, stride,
                                            k // 2, "leaky", s_out, lib)
            own, par = launcher(build.load()), launcher(parent)
            require(torch.equal(par(), fn()), f"18 int8-in k{k} "
                    f"{cin}->{cout}: the parent's kernel differs")
            g_ms, p_ms = [], []
            for _ in range(2):
                g_ms.append(cuda_ms(own, iters=10, ahead_cycles=SPIN))
                p_ms.append(cuda_ms(par, iters=10, ahead_cycles=SPIN))
            tot["gemm"] += n * min(g_ms)
            tot["parent_gemm"] += n * min(p_ms)
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
    if parent is not None:
        print(f"[18 int8-act kernel] the {sum(shapes.values()) - 1} wgmma / "
              f"gather convs, timed in turns with the parent's build: "
              f"{tot['gemm']:.3f} ms, the parent's {tot['parent_gemm']:.3f} "
              f"ms (outputs equal); on {smi}")
    (k, stride, _, cout, h), = [s for s in shapes if s[2] == 3]
    direct_times("18 int8-act direct", k, stride, cout, h, 1, dev, smi,
                 parent)
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


def int8_entries_check(label, ops, stride, used, pad=None):
    """Both entries of the int8 kernel at one conv (a 7x7 one, or any other
    geometry, padding ``pad``, by default k // 2) against their plain
    twins, leaky and linear: the f32/bf16-in entry's output, the int8-in
    entry's int8 and float32 outputs, all equal (0 ulp)."""
    from yolo_tensorflow_tpu_torch.ops.kernels import conv_int8 as Q8
    x, w_q, s_x, s_w, b = ops
    dtype = x.dtype
    for act in ("leaky", "linear"):
        kw = dict(stride=stride, pad=pad, act=act)
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
                f"{label} {act} {Q8.plan(x, w_q, stride, dtype)}: "
                f"{ulp_distance(got, want)} ulps from plain")
        for g, w in outs:
            require(torch.equal(g, w), f"{label} {act} int8-in "
                    f"{Q8.plan_q(xq, w_q, g.dtype == torch.int8, stride)} "
                    f"{g.dtype}: {int((g != w).sum())} differ from plain")
        used[Q8.plan(x, w_q, stride, dtype)] += 1


def direct_odd_check(label, dev, ks):
    """The direct first-conv kernel at the DIRECT_ODD cases of kernel
    size in ``ks`` (H != W, tile edges), f32 and bf16, leaky and linear,
    both entries (int8 and float32 out for the int8-in one), against the
    plain twins: equal. Returns the (instance, BN) counter."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    used = collections.Counter()
    cases = [c for c in DIRECT_ODD if c[1] in ks]
    for (batch, k, stride, pad, cout, h, w) in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn((batch, 3, h, w), generator=gen, device=dev)
                 * 2).to(dtype).contiguous(memory_format=torch.channels_last)
            w_q = torch.randint(-127, 128, (cout, 3, k, k), generator=gen,
                                device=dev).to(torch.int8).contiguous(
                                    memory_format=torch.channels_last)
            s_w = (torch.rand(cout, generator=gen, device=dev) + 0.5) / 127
            b = torch.randn(cout, generator=gen, device=dev)
            int8_entries_check(
                f"{label} B={batch} {k}x{k} s{stride} p{pad} 3->{cout} at "
                f"{h}x{w} {dtype}", (x, w_q, 4.0 / 127, s_w, b), stride, used,
                pad=pad)
    require({plan[0] for plan in used} == {"direct"},
            f"{label}: the odd cases took {dict(used)}, not the direct "
            "kernel")
    print(f"[{label}] the direct kernel at {len(cases)} tile-edge cases "
          f"(B, k, stride, pad, Cout, H, W) {cases}, f32 and bf16, leaky and "
          f"linear, both entries: equal to the plain twins, 0 ulp; (instance,"
          f" BN) taken: {dict(used)}")
    return used


def direct_times(label, k, stride, cout, size, entry, dev, smi, parent):
    """Device ms of the direct first-conv kernel at batch SERVE_BATCH, one
    entry (0: conv2d_int8, bf16 in and out; 1: conv2d_int8_q, int8 in and
    out), in turns with ``parent``'s kernel (the library --parent built, or
    None) as parent, kernel, kernel, parent, beside its bound, its plain
    twin and
    (bf16 entry) cuDNN's bf16 conv of the same shape, which computes
    another function (context only). Returns the kernel's JSON fields."""
    from yolo_tensorflow_tpu_torch.ops.kernels import conv_int8 as Q8
    from yolo_tensorflow_tpu_torch.ops.kernels import direct_probe as DP
    require(DP.BATCH == SERVE_BATCH, f"direct_probe's batch {DP.BATCH}")
    ops = DP.case_operands(k, stride, cout, size, dev, SEED + 12 + k)
    kw = dict(stride=stride, act="leaky")
    def plain_fn():
        if entry == 0:
            return Q8.conv2d_int8_plain(
                ops["x"], ops["w_q"], ops["s_x"], ops["s_w"], ops["b"],
                epilogue_dtype=torch.bfloat16, **kw)
        return Q8.conv2d_int8_q_plain(
            ops["xq"], ops["s_in"], ops["w_q"], ops["s_w"], ops["b"],
            s_out=ops["s_out"], **kw)

    plan = (Q8.plan(ops["x"], ops["w_q"]) if entry == 0 else
            Q8.plan_q(ops["xq"], ops["w_q"]))
    require(plan[0] == "direct", f"{label}: {plan}, not the direct kernel")
    fn = DP.entry_calls(ops, k, stride)[entry]
    want = fn()
    plain_out = plain_fn()
    torch.cuda.synchronize()
    err = (want.float() - plain_out.float()).abs().max().item()
    require(torch.equal(want, plain_out), f"{label}: kernel != plain "
            f"({err})")
    turns = [("kernel", fn)]
    if parent is not None:
        parent_fn = DP.entry_calls(ops, k, stride, parent)[entry]
        got = parent_fn()
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"{label}: the parent's kernel "
                "differs from this one")
        turns = [("parent", parent_fn)] + turns * 2 + [("parent", parent_fn)]
    times = collections.defaultdict(list)
    for name, f in turns:
        times[name].append(cuda_ms(f, iters=20))
    ms = min(times["kernel"])
    plain = cuda_ms(plain_fn, iters=1, warmup=1)
    nbytes, ops_n = int8_cost(SERVE_BATCH, k, stride, 3, cout, size,
                              2 - entry, 2 - entry)
    bnd, by = bound_ms(nbytes, ops_n, INT8_OPS_S)
    parent = ("parent's kernel " + " / ".join(f"{v:.4f}"
                                              for v in times["parent"])
              + " ms" if "parent" in times else
              "parent's kernel not measured (no --parent)")
    other = ""
    if entry == 0:
        gen = torch.Generator(device=dev).manual_seed(SEED + 12)
        wf = torch.randn((cout, 3, k, k), generator=gen, device=dev,
                         dtype=torch.bfloat16).contiguous(
                             memory_format=torch.channels_last)
        cudnn = cuda_ms(lambda: F.conv2d(ops["x"], wf, stride=stride,
                                         padding=k // 2), iters=10)
        other = f"; cuDNN bf16 conv {cudnn:.4f} ms (context: not the same " \
                "function)"
    print(f"[{label}] the direct kernel at B={SERVE_BATCH} {k}x{k} s{stride} "
          f"3->{cout} at {size}^2, {DP.ENTRIES[entry]}: {plan}, kernel "
          + " / ".join(f"{v:.4f}" for v in times["kernel"])
          + f" ms ({ops_n / ms / 1e9:.1f} TOPS), bound {bnd:.4f} ms ({by}; "
          f"{nbytes / 1e6:.0f} MB, {ops_n / 1e9:.1f} G int8 ops), "
          f"{ms / bnd:.2f}x it; plain {plain:.3f} ms; {parent}{other}; on "
          f"{smi}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bnd,
            "bound_by": by, "library_ms": None}


def int8_k7_phase(dev, kind, smi, v1_path, parent):
    """Phase 23. The int8 kernel at yolov1's 7x7 stride-2 first conv, both
    entries, against their plain twins and timed; int8 yolov1-448 (all 24
    convs quantized, the connected head float) f32 against the CPU port,
    and bf16 serving beside float yolov1's. Returns the int8 params and the
    direct kernel's numbers at the first conv, both entries."""
    from yolo_tensorflow_tpu_torch import config as C
    from yolo_tensorflow_tpu_torch.io import weights as W
    from yolo_tensorflow_tpu_torch.models import engine
    from yolo_tensorflow_tpu_torch.ops import quant as Q
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
            int8_entries_check(f"23 int8 k7 B={batch} s{stride} 3->{cout} at {h}^2 "
                     f"{dtype}{' unaligned' if off else ''}",
                     k7_case(gen, dev, batch, stride, cout, h, off, dtype),
                     stride, used)
    print(f"[23 int8 k7] yolov1's first conv (7x7 s2, 3->64 at {size}^2) "
          f"at B={SERVE_BATCH} and {len(K7_ODD)} odd cases, f32 and bf16, "
          f"leaky and linear, both entries (int8 and float32 out for the "
          f"int8-in one): equal to the plain twins, 0 ulp; (instance, BN) "
          f"taken: {dict(used)}")

    direct_odd_check("23 int8 k7 direct", dev, (7,))
    k7_fields = [direct_times("23 int8 k7", 7, 2, 64, size, entry, dev, smi,
                              parent) for entry in (0, 1)]

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
        int8_direct=1, decode=0, nms=1))
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
                            int8_direct=1, decode=0, nms=1)
        del det
    print(f"[23 int8 yolov1 bf16] detect_batch B={SERVE_BATCH} at {size}: "
          + "; ".join(f"{k} {v[0]:.1f} img/s (spread {v[1]:.1f}..{v[2]:.1f},"
                      f" step {v[3]:.2f} ms)" for k, v in rates.items())
          + f"; on {smi}")
    return qparams, k7_fields


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


def operators_phase(cfg, path, qparams, dev, smi):
    """Phase 27, first part: what the yolo_torch operators cost. bf16 and
    int8 bf16 detect_batch at SERVE_BATCH (phases 5 and 7) and at
    SERVE_HTTP_BATCH, with the wrappers calling the operators (the port's
    path) and with them calling the operators' CUDA implementations
    directly (the former ctypes path, the same kernels), in turns: op,
    direct, direct, op."""
    from yolo_tensorflow_tpu_torch.ops.kernels import conv_int8 as Q8
    from yolo_tensorflow_tpu_torch.ops.kernels import decode as K
    from yolo_tensorflow_tpu_torch.ops.kernels import nms as NK
    from yolo_tensorflow_tpu_torch.pipeline import Detector
    ops = [(K, "decode_op", K._decode_cuda), (NK, "nms_op", NK._nms_cuda),
           (Q8, "conv_op", Q8._conv_cuda)]
    saved = [getattr(m, name) for m, name, _ in ops]

    def direct(on):
        for (m, name, fn), op in zip(ops, saved):
            setattr(m, name, fn if on else op)

    rng = np.random.default_rng(SEED + 27)
    x = torch.as_tensor(rng.integers(0, 256, (SERVE_BATCH, cfg.input_size,
                                              cfg.input_size, 3),
                                     dtype=np.uint8), device=dev)
    torch.backends.cudnn.benchmark = True
    for name, kw in (("bf16", dict(weights_path=path)),
                     ("int8 bf16", dict(params=qparams))):
        det = Detector(MODEL, device="cuda", compute_dtype=torch.bfloat16,
                       conf_threshold=CONF, **kw)
        for batch in (SERVE_BATCH, SERVE_HTTP_BATCH):
            xb = x[:batch]
            rates = {True: [], False: []}
            try:
                for on in (False, True, True, False):
                    direct(on)
                    rates[on] += serve_rate(lambda: det.detect_batch(xb),
                                            batch)[1]
            finally:
                direct(False)
            op, dr = (statistics.median(rates[k]) for k in (False, True))
            print(f"[27 operators] {name} detect_batch B={batch}: "
                  f"{op:.1f} img/s through the operators, {dr:.1f} img/s "
                  f"with the kernels called directly (median of 2 x 3 x 5 "
                  f"steps each, in turns; op/direct {op / dr:.3f}); "
                  f"on {smi}")
        del det


def run_cli(args):
    """Start ``python3 -m yolo_tensorflow_tpu_torch <args>`` from the
    repository's root; returns the Popen."""
    return subprocess.Popen(
        [sys.executable, "-m", "yolo_tensorflow_tpu_torch", *args],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def wait_cli(label, proc, timeout=600):
    out, _ = proc.communicate(timeout=timeout)
    require(proc.returncode == 0, f"{label}: the CLI exited "
            f"{proc.returncode}:\n{out[-4000:]}")
    return out


def export_phase(cfg, path, qparams, n_int8, dev, smi, tmp):
    """Phase 27: the CLI's convert, then its export of the bf16 fused
    letterbox Detector (batch SERVE_HTTP_BATCH, canvas EXPORT_CANVAS) and of
    the int8 bf16 Detector (batch SERVE_HTTP_BATCH, the input size), two
    processes at once; each artifact loaded with LoadedArtifact, its five
    outputs equal to the Detector's on the same inputs, its kernels
    launched once per call (the int8 conv n_int8 times), no host sync, and
    its call time beside the Detector's."""
    from yolo_tensorflow_tpu_torch.export import LoadedArtifact
    from yolo_tensorflow_tpu_torch.io.checkpoint import save_params_npz
    from yolo_tensorflow_tpu_torch.pipeline import Detector
    npz, qnpz = (os.path.join(tmp, f"{n}.npz") for n in ("float", "int8"))
    art, qart = (os.path.join(tmp, f"{n}.ytt") for n in ("float", "int8"))
    save_params_npz(qparams, qnpz)
    t0 = time.perf_counter()
    common = ["--model", MODEL, "--bf16", "--batch", str(SERVE_HTTP_BATCH),
              "--conf-threshold", str(CONF), "--device", "cuda"]
    qproc = run_cli(["export", "--weights", qnpz, "--out", qart, *common])
    wait_cli("27 convert", run_cli(["convert", "--model", MODEL,
                                    "--weights", path, "--out", npz]))
    fproc = run_cli(["export", "--weights", npz, "--out", art, "--letterbox",
                     "--fused-letterbox", "--canvas-size",
                     str(EXPORT_CANVAS), *common])
    outs = [wait_cli("27 export", p) for p in (fproc, qproc)]
    print(f"[27 export] CLI convert, then export of the fused bf16 and the "
          f"int8 bf16 yolov3-416 (two processes at once): "
          f"{time.perf_counter() - t0:.1f} s; "
          f"{[o.strip().splitlines()[-1] for o in outs]}; "
          f"{os.path.getsize(art) / 2**20:.1f} and "
          f"{os.path.getsize(qart) / 2**20:.1f} MiB")

    torch.backends.cudnn.benchmark = True
    rng = np.random.default_rng(SEED + 27)
    sizes = [tuple(int(v) for v in rng.integers(*HTTP_SIDES, 2))
             for _ in range(SERVE_HTTP_BATCH)]
    canvas, sz = fused_canvases(rng, EXPORT_CANVAS, sizes)
    canvas, sz = (torch.as_tensor(v, device=dev) for v in (canvas, sz))
    x = torch.as_tensor(rng.integers(0, 256, (SERVE_HTTP_BATCH,
                                              cfg.input_size,
                                              cfg.input_size, 3),
                                     dtype=np.uint8), device=dev)
    cases = (("fused bf16", art, Detector(
                  MODEL, path, device="cuda", compute_dtype=torch.bfloat16,
                  conf_threshold=CONF, letterbox=True, fused=True),
              (canvas, sz), dict(decode=1, nms=1, int8=0)),
             ("int8 bf16", qart, Detector(
                  MODEL, params=qparams, device="cuda",
                  compute_dtype=torch.bfloat16, conf_threshold=CONF),
              (x,), dict(decode=1, nms=1, int8=n_int8)))
    for name, file, det, inputs, want_counts in cases:
        t0 = time.perf_counter()
        loaded = LoadedArtifact(file)
        load_s = time.perf_counter() - t0
        require(loaded.manifest["framework"] == "yolo_tensorflow_tpu_torch"
                and loaded.device.type == dev.type,
                f"27 {name}: manifest {loaded.manifest}")
        run = ((lambda: det.detect_batch_fused(*inputs)) if det.fused
               else (lambda: det.detect_batch(*inputs)))
        run()
        loaded(*inputs)                          # warm-up, outside counts
        want = run()
        got = counted_forward(f"27 artifact {name}",
                              lambda: loaded(*inputs), **want_counts)
        for key, g, w in zip(loaded.manifest["outputs"], got.values(),
                             want):
            require(torch.equal(g, w), f"27 {name}: artifact {key} differs "
                    "from the Detector's")
        require(int(want.num.sum()) > 0, f"27 {name}: no detections")
        det_ms = wall_ms(run, 10)
        art_ms = wall_ms(lambda: loaded(*inputs), 10)
        print(f"[27 export {name}] {os.path.basename(file)} loaded in "
              f"{load_s:.2f} s; B={SERVE_HTTP_BATCH}: all five outputs "
              f"equal to the Detector's bit for bit ({int(want.num.sum())} "
              f"detections); one call launched {want_counts}; call "
              f"{art_ms:.2f} ms, the Detector's {det_ms:.2f} ms (host "
              f"time, 10 calls); on {smi}")
        del det, loaded


def result_rows(det, host, i):
    """Row i of numpy Detections as BatchingDetector's JSON gives it (no
    host downscale: every image here fits the largest canvas)."""
    return json.dumps([{
        "class_id": int(host.classes[i, j]),
        "class": det.cfg.classes[int(host.classes[i, j])],
        "score": float(host.scores[i, j]),
        "box": [float(v) for v in host.boxes[i, j]]}
        for j in range(int(host.num[i]))])


class _Recorder:
    """A fused Detector for phase 28's server: its device call waits while
    ``open`` is clear (to stall the batcher and fill the queue), and it
    keeps, per image size [h, w], every result the card computed for a
    row of that size, formatted as the server formats it, and per (h, w,
    canvas side) the rows served and the image. With ``pending`` set, the
    next call, after its own batch, computes ``references``: for each (h,
    w, side) served, row 0 of the Detector's forward of 8 copies of the
    image on a canvas of that side, in the serving thread (cuDNN keeps its
    algorithm choices per thread)."""

    fused = True

    def __init__(self, det):
        from yolo_tensorflow_tpu_torch.post import nms as NMS
        self.det, self.cfg, self._fetch = det, det.cfg, NMS.fetch_detections
        self.open = threading.Event()
        self.open.set()
        self.rows = collections.defaultdict(set)
        self.served = collections.defaultdict(set)
        self.images = {}
        self.pending, self.references = False, {}

    def detect_batch_fused(self, canvas, sizes):
        if not self.open.wait(120):
            raise RuntimeError("28: the gate never opened")
        dets = self.det.detect_batch_fused(canvas, sizes)
        host = self._fetch(dets)
        side = canvas.shape[1]
        for i, (h, w) in enumerate(np.asarray(sizes).tolist()):
            if (h, w) == (side, side):
                continue                     # a pad row
            row = result_rows(self.det, host, i)
            self.rows[(h, w)].add(row)
            self.served[(h, w, side)].add(row)
            self.images.setdefault((h, w), canvas[i, :h, :w].copy())
        if self.pending:
            self.pending = False
            self.references = copies_rows(self.det, self.images,
                                          self.served)
        return dets


def copies_rows(det, images, keys):
    """{(h, w, side): row 0 of det's fused forward of SPLIT_BATCH copies of
    images[(h, w)] on a canvas of that side, formatted as the server
    formats it}, after checking that the copies' rows are all the same."""
    from yolo_tensorflow_tpu_torch.post import nms as NMS
    out = {}
    for h, w, side in sorted(keys):
        canvas, sizes = _canvas([images[(h, w)]] * SPLIT_BATCH, side)
        host = NMS.fetch_detections(det.detect_batch_fused(canvas, sizes))
        rows = {result_rows(det, host, i) for i in range(SPLIT_BATCH)}
        if len(rows) != 1:
            raise RuntimeError(f"28: {SPLIT_BATCH} copies of image "
                               f"{(h, w)} gave {len(rows)} results")
        out[(h, w, side)] = rows.pop()
    return out


def http_post(url, body, timeout=120):
    """(status, JSON body, Retry-After) of one POST."""
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), None
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), e.headers.get(
            "Retry-After")


def http_get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def npy_body(img):
    import io
    buf = io.BytesIO()
    np.save(buf, img)
    return buf.getvalue()


def http_pool(seed):
    """HTTP_POOL seeded RGB images of distinct sizes in HTTP_SIDES, and
    their .npy request bodies."""
    rng = np.random.default_rng(seed)
    sizes = set()
    while len(sizes) < HTTP_POOL:
        sizes.add(tuple(int(v) for v in rng.integers(*HTTP_SIDES, 2)))
    pool = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for h, w in sorted(sizes)]
    return pool, [npy_body(im) for im in pool]


def start_server(det, **kw):
    from yolo_tensorflow_tpu_torch.cli import decode_npy
    from yolo_tensorflow_tpu_torch.server import serve_http
    ready = threading.Event()
    httpd, batcher = serve_http(
        det, host="127.0.0.1", port=0, batch_size=SERVE_HTTP_BATCH,
        queue_depth=HTTP_QUEUE, max_body_bytes=HTTP_BODY_CAP,
        model_name=MODEL, ready_event=ready, decode_fn=decode_npy, **kw)
    require(ready.wait(30), "28: the server did not come up")
    return httpd, batcher, f"http://127.0.0.1:{httpd.server_address[1]}"


def dict_rows(dets):
    """Detections as JSON dicts -> [(class, score, box)]."""
    return [(d["class_id"], d["score"], np.asarray(d["box"], np.float64))
            for d in dets]


def serve_run(label, det, tmp, smi):
    """One phase-28 load run: serve_http on 127.0.0.1 with ``det``,
    HTTP_CLIENTS threads posting the pool's images for HTTP_SECONDS (a
    torch.profiler trace of the window for the card's idle share); every
    200 response equal to a result the card computed for a row of that
    image's size (the server's slicing and formatting, bit for bit); then
    a burst past the queue with the batcher stalled (503 + Retry-After), a
    body past the cap (413), and /stats reconciled with the responses.
    Last, the gate: every row served equal bit for bit to the serving
    thread's forward of 8 copies of its image at the same canvas
    (``copies_rows``), which holds the result to the image and the batch
    shape alone, whatever else shared its batch. How far a response lies
    from ``Detector.detect`` of the image alone (B=1, the main thread) is
    measured and printed, and so is how many of the 8-copies references
    the main thread computes differently."""
    import http.client
    pool, bodies = http_pool(SEED + 28)
    alone = [dict_rows(det.detect(im)) for im in pool]
    cap = det._nms_kwargs.get("max_detections", det.cfg.max_detections)
    rec = _Recorder(det)
    httpd, batcher, base = start_server(rec)
    codes = collections.Counter()
    lock = threading.Lock()
    same_classes, failures = [0], []      # a client thread cannot exit
    seen = [0.0] * 5

    def check(i, status, out):
        with lock:
            codes[status] += 1
        if status != 200:
            return
        got = out["detections"]
        h, w = pool[i].shape[:2]
        with lock:
            if json.dumps(got) not in rec.rows[(h, w)]:
                failures.append(f"image {i}: {got}")
            same_classes[0] += [d["class_id"] for d in got] == [
                d[0] for d in alone[i]]
            gap = row_gap(dict_rows(got), alone[i], CONF, cap)
            seen[:] = [max(a, b) if k != 2 else a + b
                       for k, (a, b) in enumerate(zip(seen, gap))]

    try:
        for i, b in enumerate(bodies):      # warm-up, each image once
            check(i, *http_post(base + "/detect", b)[:2])
        lat, stop = [], [0.0]

        def client(t):
            k = 0
            while time.perf_counter() < stop[0]:
                i = (t * 5 + k) % HTTP_POOL
                t0 = time.perf_counter()
                status, out, _ = http_post(base + "/detect", bodies[i])
                dt = time.perf_counter() - t0
                check(i, status, out)
                if status == 200:
                    with lock:
                        lat.append(dt)
                else:
                    time.sleep(0.05)        # an honest client backs off
                k += 1

        threads = [threading.Thread(target=client, args=(t,), daemon=True)
                   for t in range(HTTP_CLIENTS)]
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        torch.cuda.synchronize()
        prof.start()
        t0 = time.perf_counter()
        stop[0] = t0 + HTTP_SECONDS
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.stop()
        require(not any(t.is_alive() for t in threads),
                f"{label}: a client hung")
        busy, n_spans = device_busy(prof, os.path.join(
            tmp, label.replace(" ", "_") + ".json"))
        n_load = len(lat)
        snap = http_get(base + "/stats")
        lat.sort()

        # the burst: the batcher stalled, HTTP_QUEUE + batch + 16 posts
        rec.open.clear()
        burst, retry = [], []

        def post(i):
            status, out, ra = http_post(base + "/detect", bodies[i])
            check(i, status, out)
            with lock:
                burst.append(status)
                if status == 503:
                    retry.append(ra)

        n_burst = HTTP_QUEUE + SERVE_HTTP_BATCH + 16
        threads = [threading.Thread(target=post, args=(j % HTTP_POOL,),
                                    daemon=True) for j in range(n_burst)]
        for t in threads:
            t.start()
        deadline = time.perf_counter() + 60
        while burst.count(503) < 16 and time.perf_counter() < deadline:
            time.sleep(0.05)
        shed_while_stalled = burst.count(503)
        rec.open.set()
        for t in threads:
            t.join(timeout=120)
        require(not any(t.is_alive() for t in threads),
                f"{label}: a burst request hung")
        require(shed_while_stalled >= 16 and burst.count(503) >= 16
                and all(r == "1" for r in retry),
                f"{label}: burst of {n_burst}: {collections.Counter(burst)}"
                f", Retry-After {set(retry)}")

        # a body past the cap: headers only, the server answers first
        conn = http.client.HTTPConnection("127.0.0.1",
                                          httpd.server_address[1],
                                          timeout=30)
        conn.putrequest("POST", "/detect")
        conn.putheader("Content-Length", str(HTTP_BODY_CAP + 1))
        conn.endheaders()
        big = conn.getresponse().status
        conn.close()
        require(big == 413, f"{label}: a body past the cap got {big}")
        st = http_get(base + "/stats")
        require(st["requests"] == st["images"] == codes[200]
                and st["errors"] == 0 and st["rejected"] == codes[503],
                f"{label}: /stats {st} against responses {dict(codes)}")
        require(not failures, f"{label}: {len(failures)} responses are no "
                f"row the card computed, first {failures[:1]}")
        rec.pending = True                  # the references, in its thread
        batcher.detect(pool[0])
        require(set(rec.references) == set(rec.served),
                f"{label}: references for {len(rec.references)} of "
                f"{len(rec.served)} (image, canvas) pairs")
        moved = [k for k, rows in rec.served.items()
                 if rows != {rec.references[k]}]
        require(not moved, f"{label}: {len(moved)} of {len(rec.served)} "
                f"(h, w, canvas) served rows that differ from 8 copies of "
                f"the image at that canvas, first {moved[:3]}")
        n_rows = sum(len(r) for r in rec.served.values())
        with torch.inference_mode():
            here = copies_rows(det, rec.images, rec.served)
        other_thread = sum(here[k] != rec.references[k] for k in here)
    finally:
        rec.open.set()
        httpd.shutdown()
        batcher.close()
    p = [lat[min(int(len(lat) * q), len(lat) - 1)] * 1e3 for q in (0.5,
                                                                    0.95)]
    print(f"[{label}] serve_http B={SERVE_HTTP_BATCH}, queue {HTTP_QUEUE}, "
          f"{HTTP_CLIENTS} clients x {HTTP_SECONDS:.0f} s of .npy posts "
          f"({HTTP_POOL} images, {HTTP_SIDES[0]}-{HTTP_SIDES[1]} px): "
          f"{n_load / wall:.1f} req/s ({n_load} in {wall:.2f} s), client "
          f"latency p50 {p[0]:.1f} ms p95 {p[1]:.1f} ms, server p50 "
          f"{snap.get('latency_ms_p50')} ms p95 "
          f"{snap.get('latency_ms_p95')} ms, mean batch occupancy "
          f"{snap['mean_batch_occupancy']}; card busy (union of {n_spans} "
          f"intervals) {busy:.3f} s of {wall:.3f} s, idle share "
          f"{1 - busy / wall:.3f}; every one of {codes[200]} 200 responses "
          f"a row the card computed for the image, bit for bit; the "
          f"{len(rec.served)} (image, canvas) pairs served ({n_rows} "
          f"distinct rows) each equal bit for bit to 8 copies of the image "
          f"at that canvas in the serving thread (the same references from"
          f" the main thread: {other_thread} of {len(here)} differ); "
          f"against Detector.detect of the image alone (B=1, measured, not"
          f" a gate): the largest |d score| {seen[0]:.4g}, |d box| "
          f"{seen[1]:.4g} of the pair's longest box side, {seen[2]:.0f} class "
          f"flips, unmatched {seen[3]:.4g} past the other list's end; "
          f"{same_classes[0]} with all of its classes; "
          f"burst of {n_burst} with the batcher stalled: "
          f"{dict(collections.Counter(burst))}, Retry-After 1; 413 past "
          f"{HTTP_BODY_CAP} bytes; /stats requests = images = "
          f"{st['requests']} = 200 responses, rejected {st['rejected']}; "
          f"on {smi}")


def serve_parity(label, det, smi):
    """Phase 28's correctness run, f32 (TF32 off): HTTP_POOL client
    threads each post every pool image once, in their own order, so that
    images share batches; every response has Detector.detect's classes for
    the image, boxes (pixels) within FUSED_TOL and scores within
    PARITY_TOL; /stats reconciles."""
    pool, bodies = http_pool(SEED + 28)
    want = [det.detect(im) for im in pool]
    require(sum(len(w) for w in want) > 0, f"{label}: no detections")
    httpd, batcher, base = start_server(det)
    got, lock = [], threading.Lock()

    def client(t):
        for k in range(HTTP_POOL):
            i = (t + 3 * k) % HTTP_POOL
            status, out, _ = http_post(base + "/detect", bodies[i])
            with lock:
                got.append((i, status, out))

    try:
        threads = [threading.Thread(target=client, args=(t,), daemon=True)
                   for t in range(HTTP_POOL)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        require(not any(t.is_alive() for t in threads),
                f"{label}: a client hung")
        st = http_get(base + "/stats")
    finally:
        httpd.shutdown()
        batcher.close()
    require(len(got) == HTTP_POOL ** 2 and all(s == 200 for _, s, _ in got)
            and st["requests"] == st["images"] == len(got),
            f"{label}: {collections.Counter(s for _, s, _ in got)}, /stats "
            f"{st}")
    err = 0.0
    for i, _, out in got:
        g, w = out["detections"], want[i]
        require([d["class_id"] for d in g] == [d["class_id"] for d in w],
                f"{label}: image {i}: classes {[d['class_id'] for d in g]}"
                f", Detector.detect {[d['class_id'] for d in w]}")
        if g:
            gb, wb = (np.asarray([d["box"] for d in r], np.float64)
                      for r in (g, w))
            np.testing.assert_allclose(gb, wb, **FUSED_TOL)
            np.testing.assert_allclose([d["score"] for d in g],
                                       [d["score"] for d in w], **PARITY_TOL)
            err = max(err, float(np.abs(gb - wb).max()))
    print(f"[{label}] serve_http B={SERVE_HTTP_BATCH} f32: {len(got)} "
          f"responses from {HTTP_POOL} clients, mean batch occupancy "
          f"{st['mean_batch_occupancy']}; each with Detector.detect's "
          f"classes for the image alone, max |err| of pixel boxes {err:.3g} "
          f"(tol {FUSED_TOL}); on {smi}")


def host_rows(host, i):
    """Row i of numpy Detections: [(class, score, box)]."""
    return [(int(host.classes[i, j]), float(host.scores[i, j]),
             np.asarray(host.boxes[i, j], np.float64))
            for j in range(int(host.num[i]))]


def _iou(a, b):
    iw = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    ih = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = iw * ih
    union = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
             - inter)
    return inter / union if union > 0 else 0.0


def match_rows(got, want):
    """Greedy class-agnostic matching of two detection lists by IoU >= 0.5,
    best scores first: (pairs [(g, w)], unmatched got, unmatched want)."""
    free = list(range(len(got)))
    pairs, lost = [], []
    for w in sorted(want, key=lambda d: -d[1]):
        best = max(free, key=lambda k: _iou(got[k][2], w[2]), default=None)
        if best is not None and _iou(got[best][2], w[2]) >= 0.5:
            pairs.append((got[best], w))
            free.remove(best)
        else:
            lost.append(w)
    return pairs, [got[k] for k in free], lost


def row_gap(got, want, conf, cap):
    """How far two detection lists of one image are apart: (max |score
    difference| of matched pairs, max |box difference| of matched pairs in
    units of the pair's longest box side, classes that differ in matched pairs,
    how far the score of a detection with no match lies above where the
    other list stops (the threshold, or its lowest score where it holds
    ``cap`` detections: max_detections cuts it), matched pairs)."""
    pairs, extra, lost = match_rows(got, want)
    ds = max((abs(g[1] - w[1]) for g, w in pairs), default=0.0)
    db = max((float(np.abs(g[2] - w[2]).max()
                    / max(g[2][2] - g[2][0], g[2][3] - g[2][1],
                          w[2][2] - w[2][0], w[2][3] - w[2][1], 1.0))
              for g, w in pairs), default=0.0)
    flips = sum(g[0] != w[0] for g, w in pairs)

    def floor(rows):
        return min(d[1] for d in rows) if len(rows) >= cap else conf

    unmatched = max([d[1] - floor(want) for d in extra]
                    + [d[1] - floor(got) for d in lost], default=0.0)
    return ds, db, flips, unmatched, len(pairs)


def _canvas(imgs, side, batch=None):
    batch = batch or len(imgs)
    canvas = np.zeros((batch, side, side, 3), np.uint8)
    sizes = np.full((batch, 2), side, np.int32)
    for i, im in enumerate(imgs):
        h, w = im.shape[:2]
        canvas[i, :h, :w] = im
        sizes[i] = (h, w)
    return canvas, sizes


def batch_split(label, det, pool, smi):
    """Phase 28's split of bf16's batch dependence (server_phase turns
    cuDNN's autotuner on, as it serves): each group of SPLIT_BATCH pool images as a
    batch against each image alone (B=1) at one canvas side, on identical
    inputs. Required equal bit for bit: the fused letterbox's output, the
    decode kernel's and the NMS kernel's (fed the batch's own heads and
    candidates), the network on SPLIT_BATCH copies of an image against its
    row of the batch, and the letterbox and the detections of the batch at
    a canvas 256 px wider. Measured and printed: the first layer whose
    B=1 output differs from the batch row, and the end-to-end B=1 gap."""
    from yolo_tensorflow_tpu_torch import pipeline as PL
    from yolo_tensorflow_tpu_torch.models import engine
    from yolo_tensorflow_tpu_torch.models import specs as S
    from yolo_tensorflow_tpu_torch.ops import preprocess as P
    from yolo_tensorflow_tpu_torch.ops.kernels import decode as K
    from yolo_tensorflow_tpu_torch.post import nms as NMS
    cfg, net, dev = det.cfg, det.network, det.device
    size = cfg.input_size
    rescale, offset = PL.normalization_fold(cfg)
    nms_kw = PL._nms_opts(cfg, None, CONF, None, None, 256)
    cap = nms_kw["max_detections"]

    def letterbox(canvas, sizes):
        return P.letterbox_device_batch(
            torch.as_tensor(canvas, device=dev),
            torch.as_tensor(sizes, device=dev), size,
            compute_dtype=det.letterbox_dtype, rescale=rescale,
            offset=offset)

    def heads_of(outs):
        return [(engine.head_view(outs[i]), sp)
                for i, sp in enumerate(net.specs)
                if isinstance(sp, S.Detect)]

    def final(canvas, sizes):
        return NMS.fetch_detections(det.detect_batch_fused(canvas, sizes))

    def same(a, b):
        return a.shape == b.shape and torch.equal(a, b)

    first, gaps, moved = [], [], []
    for k in range(0, len(pool), SPLIT_BATCH):
        imgs = pool[k:k + SPLIT_BATCH]
        side = PL.canvas_side(*(max(im.shape[:2]) for im in imgs), size)
        canvas, sizes = _canvas(imgs, side)
        with torch.inference_mode():
            x8 = letterbox(canvas, sizes)
            outs8 = net.layer_outputs(x8)
            dec8 = K.decode_fused(heads_of(outs8), cfg)
            nms8 = NMS.fetch_detections(NMS.batched_nms_scored(*dec8,
                                                               **nms_kw))
            for i in range(len(imgs)):
                at = f"pool[{k + i}] in a batch at canvas {side}"
                if not same(letterbox(canvas[i:i + 1], sizes[i:i + 1]),
                            x8[i:i + 1]):
                    moved.append(f"{at}: letterbox")
                outs1 = net.layer_outputs(x8[i:i + 1])
                diff = [j for j, (a, b) in enumerate(zip(outs8, outs1))
                        if not same(a[i:i + 1], b)]
                first.append(diff[0] if diff else -1)
                outsc = net.layer_outputs(
                    x8[i:i + 1].expand(len(imgs), -1, -1, -1).contiguous(
                        memory_format=torch.channels_last))
                if not same(outsc[-2][:1], outs8[-2][i:i + 1]):
                    moved.append(f"{at}: {len(imgs)} copies' head")
                dec1 = K.decode_fused([(f[i:i + 1], sp)
                                       for f, sp in heads_of(outs8)], cfg)
                if not all(same(a[i:i + 1], b) for a, b in zip(dec8, dec1)):
                    moved.append(f"{at}: decode")
                nms1 = NMS.fetch_detections(NMS.batched_nms_scored(
                    *[t[i:i + 1] for t in dec8], **nms_kw))
                if result_rows(det, nms1, 0) != result_rows(det, nms8, i):
                    moved.append(f"{at}: NMS")
            wide_canvas, wide_sizes = _canvas(imgs, side + 256)
            if not same(letterbox(wide_canvas, wide_sizes), x8):
                moved.append(f"pool[{k}:]: letterbox at canvas {side + 256}")
        b8 = final(canvas, sizes)
        wide = final(wide_canvas, wide_sizes)
        for i in range(len(imgs)):
            if result_rows(det, wide, i) != result_rows(det, b8, i):
                moved.append(f"pool[{k + i}]: detections at canvas "
                             f"{side + 256}")
            gaps.append(row_gap(host_rows(b8, i),
                                host_rows(final(canvas[i:i + 1],
                                                sizes[i:i + 1]), 0),
                                CONF, cap))
    require(not moved, f"{label}: B=1 against B={SPLIT_BATCH} differs in "
            f"{len(moved)} places, first {moved[:3]}")
    at = sorted(set(first) - {-1})
    print(f"[{label}] cudnn.benchmark=True, B={SPLIT_BATCH} vs each image "
          f"alone on identical inputs, {len(pool)} images: the fused "
          f"letterbox, the decode kernel, the NMS kernel, {SPLIT_BATCH} "
          f"copies of an image against its batch row, and the letterbox "
          f"and detections at a canvas 256 px wider all equal bit for bit; "
          f"the network at B=1: first layer that differs per image {first}"
          f" ({[net.specs[j] for j in at]}); end to end (B=1 vs "
          f"B={SPLIT_BATCH}, measured): {sum(g[4] for g in gaps)} matched "
          f"detections, max |d score| {max(g[0] for g in gaps):.4g}, max "
          f"|d box| {max(g[1] for g in gaps):.4g} of the pair's longest box"
          f" side, {sum(g[2] for g in gaps)} class flips, an unmatched one "
          f"up to {max(g[3] for g in gaps):.3g} past where the other list "
          f"stops (max_detections {cap}); on {smi}")


def int8_geometry_phase(dev, kind, smi):
    """Phase 23 (geometry): the int8 kernel at geometries outside darknet's
    k // 2 padding and yolov3's sizes (5x5, 3x3 with padding 0, 3x3 stride
    3, and GEOM_ODD), both entries against their plain twins; then a cfg
    whose int8 convs include the first three, quantized on the card: one
    counted forward of the int8 Detector launches the kernel for every one
    of its 5 int8 convs, and its detections equal the CPU port's. Each of
    the net's convs is timed at the forward's shapes beside its plain twin
    and a cuDNN bf16 conv of the same shape."""
    import dataclasses
    import torch.nn.functional as F
    from yolo_tensorflow_tpu_torch import config as C
    from yolo_tensorflow_tpu_torch.io import weights as W
    from yolo_tensorflow_tpu_torch.models import engine
    from yolo_tensorflow_tpu_torch.models import specs as S
    from yolo_tensorflow_tpu_torch.ops import quant as Q
    from yolo_tensorflow_tpu_torch.ops.kernels import conv_int8 as Q8
    from yolo_tensorflow_tpu_torch.pipeline import Detector
    from yolo_tensorflow_tpu_torch.post import nms as NMS
    cfg = dataclasses.replace(C.get_config(MODEL), name="int8-geometry")
    per_scale = 3 * (5 + cfg.num_classes)
    specs = (S.Conv(32, 3), S.Conv(64, 5), S.Conv(64, 3, pad=0),
             S.Conv(128, 3, stride=3), S.Conv(128, 1),
             S.Conv(per_scale, 1, bn=False, act="linear"),
             S.Detect((6, 7, 8)))
    convs, h, cin = [], cfg.input_size, 3
    for sp in specs[:5]:
        pad = sp.size // 2 if sp.pad < 0 else sp.pad
        convs.append((sp.size, sp.stride, pad, cin, sp.filters, h,
                      PARITY_BATCH))
        h, cin = (h + 2 * pad - sp.size) // sp.stride + 1, sp.filters
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    used = collections.Counter()
    for case in convs + list(GEOM_ODD):
        k, stride, pad, cin, cout, h, batch = case
        for dtype in (torch.float32, torch.bfloat16):
            int8_entries_check(
                f"23 int8 geometry {k}x{k} s{stride} p{pad} {cin}->{cout} "
                f"at {h}^2 B={batch} {dtype}",
                int8_operands(gen, dev, batch, k, cin, cout, h, dtype),
                stride, used, pad=pad)
    print(f"[23 int8 geometry] {len(convs)} convs of the geometry net and "
          f"{len(GEOM_ODD)} odd cases (k, stride, pad, Cin, Cout, side, B) "
          f"{[c for c in convs + list(GEOM_ODD)]}, f32 and bf16, leaky and "
          f"linear, both entries: equal to the plain twins, 0 ulp; "
          f"(instance, BN) taken: {dict(used)}")

    times = []
    for k, stride, pad, cin, cout, h, batch in convs:
        x, w_q, s_x, s_w, b = int8_operands(gen, dev, batch, k, cin, cout, h,
                                            torch.bfloat16)
        kw = dict(stride=stride, pad=pad, act="leaky",
                  epilogue_dtype=torch.bfloat16)
        ms = cuda_ms(lambda: Q8.conv2d_int8(x, w_q, s_x, s_w, b, **kw),
                     iters=10)
        plain = cuda_ms(lambda: Q8.conv2d_int8_plain(x, w_q, s_x, s_w, b,
                                                     **kw), iters=2, warmup=1)
        wf = torch.randn((cout, cin, k, k), generator=gen, device=dev,
                         dtype=torch.bfloat16).contiguous(
                             memory_format=torch.channels_last)
        cudnn = cuda_ms(lambda: F.conv2d(x, wf, stride=stride, padding=pad),
                        iters=10)
        bnd, by = bound_ms(*int8_cost(batch, k, stride, cin, cout, h, 2, 2,
                                      pad=pad), INT8_OPS_S)
        times.append(f"{k}x{k} s{stride} p{pad} {cin}->{cout} at {h}^2 "
                     f"{Q8.plan(x, w_q)}: kernel {ms:.4f} ms, bound "
                     f"{bnd:.4f} ({by}), plain {plain:.3f}, cuDNN bf16 "
                     f"{cudnn:.4f}")
    print(f"[23 int8 geometry] B={PARITY_BATCH} bf16 in and out, leaky: "
          + "; ".join(times) + f"; on {smi}")

    params, stats = engine.init_params(specs, cfg.input_size, SEED + 23)
    folded = W.fold_params(params, stats, cfg.bn_eps)
    rng = np.random.default_rng(SEED + 23)
    imgs = rng.integers(0, 256, (PARITY_BATCH, cfg.input_size,
                                 cfg.input_size, 3), dtype=np.uint8)
    scales = Q.calibrate_activations(specs, folded, [imgs], cfg=cfg,
                                     device=dev)
    qparams = Q.quantize_params(specs, folded, scales)
    n_int8 = sum("w_q" in qparams.get(engine.layer_key(i), {})
                 for i in range(len(specs)))
    require(n_int8 == len(convs), f"{n_int8} int8 convs, expected "
            f"{len(convs)}")
    gpu = Detector(cfg, params=qparams, specs=specs, device="cuda",
                   conf_threshold=GEOM_CONF)
    x = torch.as_tensor(imgs, device=dev)
    gpu.detect_batch(x)                          # warm-up
    got = counted_forward("23 int8 geometry", lambda: gpu.detect_batch(x),
                          int8=n_int8, decode=1, nms=1)
    cpu = Detector(cfg, params=qparams, specs=specs, device="cpu",
                   conf_threshold=GEOM_CONF)
    check_detections("23 int8 geometry", gpu, imgs,
                     NMS.fetch_detections(got),
                     NMS.fetch_detections(cpu.detect_batch(imgs)), cfg,
                     kind, conf=GEOM_CONF)
    print(f"[23 int8 geometry] the net's {n_int8} int8 convs (k, stride, "
          f"pad) {[c[:3] for c in convs]} each launch the kernel once a "
          f"forward; detections equal to the CPU port's; on {smi}")


def _cli(label, argv):
    """cli.main(argv) in this process, its standard output captured and
    echoed line by line under ``label``. Returns (output, seconds)."""
    import contextlib
    import io
    from yolo_tensorflow_tpu_torch import cli
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    text = out.getvalue()
    for line in text.splitlines()[-CLI_ECHO:]:
        print(f"[{label}] {line}")
    return text, dt


def cli_phase(dev, kind, smi, tmp, v3_path):
    """Phase 30: the command line, driven in this process through
    ``cli.main`` so that the kernels' launch counts are visible, at full
    width. yolov2-416 from a written .cfg and seeded .weights: ``train
    --npy-images --bf16 --bn-onepass`` (B=CLI_BATCH, CLI_STEPS steps,
    --eval-every and --save-every at the last step) twice and once with
    --remat-every CLI_REMAT: conv_bnstat launched 15 a step without remat,
    the losses of every step equal or within the spread of the two runs
    without remat, the peak GiB of each; ``export-darknet --ckpt`` of the
    checkpoint and ``eval --npy-images`` of it over CLI_SCENES scenes, its
    JSON equal to an in-process evaluate_samples, decode and NMS launched
    once a batch; ``classify`` darknet19-256 over .npy images against the
    in-process Classifier; summary, ops, speed, inspect; the weight tools
    on yolov3 (partial, export-darknet, denormalize) and the Detector on
    the denormalized pair against the CPU port."""
    import contextlib
    import io
    from yolo_tensorflow_tpu_torch import config as C
    from yolo_tensorflow_tpu_torch.eval.batched import evaluate_samples
    from yolo_tensorflow_tpu_torch.eval.map import evaluate_detections
    from yolo_tensorflow_tpu_torch.data.datasets import load_darknet_list
    from yolo_tensorflow_tpu_torch.io import cfg as CF
    from yolo_tensorflow_tpu_torch.io import weights as W
    from yolo_tensorflow_tpu_torch.models import engine
    from yolo_tensorflow_tpu_torch.ops.kernels import conv_bnstat as BS
    from yolo_tensorflow_tpu_torch.ops.kernels import decode as K
    from yolo_tensorflow_tpu_torch.ops.kernels import nms as NK
    from yolo_tensorflow_tpu_torch.pipeline import Classifier, Detector
    from yolo_tensorflow_tpu_torch.post import nms as NMS
    from yolo_tensorflow_tpu_torch.train import loop as TL
    t_phase = time.perf_counter()
    root = os.path.join(tmp, "cli")
    for sub in ("images", "labels"):
        os.makedirs(os.path.join(root, sub))
    cfg = C.get_config("yolov2")
    specs = C.build_specs(cfg)
    n_fused = sum(bnstat_shapes(specs, cfg).values())
    cfg_path = os.path.join(root, "yolov2.cfg")
    with open(cfg_path, "w") as f:
        f.write(CF.specs_to_cfg(cfg, specs, batch=CLI_BATCH))
    w_path = os.path.join(root, "yolov2.weights")
    params, stats = engine.init_params(specs, cfg.input_size, SEED + 30,
                                       size_bias=REGION["yolov2"][0])
    W.save_darknet_weights(specs, cfg.input_size, params, stats, w_path)
    del params, stats
    imgs, labels = scenes(CLI_SCENES, SEED + 30, cfg.input_size,
                          cfg.input_size)
    paths = []
    for i, (img, lab) in enumerate(zip(imgs, labels)):
        p = os.path.join(root, "images", f"scene{i:03d}.npy")
        np.save(p, img)
        with open(os.path.join(root, "labels", f"scene{i:03d}.txt"),
                  "w") as f:
            f.write(lab)
        paths.append(p)
    lst = os.path.join(root, "list.txt")
    with open(lst, "w") as f:
        f.write("\n".join(paths) + "\n")

    # train: twice without remat, once with, the costs of every step
    costs = []
    real_step = TL.make_train_step

    def recording_step(*a, **k):
        inner = real_step(*a, **k)

        def step(state, images, truths):
            state, metrics = inner(state, images, truths)
            costs[-1].append(metrics["cost"].detach().float())
            return state, metrics
        return step

    def train(tag, extra):
        costs.append([])
        ckpt = os.path.join(root, f"ckpt-{tag}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        BS.launches = 0
        text, dt = _cli(f"30 cli train {tag}", [
            "train", "--cfg", cfg_path, "--weights", w_path, "--list", lst,
            "--val-list", lst, "--npy-images", "--bf16", "--bn-onepass",
            "--batch-size", str(CLI_BATCH), "--steps", str(CLI_STEPS),
            "--eval-every", str(CLI_STEPS), "--save-every", str(CLI_STEPS),
            "--log-every", str(CLI_STEPS // 2), "--ckpt-dir", ckpt,
            "--device", dev.type, *extra])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        require(len(costs[-1]) == CLI_STEPS and "done" in text
                and "val mAP@0.5" in text
                and os.path.exists(os.path.join(ckpt, "latest.json")),
                f"train {tag}: {len(costs[-1])} steps, output {text[-300:]}")
        return ckpt, BS.launches, peak, dt

    TL.make_train_step = recording_step
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    try:
        ckpt, launches, peak, dt = train("a", [])
        _, launches_b, _, _ = train("b", [])
        _, launches_r, peak_r, dt_r = train("remat", ["--remat-every",
                                                      str(CLI_REMAT)])
    finally:
        TL.make_train_step = real_step
        torch.backends.cudnn.deterministic = False
    require(launches == launches_b == n_fused * CLI_STEPS == 15 * CLI_STEPS,
            f"train: conv_bnstat launched {launches} and {launches_b} "
            f"times in {CLI_STEPS} steps, expected 15 a step")
    a, b, r = (torch.stack(c).cpu().numpy() for c in costs)
    spread = float(np.abs(a - b).max())
    remat_gap = float(np.abs(r - a).max())
    # a third run may lie up to twice their distance from one of two
    require(remat_gap <= 2 * spread, f"train --remat-every {CLI_REMAT}: "
            f"costs {remat_gap:.3g} from the run without remat, beyond "
            f"twice the spread of two runs without it {spread:.3g}")
    print(f"[30 cli train] yolov2-{cfg.input_size} bf16 onepass "
          f"B={CLI_BATCH}, {CLI_STEPS} steps from .npy scenes with "
          f"--eval-every and --save-every {CLI_STEPS}: {dt:.1f} s, "
          f"conv_bnstat launched {launches} times ({n_fused} a step), peak "
          f"{peak:.2f} GiB; --remat-every {CLI_REMAT}: {dt_r:.1f} s, "
          f"{launches_r} launches (the recompute's too), peak "
          f"{peak_r:.2f} GiB; costs of every step: remat vs without "
          f"max |d| {remat_gap:.3g}, two runs without remat max |d| "
          f"{spread:.3g} (bit for bit: {remat_gap == 0 and spread == 0}); "
          f"cost at step 1 {a[0]:.4f}, at step {CLI_STEPS} {a[-1]:.4f}; "
          f"on {smi}")

    # export-darknet of the checkpoint, then eval of it
    exp = os.path.join(root, "trained")
    _cli("30 cli export-darknet", ["export-darknet", "--cfg", cfg_path,
                                   "--ckpt", ckpt, "--out", exp])
    conf = REGION["yolov2"][1]
    reset_counts()
    text, dt = _cli("30 cli eval", [
        "eval", "--cfg", exp + ".cfg", "--weights", exp + ".weights",
        "--list", lst, "--npy-images", "--conf-threshold", str(conf),
        "--batch-size", str(CLI_EVAL_BATCH), "--device", dev.type])
    n_batches = -(-CLI_SCENES // CLI_EVAL_BATCH)
    got = json.loads(text[text.index("{"):])
    dec_launches, nms_launches = K.launches, NK.launches
    require(dec_launches == nms_launches == n_batches,
            f"eval: decode {dec_launches} and NMS {nms_launches} launches "
            f"for {n_batches} batches")
    ecfg, especs = C.config_from_cfg(exp + ".cfg")
    det = Detector(ecfg, exp + ".weights", specs=especs, device="cuda",
                   conf_threshold=conf)
    dets, gts, _, _ = evaluate_samples(det, load_darknet_list(lst),
                                       batch_size=CLI_EVAL_BATCH,
                                       read_fn=np.load)
    want = json.loads(json.dumps(evaluate_detections(
        dets, gts, ecfg.num_classes), default=float))
    require(got == want, f"eval JSON {got} != in-process {want}")
    print(f"[30 cli eval] {CLI_SCENES} scenes of the trained checkpoint "
          f"(export-darknet --ckpt) in {dt:.1f} s: mAP {got['map']:.4g} "
          f"over {got['num_classes_evaluated']} classes, JSON equal to "
          f"evaluate_samples in this process; decode and NMS launched "
          f"{dec_launches} and {nms_launches} times ({n_batches} batches)")
    del det

    # classify darknet19-256 over .npy images
    dcfg = C.get_config("darknet19-classifier")
    dspecs = C.build_specs(dcfg)
    d_path = os.path.join(root, "darknet19.weights")
    params, stats = engine.init_params(dspecs, dcfg.input_size, SEED + 31)
    W.save_darknet_weights(dspecs, dcfg.input_size, params, stats, d_path)
    del params, stats
    cls_imgs = np.random.default_rng(SEED + 31).integers(
        0, 256, (CLI_CLASSIFY, dcfg.input_size, dcfg.input_size, 3),
        dtype=np.uint8)
    cls_paths = []
    for i, img in enumerate(cls_imgs):
        p = os.path.join(root, f"cls{i}.npy")
        np.save(p, img)
        cls_paths.append(p)
    text, dt = _cli("30 cli classify", [
        "classify", "--model", "darknet19-classifier", "--weights", d_path,
        "--npy-images", "--top-k", "3", "--device", dev.type, *cls_paths])
    clf = Classifier("darknet19-classifier", d_path, device="cuda")
    want = []
    for p, img in zip(cls_paths, cls_imgs):
        want.append(p)
        want += [f"  {r['prob']*100:5.2f}%  {r['class']}"
                 for r in clf.classify(img, top_k=3)]
    require(text.splitlines() == want, "classify's top-3 lines differ from "
            "the in-process Classifier's")
    print(f"[30 cli classify] darknet19-{dcfg.input_size}, {CLI_CLASSIFY} "
          f".npy images in {dt:.2f} s: top-3 lines equal to the in-process "
          f"Classifier's")
    del clf

    # summary, ops, speed, inspect
    text, _ = _cli("30 cli summary", ["summary", "--cfg", cfg_path])
    require("total params" in text, "summary printed no total")
    text, _ = _cli("30 cli ops", ["ops", "--model", "yolov2"])
    require("Floating Point Operations" in text, "ops printed no count")
    reset_counts()
    text, dt = _cli("30 cli speed", ["speed", "--model", "yolov3",
                                     "--weights", v3_path, "--tics",
                                     str(CLI_TICS), "--device", dev.type])
    hz = float(text.strip().splitlines()[-1].split()[1])
    text, _ = _cli("30 cli inspect", ["inspect", exp + ".weights",
                                      "--model", "yolov2"])
    require(text.strip().endswith("floats"), "inspect printed no total")
    print(f"[30 cli tools] summary, ops, inspect ran; speed "
          f"{MODEL}-{C.get_config(MODEL).input_size} batch 1, {CLI_TICS} "
          f"forwards each with a blocking wait: {hz:.2f} Hz; on {smi}")

    # weight tools on yolov3, and the Detector on the denormalized pair
    v3 = os.path.join(root, "yolov3")
    _cli("30 cli partial", ["partial", "--model", "yolov3", "--weights",
                            v3_path, "--out", v3 + ".conv.75", "--upto",
                            "75"])
    _cli("30 cli export-darknet", ["export-darknet", "--model", "yolov3",
                                   "--weights", v3_path, "--out", v3])
    with open(v3_path, "rb") as f, open(v3 + ".weights", "rb") as g:
        require(f.read() == g.read(), "export-darknet of yolov3 is not the "
                "input file byte for byte")
    v3cfg = C.get_config(MODEL)
    part, _, _ = W.load_darknet_weights(
        C.build_specs(v3cfg), v3cfg.input_size, v3 + ".conv.75",
        fold=False, allow_partial=True)
    require(len(part) == 52, f"partial --upto 75 holds {len(part)} weighted "
            "layers, expected yolov3's 52 backbone convs")
    _cli("30 cli denormalize", ["denormalize", "--model", "yolov3",
                                "--weights", v3_path, "--out",
                                v3 + "-denorm.weights"])
    ncfg, nspecs = C.config_from_cfg(v3 + "-denorm.cfg")
    rng = np.random.default_rng(SEED + 30)
    d_imgs = rng.integers(0, 256, (PARITY_BATCH, ncfg.input_size,
                                   ncfg.input_size, 3), dtype=np.uint8)
    outs = {}
    for name, dv in (("denormalized", "cuda"), ("denormalized cpu", "cpu")):
        d = Detector(ncfg, v3 + "-denorm.weights", specs=nspecs, device=dv,
                     conf_threshold=CONF)
        outs[name] = NMS.fetch_detections(d.detect_batch(d_imgs))
        del d
    orig = Detector(MODEL, v3_path, device="cuda", conf_threshold=CONF)
    outs["original"] = NMS.fetch_detections(orig.detect_batch(d_imgs))
    del orig
    got, cpu, org = (outs[k] for k in ("denormalized", "denormalized cpu",
                                       "original"))
    for name in ("num", "classes"):
        require(np.array_equal(getattr(got, name), getattr(cpu, name))
                and np.array_equal(getattr(got, name), getattr(org, name)),
                f"denormalized pair: {name} differs")
    for name in ("boxes", "scores"):
        np.testing.assert_allclose(getattr(got, name), getattr(cpu, name),
                                   **PARITY_TOL)
    drift = max(float(np.abs(getattr(got, n) - getattr(org, n)).max())
                for n in ("boxes", "scores"))
    require(drift <= DENORM_DRIFT, f"denormalized pair {drift:.3g} from "
            f"the BN form, beyond {DENORM_DRIFT}")
    wall = time.perf_counter() - t_phase
    print(f"[30 cli weight tools] yolov3: partial --upto 75 (52 convs), "
          f"export-darknet (the input file byte for byte), denormalize: "
          f"the Detector on the pair, card against the CPU port within "
          f"{PARITY_TOL}, classes equal to the BN form's and max |d| "
          f"{drift:.3g} from it (darknet's denormalize eps, sqrt(var + "
          f"1e-5)); phase 30 in {wall:.1f} s")


def server_phase(path, qparams, tmp, smi):
    """Phase 28: the HTTP server over the f32 fused Detector (correctness
    against Detector.detect), then load runs over the bf16 fused Detector
    and the int8 bf16 one, each after the split of its batch dependence
    (``batch_split``); each served row held bit for bit to 8 copies of its
    image at its canvas (``serve_run``)."""
    from yolo_tensorflow_tpu_torch.pipeline import Detector
    torch.backends.cudnn.benchmark = False
    det = Detector(MODEL, path, device="cuda", conf_threshold=CONF,
                   letterbox=True, fused=True)
    serve_parity("28 server f32", det, smi)
    del det
    torch.backends.cudnn.benchmark = True
    pool, _ = http_pool(SEED + 28)
    for name, kw in (("bf16", dict(weights_path=path)),
                     ("int8 bf16", dict(params=qparams))):
        det = Detector(MODEL, device="cuda", compute_dtype=torch.bfloat16,
                       conf_threshold=CONF, letterbox=True, fused=True,
                       **kw)
        batch_split(f"28 split {name}", det, pool, smi)
        serve_run(f"28 server {name}", det, tmp, smi)
        del det


def stream_phase(cfg, path, tmp, smi):
    """Phase 29: stream_detect over a directory of STREAM_FRAMES .npy
    frames at the input size (read_fn = np.load) at batch
    SERVE_HTTP_BATCH, f32: plain, each batch equal to detect_batch of the
    same frames; smoothed (avg_frames = SMOOTH_AVG), against
    detect_batch_smoothed frame by frame with the state carried."""
    from yolo_tensorflow_tpu_torch.pipeline import Detector
    from yolo_tensorflow_tpu_torch.post import nms as NMS
    from yolo_tensorflow_tpu_torch.serving import stream_detect
    rng = np.random.default_rng(SEED + 29)
    S = cfg.input_size
    frames = rng.integers(0, 256, (STREAM_FRAMES, S, S, 3), dtype=np.uint8)
    root = os.path.join(tmp, "frames")
    os.makedirs(root)
    for i, f in enumerate(frames):
        np.save(os.path.join(root, f"{i:04d}.npy"), f)
    torch.backends.cudnn.benchmark = False
    det = Detector(MODEL, path, device="cuda", conf_threshold=CONF)
    for avg in (0, SMOOTH_AVG):
        got = []
        stream_detect(det, root, batch_size=SERVE_HTTP_BATCH, read_fn=np.load,
                      avg_frames=avg,
                      on_batch=lambda d, im: got.append((d, im.copy())))
        n, dt, fps = stream_detect(det, root, batch_size=SERVE_HTTP_BATCH,
                                   read_fn=np.load, avg_frames=avg)
        require(n == STREAM_FRAMES and len(got) == STREAM_FRAMES
                // SERVE_HTTP_BATCH, f"29 stream: {n} frames, {len(got)} "
                "batches")
        seen = np.concatenate([im for _, im in got])
        require(np.array_equal(seen, frames), "29 stream: frames out of "
                "order or altered")
        state, err, nums = None, 0.0, 0
        for b, (d, _) in enumerate(got):
            for j in range(SERVE_HTTP_BATCH):
                i = b * SERVE_HTTP_BATCH + j
                if avg:
                    w, state = det.detect_batch_smoothed(
                        frames[i:i + 1], state, avg_frames=avg)
                    w = NMS.fetch_detections(w)
                    row = 0
                else:
                    if j == 0:
                        w = NMS.fetch_detections(det.detect_batch(
                            frames[i:i + SERVE_HTTP_BATCH]))
                    row = j
                for name in ("num", "classes", "valid"):
                    require(np.array_equal(getattr(d, name)[j],
                                           getattr(w, name)[row]),
                            f"29 stream avg={avg}: frame {i} {name}")
                for name in ("boxes", "scores"):
                    g, ww = getattr(d, name)[j], getattr(w, name)[row]
                    if avg:
                        np.testing.assert_allclose(g, ww, **PARITY_TOL)
                    else:
                        require(np.array_equal(g, ww), f"29 stream: frame "
                                f"{i} {name} differ from detect_batch")
                    err = max(err, float(np.abs(g - ww).max()))
                nums += int(d.num[j])
        require(nums > 0, "29 stream: no detections")
        mode = (f"smoothed (avg_frames={avg}), against "
                "detect_batch_smoothed frame by frame" if avg else
                "plain, against detect_batch of the same frames")
        print(f"[29 stream f32] stream_detect of {n} .npy frames of {S}^2 "
              f"through read_fn at B={SERVE_HTTP_BATCH}, {mode}: classes "
              f"equal, max |err| {err:.3g} ({nums} detections); "
              f"{fps:.1f} frames/s ({dt:.2f} s, reading included); on {smi}")
    del det


def yolov1_full_phase(dev, kind, smi, tmp):
    """Phase 31: darknet's full YOLOv1 (YOLOV1_CFG) through config_from_cfg
    and Detector(cfg, specs=), from a seeded .weights file: f32 batch
    PARITY_BATCH on the card against the CPU port (NMS launched once);
    bf16 batch SERVE_BATCH img/s with the network's split into backbone,
    the local layer and the connected layer, decode and NMS, one counted
    forward with no host sync; then EXOTIC_CFG, every other new section,
    f32 on the card against the CPU port, folded and with unfolded BN."""
    from yolo_tensorflow_tpu_torch import config as C
    from yolo_tensorflow_tpu_torch.io import weights as W
    from yolo_tensorflow_tpu_torch.io.cfg import parse_cfg
    from yolo_tensorflow_tpu_torch.models import engine
    from yolo_tensorflow_tpu_torch.models import specs as S
    from yolo_tensorflow_tpu_torch.ops.kernels import nms as NK
    from yolo_tensorflow_tpu_torch.pipeline import Detector
    from yolo_tensorflow_tpu_torch.post import nms as NMS
    label = "31 yolov1-darknet"
    cfg_path = os.path.join(tmp, "yolov1.cfg")
    with open(cfg_path, "w") as f:
        f.write(YOLOV1_CFG)
    cfg, specs = C.config_from_cfg(cfg_path, name="yolov1-darknet")
    size, conf = cfg.input_size, V1_FULL_CONF
    i_local = next(i for i, sp in enumerate(specs)
                   if isinstance(sp, S.Local))
    i_dense = next(i for i, sp in enumerate(specs)
                   if isinstance(sp, S.Dense))
    path = os.path.join(tmp, "yolov1-darknet.weights")
    params, stats = engine.init_params(specs, size, SEED + 31)
    W.save_darknet_weights(specs, size, params, stats, path)
    n_local = params[engine.layer_key(i_local)]["w"].size
    del params, stats
    rng = np.random.default_rng(SEED + 31)
    imgs = rng.integers(0, 256, (PARITY_BATCH, size, size, 3),
                        dtype=np.uint8)
    torch.backends.cudnn.benchmark = False
    gpu = Detector(cfg, path, specs=specs, device="cuda",
                   conf_threshold=conf)
    gpu.detect_batch(imgs)                 # warm-up, outside the count
    torch.cuda.synchronize()
    NK.launches = 0
    got = gpu.detect_batch(imgs)           # f32, TF32 off in the network
    torch.cuda.synchronize()
    require(NK.launches == 1, f"{label}: NMS launched {NK.launches} times "
            "in one forward, expected 1")
    cpu = Detector(cfg, path, specs=specs, device="cpu", conf_threshold=conf)
    t0 = time.perf_counter()
    want = NMS.fetch_detections(cpu.detect_batch(imgs))
    cpu_s = time.perf_counter() - t0
    check_detections(f"{label} f32", gpu, imgs, NMS.fetch_detections(got),
                     want, cfg, kind, conf)
    print(f"[{label} f32] {len(specs)} specs from darknet's yolov1.cfg "
          f"(24 BN convs, [local] 3x3 256 with {n_local / 1e6:.1f} M "
          f"weights, [connected] 1715, [detection] side 7 num 3), a "
          f"{os.path.getsize(path) / 2 ** 20:.0f} MiB seeded .weights file;"
          f" NMS launches 1; the CPU port took {cpu_s:.1f} s")
    del gpu, cpu

    torch.backends.cudnn.benchmark = True
    det = Detector(cfg, path, specs=specs, device="cuda",
                   compute_dtype=torch.bfloat16, conf_threshold=conf)
    x = torch.as_tensor(rng.integers(0, 256, (SERVE_BATCH, size, size, 3),
                                     dtype=np.uint8), device=dev)
    torch.cuda.reset_peak_memory_stats()
    step_ms, rates, out = serve_rate(lambda: det.detect_batch(x), len(x))
    out = NMS.fetch_detections(out)
    require(np.isfinite(out.boxes).all() and np.all(out.num > 0),
            f"{label} bf16 detections empty or not finite")
    counted_forward(f"{label} bf16", lambda: det.detect_batch(x), decode=0,
                    nms=1)
    net_ms, dec_ms, nms_ms, _ = step_split(det, x, cfg, conf)
    with torch.inference_mode():
        from yolo_tensorflow_tpu_torch.pipeline import normalize_images
        outs = det.network.layer_outputs(normalize_images(
            x, cfg, det.network.dtype))
        local = det.network.layers[engine.layer_key(i_local)]
        dense = det.network.dense[engine.layer_key(i_dense)]
        local_in, dense_in = outs[i_local - 1], outs[i_dense - 1]
        del outs
        local_ms = cuda_ms(lambda: local(local_in), iters=10)
        dense_ms = cuda_ms(lambda: dense(dense_in), iters=10)
    step = statistics.median(step_ms)
    print(f"[{label} bf16] detect_batch B={SERVE_BATCH} at {size}, images "
          f"on the card: {statistics.median(rates):.1f} img/s median of 3 x "
          f"5 steps (spread {min(rates):.1f}..{max(rates):.1f}), step "
          f"{step:.2f} ms; network {net_ms:.2f} ms = backbone "
          f"{net_ms - local_ms - dense_ms:.2f} + local "
          f"{tuple(local_in.shape)} {str(local_in.dtype)[6:]} -> float32 "
          f"{local_ms:.3f} + connected {tuple(dense_in.shape)} -> 1715 "
          f"{dense_ms:.3f} ms; decode {dec_ms:.4f} ms (plain PyTorch), NMS "
          f"{nms_ms:.4f} ms (one kernel), the rest "
          f"{step - net_ms - dec_ms - nms_ms:.2f} ms; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; mean num "
          f"{out.num.mean():.1f}; on {smi}")
    del det, x, local_in, dense_in
    torch.cuda.empty_cache()

    # every other new section, f32, card against the CPU port
    specs, net, _ = parse_cfg(EXOTIC_CFG)
    specs = specs + (S.Detect(()),)
    side = int(net["height"])
    raw, stats = engine.init_params(specs, side, SEED + 32)
    xe = torch.as_tensor(np.random.default_rng(SEED + 32).uniform(
        0, 1, (EXOTIC_BATCH, 3, side, side)).astype(np.float32))
    errs = {}
    for form, params, st in (("folded", W.fold_params(raw, stats, 1e-5,
                                                      "darknet"), None),
                             ("unfolded BN", raw, stats)):
        outs = []
        for device in (dev, "cpu"):
            net_ = engine.Network(specs, params, device=device,
                                  batch_stats=st)
            with torch.inference_mode():
                (feat, _), = net_(xe.to(device))
            outs.append(feat.cpu().numpy())
        np.testing.assert_allclose(outs[0], outs[1], **EXOTIC_TOL)
        errs[form] = float(np.abs(outs[0] - outs[1]).max())
    print(f"[31 exotic] crop, BN conv, LRN, local, BN deconv, l2norm, "
          f"logistic, BN conv and BN connected at {side}^2, B={EXOTIC_BATCH}"
          f", f32 on the card against the CPU port: max |err| "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f" (tol {EXOTIC_TOL})")


def charrnn_phase(dev, kind, smi, tmp):
    """Phase 32: darknet's char-RNN (cfg/rnn.cfg, and the same widths with
    [gru] and [lstm]) from seeded .weights through textgen: CHARRNN_N
    characters sampled after CHARRNN_SEED on the card with
    set_sync_debug_mode("error") around the whole loop, the text equal to
    the CPU port's for the same rng_seed, every step's probabilities
    (feeding both the seed and the card's text) within PROB_TOL of the CPU
    port's; characters/s priming and sampling, the card's idle share over a
    traced sampling run. Then CRNN_CFG's two [crnn] layers on the card
    against the CPU port, the state carried across two calls."""
    from yolo_tensorflow_tpu_torch import textgen as TT
    from yolo_tensorflow_tpu_torch.io import weights as W
    from yolo_tensorflow_tpu_torch.io.cfg import parse_cfg
    from yolo_tensorflow_tpu_torch.models import engine
    from yolo_tensorflow_tpu_torch.models import specs as S
    for name, cell in CHARRNN_CELLS.items():
        label = f"32 char-{name}"
        cfg_path = os.path.join(tmp, f"{name}.cfg")
        with open(cfg_path, "w") as f:
            f.write(RNN_NET + (cell + "\n") * 3 + RNN_TAIL)
        specs, net, _ = parse_cfg(RNN_NET + (cell + "\n") * 3 + RNN_TAIL)
        vocab = int(net["inputs"])
        params, stats = engine.init_params(specs, 1, SEED + 32,
                                           in_channels=vocab)
        wpath = os.path.join(tmp, f"{name}.weights")
        W.save_darknet_weights(specs, 1, params, stats, wpath,
                               in_channels=vocab)
        del params, stats
        specs, params, inputs = TT.load_charrnn(cfg_path, wpath)
        n_weights = W.param_count(specs, 1, in_channels=inputs,
                                  with_bn=False)
        gpu = TT.CharRnnSampler(specs, params, inputs,
                                temperature=CHARRNN_TEMP, device=dev)
        cpu = TT.CharRnnSampler(specs, params, inputs,
                                temperature=CHARRNN_TEMP, device="cpu")
        u = TT.gumbel_uniforms(SEED, CHARRNN_N, inputs)
        u_dev = torch.as_tensor(u, device=dev)
        gpu.sample_tokens(seed_text=CHARRNN_SEED[:8], n=8,
                          uniforms=u_dev[:8])            # warm-up
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            gpu.sample_tokens(seed_text=CHARRNN_SEED, n=0, uniforms=u_dev[:0])
            torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            prime_s = time.perf_counter() - t0
            torch.cuda.set_sync_debug_mode("error")
            t0 = time.perf_counter()
            toks = gpu.sample_tokens(seed_text=CHARRNN_SEED, n=CHARRNN_N,
                                     uniforms=u_dev)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        toks = toks.cpu().numpy()
        want = cpu.sample_tokens(seed_text=CHARRNN_SEED, n=CHARRNN_N,
                                 uniforms=u).numpy()
        same = int((toks == want).sum())
        require(np.array_equal(toks, want), f"{label}: the card's text "
                f"differs from the CPU port's at {CHARRNN_N - same} of "
                f"{CHARRNN_N} characters, the first at "
                f"{int(np.argmax(toks != want))}")
        symbols = list(gpu.symbols(CHARRNN_SEED)) + toks.tolist()
        p_gpu = gpu.step_probs(symbols).cpu().numpy()
        p_cpu = cpu.step_probs(symbols).numpy()
        np.testing.assert_allclose(p_gpu, p_cpu, **PROB_TOL)
        err = np.abs(p_gpu - p_cpu)
        # the traced run: the device's busy share of the sampling loop
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        torch.cuda.synchronize()
        prof.start()
        t0 = time.perf_counter()
        gpu.sample_tokens(seed_text=CHARRNN_SEED, n=CHARRNN_N, uniforms=u_dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.stop()
        busy, n_spans = device_busy(prof, os.path.join(tmp, f"{name}.json"))
        require(0 < busy < wall, f"{label}: device busy {busy} of {wall} s")
        n_prime = len(gpu.symbols(CHARRNN_SEED)) - 1
        sample_s = total_s - prime_s
        text = bytes(int(c) for c in toks).decode("utf-8", errors="replace")
        print(f"[{label}] {specs[1].__class__.__name__} x3 at 1024, "
              f"{n_weights / 1e6:.2f} M weights (f32, TF32 off): "
              f"{CHARRNN_N} characters after a {n_prime + 1}-byte seed on "
              f"the card under set_sync_debug_mode('error') (no host sync "
              f"from the upload to the last token), equal to the CPU port's "
              f"for rng_seed {SEED}; {len(symbols)} steps' probabilities "
              f"within {PROB_TOL} (max |err| {err.max():.3g}); priming "
              f"{n_prime / prime_s:.1f} char/s, sampling "
              f"{CHARRNN_N / sample_s:.1f} char/s "
              f"({sample_s / CHARRNN_N * 1e3:.3f} ms a character); traced "
              f"run {wall:.3f} s, device busy {busy:.4f} s ({n_spans} "
              f"kernel, memcpy and memset intervals, "
              f"{n_spans / (CHARRNN_N + n_prime):.1f} a step), idle share "
              f"{1 - busy / wall:.3f}; text {text[:40]!r}...; on {smi}")
        del gpu, cpu, u_dev

    # the [crnn] at a narrow feature map, the state carried
    specs, net, _ = parse_cfg(CRNN_CFG)
    specs = specs + (S.Detect(()),)
    side = int(net["height"])
    raw, stats = engine.init_params(specs, side, SEED + 33)
    x = torch.as_tensor(np.random.default_rng(SEED + 33).uniform(
        -1, 1, (CRNN_BATCH * CRNN_STEPS, 3, side, side)).astype(np.float32))
    half = CRNN_BATCH * CRNN_STEPS // 2
    outs = []
    for device in (dev, "cpu"):
        net_ = engine.Network(specs, raw, device=device, batch_stats=stats)
        xs = x.to(device).contiguous(memory_format=torch.channels_last)
        with torch.inference_mode():
            (joint, _), = net_.forward_state(xs,
                                             time_steps=CRNN_STEPS)[0]
            ((a, _),), st = net_.forward_state(xs[:half],
                                               time_steps=CRNN_STEPS // 2)
            (b, _), = net_.forward_state(xs[half:],
                                         time_steps=CRNN_STEPS // 2,
                                         rec_state=st)[0]
        outs.append((joint.cpu().numpy(),
                     torch.cat([a, b]).cpu().numpy()))
    (gj, gs), (cj, cs) = outs
    np.testing.assert_allclose(gj, cj, **CRNN_TOL)
    np.testing.assert_allclose(gs, gj, **CRNN_TOL)
    np.testing.assert_allclose(cs, cj, **CRNN_TOL)
    print(f"[32 crnn] two [crnn] layers (BN, 32 hidden) at {side}^2, "
          f"B={CRNN_BATCH} x {CRNN_STEPS} steps, f32 on the card against "
          f"the CPU port: max |err| {float(np.abs(gj - cj).max()):.3g}; two "
          f"calls of {CRNN_STEPS // 2} steps with the state carried equal "
          f"one of {CRNN_STEPS} (tol {CRNN_TOL})")


def hold_leaf(label, got, want, ref=None):
    """The card's ``got`` within LAYER_GRAD_TOL of the largest |value| of
    the CPU port's ``want``; where it is not, within GRAD_FLOOR[0] x the
    CPU port's own distance from a float64 evaluation of the same thing
    (``ref()``, computed only then), plus 1e-6 of that largest value.
    Returns (the relative error, whether it needed the float64 floor)."""
    err = (got - want).abs().max().item()
    scale = max(want.abs().max().item(), 1e-30)
    if err <= LAYER_GRAD_TOL * scale + 1e-6:
        return err / scale, False
    require(ref is not None, f"{label}: off by {err:.3g} of {scale:.3g}")
    r = ref().double()
    e_card = (got.double() - r).abs().max().item()
    e_cpu = (want.double() - r).abs().max().item()
    require(e_card <= GRAD_FLOOR[0] * e_cpu + 1e-6 * scale,
            f"{label}: off the CPU port's by {err:.3g} of {scale:.3g}, "
            f"{e_card:.3g} from float64 where the CPU port is {e_cpu:.3g}")
    return err / scale, True


def _conv64(net, i, spec, xin, scale, eps, c):
    """TrainNetwork._conv of layer i with the fake quantization as it is
    (float32) and the conv, BN and activation in float64, and the float64
    gradients of sum(y * c): the reference of qat_layer_parity's floor."""
    from yolo_tensorflow_tpu_torch.models import engine
    from yolo_tensorflow_tpu_torch.ops import layers as L
    from yolo_tensorflow_tpu_torch.ops import qat as QAT
    p = net.params[engine.layer_key(i)]
    w = p["w"]
    if scale is not None:
        xin, _ = QAT.fake_quant_conv_input(xin, scale)
        w = QAT.fake_quant_weights(w)
    x64 = xin.double().contiguous(memory_format=torch.channels_last)
    st = {}
    if spec.bn:
        y, st["mean"], st["var"] = net._bn_conv(x64, spec, w, p,
                                                torch.float64, "twopass",
                                                eps)
    else:
        y = L.conv2d(x64, w, p["b"], stride=spec.stride,
                     pad=None if spec.pad < 0 else spec.pad,
                     compute_dtype=torch.float64, train=True)
    y = L.activate(y, spec.act)
    leaves = list(p.items())
    grads = torch.autograd.grad((y * c.double()).sum(),
                                [v for _, v in leaves])
    return {"output": y.detach(),
            **{f"stat {n}": v.detach() for n, v in st.items()},
            **{f"grad {n}": g.double() for (n, _), g in zip(leaves, grads)}}


def qat_layer_parity(label, cfg, specs, params, stats, imgs, dev):
    """Every conv of the QAT train forward on its own inputs: the CPU port's
    forward (scales from zero) gives each layer's input; each conv
    (TrainNetwork._conv: the input and weight fake-quantized, the conv, BN
    from the batch, the activation) then runs on the card and on the CPU
    from that same input. Its act_range equal, output and batch statistics
    within LAYER_GRAD_TOL of their largest, and the gradients of a seeded
    weighted sum of its output with respect to its parameters within
    LAYER_GRAD_TOL of each leaf's largest; or, where a leaf is not, within
    the float64 floor of hold_leaf (_conv64). A weight gradient through
    train-mode BN sums zero-mean cotangents against inputs of a large
    mean, and the two devices' float32 sums cancel apart by up to ~1e-3 of
    the largest (yolov3-416's layer 37: 0.111 of 108). The BN statistics
    are two-pass here: the one-pass variance E[y^2] - E[y]^2 cancels too
    (layer 42: 4.2e-3), and phases 8 and 9 hold that form. Returns a
    summary."""
    from yolo_tensorflow_tpu_torch.models import engine
    from yolo_tensorflow_tpu_torch.models import specs as S
    from yolo_tensorflow_tpu_torch.ops import layers as L
    from yolo_tensorflow_tpu_torch.ops import qat as QAT
    from yolo_tensorflow_tpu_torch.pipeline import normalize_images
    nets = {d: engine.TrainNetwork(specs, params, device=d)
            for d in (dev, "cpu")}
    x = normalize_images(torch.as_tensor(imgs), cfg)
    scales = QAT.init_scales(specs)
    outputs = {}
    with torch.no_grad():
        nets["cpu"]._run(0, len(specs), x, x, outputs, [], {}, None,
                         "twopass", cfg.bn_eps, None, 1, scales, {})
    gen = torch.Generator().manual_seed(SEED + 33)
    worst = collections.defaultdict(float)
    n_q = n_floor = 0
    for i, spec in enumerate(specs):
        if not isinstance(spec, S.Conv):
            continue
        xin = x if i == 0 else outputs[i - 1]
        c = torch.randn(outputs[i].shape, generator=gen)
        res = []
        for d in (dev, "cpu"):
            net, ranges = nets[d], {}
            with L.exact_f32_convs(torch.device(d).type == "cuda"):
                y, st = net._conv(i, spec, xin.to(d), None, "twopass",
                                  cfg.bn_eps, {k: v.to(d) for k, v in
                                               scales.items()}, ranges)
                leaves = list(net.params[engine.layer_key(i)].items())
                grads = torch.autograd.grad((y * c.to(d)).sum(),
                                            [v for _, v in leaves])
            res.append((y.detach().cpu(), {k: v.cpu() for k, v in
                                           (st or {}).items()},
                        {k: float(v) for k, v in ranges.items()},
                        {n: g.cpu() for (n, _), g in zip(leaves, grads)}))
        (yc, sc, rc, gc), (yp, sp, rp, gp) = res
        key = engine.layer_key(i)
        require(rc == rp and (key in rc) == (key in scales),
                f"{label}: layer {i} act_range {rc} vs {rp}")
        n_q += key in rc
        ref64 = {}

        def ref(what, i=i, spec=spec, xin=xin, c=c, key=key):
            if not ref64:
                ref64.update(_conv64(nets["cpu"], i, spec, xin,
                                     scales.get(key), cfg.bn_eps, c))
            return ref64[what]

        for what, got, want in ([("output", yc, yp)]
                                + [(f"stat {n}", sc[n], v)
                                   for n, v in sp.items()]
                                + [(f"grad {n}", gc[n], v)
                                   for n, v in gp.items()]):
            rel, floored = hold_leaf(f"{label}: layer {i} {what}", got, want,
                                     lambda what=what: ref(what))
            kind = what.split()[0]
            worst[kind] = max(worst[kind], rel)
            n_floor += floored
    return (f"{n_q} quantized convs and the heads each on the CPU port's "
            f"inputs (two-pass BN): act_ranges equal, outputs within "
            f"{worst['output']:.2g}, batch statistics {worst['stat']:.2g}, "
            f"gradients {worst['grad']:.2g} of their largest ({n_floor} "
            f"leaves past {LAYER_GRAD_TOL} held by the float64 floor)")


def qat_parity(label, cfg, specs, params, stats, n_fused, dev):
    """One f32 onepass QAT step of yolov3-416 at TRAIN_PARITY_BATCH: the
    entry point (make_train_step on a qat=True state) with conv_bnstat's
    launches counted and every scale warmed; each conv on the CPU port's
    inputs (qat_layer_parity); then the whole step's gradients, batch
    statistics, cost, metrics, act_ranges and updated scales against the
    CPU port's from the same seeded state (QAT_TOL or the cuDNN path's
    floor, GRAD_FLOOR), the first conv's act_range equal."""
    from yolo_tensorflow_tpu_torch.models import engine
    from yolo_tensorflow_tpu_torch.ops import qat as QAT
    from yolo_tensorflow_tpu_torch.ops.kernels import conv_bnstat as BS
    from yolo_tensorflow_tpu_torch.train import loop as TL
    imgs, tr = train_inputs(cfg, TRAIN_PARITY_BATCH, SEED + 33)
    tx = lambda: TL.make_optimizer(TL.darknet_lr_schedule(1e-3,
                                                          burn_in=1000))
    opt = tx()
    state = TL.create_train_state(cfg, opt, device=dev, params=params,
                                  batch_stats=stats, specs=specs, qat=True)
    step = TL.make_train_step(cfg, opt, specs=specs, bn_stats="onepass")
    torch.cuda.synchronize()
    BS.launches = 0
    state, m = step(state, imgs, tr)
    torch.cuda.synchronize()
    launches = BS.launches
    warm = [float(v) for v in state.qat_scales.values()]
    require(launches == n_fused and np.isfinite(float(m["cost"]))
            and len(warm) == len(QAT.quantizable_layers(specs))
            and all(v > 0 for v in warm),
            f"{label}: make_train_step launched conv_bnstat {launches} times "
            f"(expected {n_fused}), cost {float(m['cost'])}, scales {warm}")
    del state, step

    def on(device):
        st = TL.create_train_state(cfg, tx(), device=device, params=params,
                                   batch_stats=stats, specs=specs, qat=True)
        ranges = {}
        g, new, met = TL.loss_and_grads(
            cfg, specs, st.network, torch.as_tensor(imgs, device=device),
            torch.as_tensor(tr, device=device), seen=torch.tensor(0),
            generator=st.generator, bn_stats="onepass",
            qat_scales=st.qat_scales, act_ranges=ranges)
        scales = QAT.update_scales(st.qat_scales, ranges)
        cpu = lambda t: {k: {n: v.cpu() for n, v in p.items()}
                         for k, p in t.items()}
        return (cpu(g), cpu(new), {k: float(v) for k, v in met.items()},
                {k: float(v) for k, v in ranges.items()},
                {k: float(v) for k, v in scales.items()})

    local = qat_layer_parity(label, cfg, specs, params, stats, imgs, dev)
    t0 = time.perf_counter()
    card = on(dev)
    real = engine.uses_conv_bnstat
    engine.uses_conv_bnstat = lambda spec: False   # cuDNN + plain stats
    try:
        alt = on(dev)
    finally:
        engine.uses_conv_bnstat = real
    t1 = time.perf_counter()
    cpu = on("cpu")
    cpu_s = time.perf_counter() - t1
    first = engine.layer_key(0)
    require(card[3][first] == cpu[3][first], f"{label}: the first conv's "
            f"act_range {card[3][first]} vs {cpu[3][first]}")
    flat = lambda vals: torch.tensor([float(v) for v in vals],
                                     dtype=torch.float64)
    errs = {}
    for what, get, rtol in (
            ("act_ranges", lambda r: [r[3][k] for k in sorted(cpu[3])],
             QAT_TOL["ranges"]),
            ("scales", lambda r: [r[4][k] for k in sorted(cpu[4])],
             QAT_TOL["ranges"]),
            ("batch stats", lambda r: torch.cat([
                r[1][k][n].flatten() for k in sorted(cpu[1])
                for n in sorted(cpu[1][k])]).tolist(), TRAIN_TOL["rtol"])):
        e, f = (rel_l2(flat(get(r)), flat(get(cpu))) for r in (card, alt))
        require(e <= max(rtol, GRAD_FLOOR[0] * f), f"{label}: {what}: "
                f"relative L2 {e:.3g} from the CPU port's, the cuDNN "
                f"path's {f:.3g}")
        errs[what] = (e, f)
    require(np.isfinite(card[2]["cost"]), f"{label}: cost not finite")
    names = [(k, n) for k in sorted(cpu[0]) for n in sorted(cpu[0][k])]
    summary = grad_floor_check(label, names, card[0], alt[0], cpu[0])
    print(f"[{label}] {cfg.name}-{cfg.input_size} B={len(imgs)} f32 "
          f"onepass QAT ({len(warm)} fake-quantized convs, the scales from "
          f"zero): make_train_step launched conv_bnstat {launches} times "
          f"and warmed every scale; {local}; the whole step, card vs CPU "
          f"port ({cpu_s:.1f} s on the CPU, {t1 - t0:.1f} s for both card "
          f"passes): cost {card[2]['cost']:.8g} vs {cpu[2]['cost']:.8g} "
          f"(cuDNN path {alt[2]['cost']:.8g}), the first conv's act_range "
          f"equal; relative L2 from the CPU port's, kernel path vs cuDNN "
          f"path: "
          + ", ".join(f"{k} {e:.3g} vs {f:.3g}" for k, (e, f) in
                      errs.items())
          + f"; gradients, {summary}")
    return launches


def qat_rate(label, cfg, specs, params, stats, n_fused, dev, smi):
    """bf16 onepass training at TRAIN_BATCH (phase 10's inputs), the plain
    step and the QAT step in turns: 3 rounds of 5 steps each, the order
    alternating; step ms and peak GiB of each, one QAT step's conv_bnstat
    launches and no host sync in it (set_sync_debug_mode("error"))."""
    from yolo_tensorflow_tpu_torch.ops.kernels import conv_bnstat as BS
    from yolo_tensorflow_tpu_torch.train import loop as TL
    imgs, tr = train_inputs(cfg, TRAIN_BATCH, SEED + 10)
    imgs, tr = torch.as_tensor(imgs, device=dev), torch.as_tensor(tr,
                                                                  device=dev)
    runs = {}
    for name, qat in (("plain", False), ("qat", True)):
        tx = TL.make_optimizer(TL.darknet_lr_schedule(1e-3, burn_in=1000))
        runs[name] = [TL.create_train_state(
            cfg, tx, device=dev, params=params, batch_stats=stats,
            specs=specs, qat=qat), TL.make_train_step(
                cfg, tx, specs=specs, compute_dtype=torch.bfloat16,
                bn_stats="onepass")]
    costs = []
    for name, run in runs.items():
        for _ in range(2):                      # warm-up
            run[0], m = run[1](run[0], imgs, tr)
            costs.append(m["cost"])
    torch.cuda.synchronize()
    BS.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        runs["qat"][0], m = runs["qat"][1](runs["qat"][0], imgs, tr)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    launches = BS.launches
    require(launches == n_fused, f"{label}: one QAT step launched "
            f"conv_bnstat {launches} times, expected {n_fused}")
    step_ms = {name: [] for name in runs}
    peak = {name: 0.0 for name in runs}
    for r in range(3):
        for name in (("plain", "qat") if r % 2 == 0 else ("qat", "plain")):
            run = runs[name]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(5):
                run[0], m = run[1](run[0], imgs, tr)
                costs.append(m["cost"])
            torch.cuda.synchronize()
            step_ms[name].append((time.perf_counter() - t0) * 1e3 / 5)
            peak[name] = max(peak[name],
                             torch.cuda.max_memory_allocated() / 2 ** 30)
    costs = torch.stack(costs).cpu().numpy()
    require(np.all(np.isfinite(costs)), f"{label}: cost not finite")
    med = {k: statistics.median(v) for k, v in step_ms.items()}
    print(f"[{label}] {cfg.name}-{cfg.input_size} B={TRAIN_BATCH} bf16 "
          f"onepass, in turns (3 rounds x 5 steps each): QAT step "
          f"{med['qat']:.2f} ms (spread {min(step_ms['qat']):.2f}.."
          f"{max(step_ms['qat']):.2f}), {TRAIN_BATCH * 1e3 / med['qat']:.1f}"
          f" img/s, peak {peak['qat']:.2f} GiB; plain step "
          f"{med['plain']:.2f} ms (spread {min(step_ms['plain']):.2f}.."
          f"{max(step_ms['plain']):.2f}), "
          f"{TRAIN_BATCH * 1e3 / med['plain']:.1f} img/s, peak "
          f"{peak['plain']:.2f} GiB; QAT / plain "
          f"{med['qat'] / med['plain']:.3f}; one QAT step: {launches} "
          f"conv_bnstat launches, no host sync under "
          f"set_sync_debug_mode('error'); on {smi}")
    del runs
    torch.cuda.empty_cache()
    return launches, med


def qat_phase(cfg, specs, n_fused, dev, kind, smi, tmp, v3_path):
    """Phase 33: quantization-aware training of yolov3-416 (ops/qat.py) and
    serving what it ships. Returns the conv_bnstat launches of one QAT
    step."""
    import argparse
    import contextlib
    import io
    from yolo_tensorflow_tpu_torch.cli import _load_npz_params
    from yolo_tensorflow_tpu_torch.models import engine
    from yolo_tensorflow_tpu_torch.ops import layers as L
    from yolo_tensorflow_tpu_torch.ops import qat as QAT
    from yolo_tensorflow_tpu_torch.ops.kernels import conv_bnstat as BS
    from yolo_tensorflow_tpu_torch.pipeline import Detector, normalize_images
    from yolo_tensorflow_tpu_torch.post import nms as NMS
    from yolo_tensorflow_tpu_torch.train import runner
    params, stats = engine.init_params(specs, cfg.input_size, SEED,
                                       obj_bias=OBJ_BIAS)
    torch.backends.cudnn.benchmark = False
    launches = qat_parity("33 qat f32", cfg, specs, params, stats, n_fused,
                          dev)
    torch.backends.cudnn.benchmark = True
    qat_rate("33 qat bf16", cfg, specs, params, stats, n_fused, dev, smi)
    del params, stats

    # run_training --qat on 416x416 synthetic scenes, resumed once
    torch.backends.cudnn.benchmark = False
    root = os.path.join(tmp, "qat_run")
    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "labels"))
    imgs, labels = scenes(QAT_SCENES, SEED + 33, cfg.input_size,
                          cfg.input_size)
    pixels = {}
    for i, (img, lab) in enumerate(zip(imgs, labels)):
        path = os.path.join(root, "images", f"scene{i:03d}.jpg")
        with open(os.path.join(root, "labels", f"scene{i:03d}.txt"),
                  "w") as f:
            f.write(lab)
        pixels[path] = img
    lst = os.path.join(root, "train.txt")
    with open(lst, "w") as f:
        f.write("\n".join(pixels) + "\n")
    os.environ["YOLO_NATIVE_LOADER"] = "1"
    logs, walls = [], []
    for n_steps in QAT_RUN_STEPS:
        args = argparse.Namespace(
            model=MODEL, cfg=None, names=None, list=lst, val_list=lst,
            eval_every=QAT_RUN_STEPS[0], weights=v3_path,
            ckpt_dir=os.path.join(root, "ckpt"), batch_size=QAT_RUN_BATCH,
            steps=n_steps, lr=QAT_RUN_LR, burn_in=10, input_size=None,
            multiscale=False, bf16=True, bn_onepass=True, num_data=1,
            num_spatial=1, cache_images=False, save_every=QAT_RUN_STEPS[0],
            log_every=4, qat=True, device=str(dev))
        out = io.StringIO()
        BS.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            state = runner.run_training(args, read_fn=pixels.__getitem__)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        logs.append(out.getvalue())
        for line in out.getvalue().splitlines():
            print(f"[33 run_training --qat] {line}")
    n_int8 = len(QAT.quantizable_layers(specs))
    maps = [line for line in logs[0].splitlines() if "val mAP@0.5" in line]
    require(len(maps) == 1 and f"QAT export: " in logs[0]
            and f"({n_int8} int8 convs)" in logs[1]
            and f"resumed from step {QAT_RUN_STEPS[0]}" in logs[1]
            and int(state.step) == QAT_RUN_STEPS[1],
            f"33 run_training --qat: evaluations {maps}, step "
            f"{int(state.step)}")
    npz = os.path.join(root, "ckpt", "int8-qat.npz")
    print(f"[33 run_training --qat] {MODEL}-{cfg.input_size} bf16 onepass "
          f"B={QAT_RUN_BATCH}: {QAT_RUN_STEPS[0]} steps with one in-training"
          f" evaluation of the int8 export ({maps[0].split(': ', 1)[1]}) in "
          f"{walls[0]:.1f} s, resumed to step {QAT_RUN_STEPS[1]} in "
          f"{walls[1]:.1f} s; {os.path.basename(npz)} "
          f"{os.path.getsize(npz) / 2 ** 20:.1f} MiB with {n_int8} int8 "
          f"convs")

    # serving the export: f32 epilogue against the CPU port, bf16 rate
    qparams = _load_npz_params(npz)
    require(sum("w_q" in p for p in qparams.values()) == n_int8,
            "33: int8-qat.npz holds the wrong number of int8 convs")
    rng = np.random.default_rng(SEED + 34)
    pimgs = rng.integers(0, 256, (PARITY_BATCH, cfg.input_size,
                                  cfg.input_size, 3), dtype=np.uint8)
    gpu = Detector(MODEL, params=qparams, device=dev,
                   conf_threshold=QAT_CONF)
    cpu = Detector(MODEL, params=qparams, device="cpu",
                   conf_threshold=QAT_CONF)
    check_detections("33 int8-qat f32", gpu, pimgs, NMS.fetch_detections(
        gpu.detect_batch(pimgs)), NMS.fetch_detections(cpu.detect_batch(
            pimgs)), cfg, kind, QAT_CONF)
    del gpu, cpu
    torch.backends.cudnn.benchmark = True
    det = Detector(MODEL, params=qparams, device=dev,
                   compute_dtype=torch.bfloat16, conf_threshold=QAT_CONF)
    x = torch.as_tensor(rng.integers(0, 256, (SERVE_BATCH, cfg.input_size,
                                              cfg.input_size, 3),
                                     dtype=np.uint8), device=dev)
    step_ms, rates, out = serve_rate(lambda: det.detect_batch(x), len(x))
    out = NMS.fetch_detections(out)
    require(np.isfinite(out.boxes).all(), "33: int8-qat bf16 boxes not "
            "finite")
    counted_forward("33 int8-qat bf16", lambda: det.detect_batch(x),
                    int8=n_int8, int8_direct=1, decode=1, nms=1)
    print(f"[33 int8-qat bf16] detect_batch B={SERVE_BATCH} at "
          f"{cfg.input_size}: {statistics.median(rates):.1f} img/s median of"
          f" 3 x 5 steps (spread {min(rates):.1f}..{max(rates):.1f}); mean "
          f"num {out.num.mean():.1f}; on {smi}")
    del det, x

    # the fake-quant evaluation against the int8 export, conv by conv on
    # the fake-quant network's own inputs (a whole-network comparison
    # drifts apart as in qat_parity)
    torch.backends.cudnn.benchmark = False
    raw = {k: {n: v.detach().cpu().numpy() for n, v in p.items()}
           for k, p in state.params.items()}
    st = {k: {n: v.cpu().numpy() for n, v in p.items()}
          for k, p in state.batch_stats.items()}
    scales = QAT.qat_eval_scales(state.qat_scales)
    fq = {d: engine.Network(specs, raw, device=d, batch_stats=st,
                            bn_eps=cfg.bn_eps, bn_formula="tf",
                            qat_scales=scales) for d in (dev, "cpu")}
    q = engine.Network(specs, qparams, device=dev)
    xin = normalize_images(torch.as_tensor(pimgs, device=dev), cfg)
    gap, dev_err = 0.0, 0.0
    with torch.inference_mode():
        outs = fq[dev].layer_outputs(xin)
        for key, conv in fq[dev].convs.items():
            if not isinstance(conv, engine.FakeQuantConv):
                continue
            i = int(key[1:])
            xi = xin if i == 0 else outs[i - 1]
            with L.exact_f32_convs():
                a, b = conv(xi), q.convs[key](xi)
            c = fq["cpu"].convs[key](xi.cpu())
            gap = max(gap, ((a - b).abs().max() / a.std()).item())
            dev_err = max(dev_err, ((a.cpu() - c).abs().max()
                                    / c.abs().max()).item())
    require(gap < 2e-2 and dev_err <= LAYER_GRAD_TOL,
            f"33 fake-quant vs int8 export: the largest gap {gap:.4g} of a "
            f"conv's output deviation, card vs CPU {dev_err:.3g}")
    print(f"[33 fake-quant vs int8-qat] the trained state's fake-quant "
          f"network ('tf' BN) and its int8 export, each of the {len(scales)}"
          f" quantized convs on the fake-quant network's inputs on the "
          f"card, B={PARITY_BATCH}: int8 kernel output within {gap:.3g} of "
          f"the fake-quant conv's deviation (limit 2e-2, the TPU package's "
          f"test_qat_eval_matches_int8_export); the fake-quant conv within "
          f"{dev_err:.2g} of the CPU port's")
    del state
    torch.cuda.empty_cache()
    return launches


def _grads_of(net, x, c, **kw):
    """(heads, batch statistics, {path: gradient}) of sum(head * c) over a
    TrainNetwork's heads."""
    from yolo_tensorflow_tpu_torch.ops import layers as L
    from yolo_tensorflow_tpu_torch.train.loop import tree_leaves
    with L.exact_f32_convs(x.is_cuda):
        dets, stats = net(x, **kw)
        leaves = tree_leaves(net.params_tree())
        grads = torch.autograd.grad(
            sum((d * ci.to(d.device)).sum() for (d, _), ci in zip(dets, c)),
            [v for _, v in leaves])
    return ([d.detach().cpu() for d, _ in dets],
            {"/".join(p): v for p, v in tree_leaves(stats)},
            {"/".join(p): g.cpu() for (p, _), g in zip(leaves, grads)})


def _hold_train(label, card, cpu, tol, ref):
    """Heads and batch statistics within ``tol`` (rtol, atol), every
    gradient within LAYER_GRAD_TOL of its leaf's largest; where one is
    not, by hold_leaf's float64 floor (``ref()``: the same evaluation in
    float64, computed once). Returns (the largest relative gradient
    error, the leaves the floor held)."""
    memo = []

    def ref_of(i, k):
        if not memo:
            memo.append(ref())
        return memo[0][i][k]

    n_floor = 0
    for j, (a, b) in enumerate(zip(card[0], cpu[0])):
        if not np.allclose(a.numpy(), b.numpy(), **tol):
            n_floor += hold_leaf(f"{label}: head {j}", a, b,
                                 lambda j=j: ref_of(0, j))[1]
    require(card[1].keys() == cpu[1].keys(), f"{label}: statistics keys")
    for k, v in cpu[1].items():
        a = card[1][k].cpu()
        if not np.allclose(a.numpy(), v.numpy(), **tol):
            n_floor += hold_leaf(f"{label}: stat {k}", a, v,
                                 lambda k=k: ref_of(1, k))[1]
    worst = 0.0
    for k, want in cpu[2].items():
        rel, floored = hold_leaf(f"{label}: gradient {k}", card[2][k], want,
                                 lambda k=k: ref_of(2, k))
        worst, n_floor = max(worst, rel), n_floor + floored
    return worst, n_floor


def layers_train_phase(dev, kind, smi, tmp):
    """Phase 34: training darknet's other layers. EXOTIC_CFG less its [crop]
    (whose train-time crop is the data pipeline's): one f32 TrainNetwork
    step on the card against the CPU port (heads, batch statistics and the
    gradients of a seeded weighted sum of the heads). darknet's rnn.cfg and
    its [gru] and [lstm] twins at 1024: one f32 step at CHARRNN_PARITY
    (the next-byte loss, statistics and gradients) against the CPU port;
    train_char_rnn at CHARRNN_TRAIN for CHARRNN_ITERS on CORPUS's bytes,
    its loss falling, characters/s trained, the card's idle share
    over a traced run of 2 iterations, and the trained weights' text equal
    to the CPU port's; the CLI's rnn-train writing .weights that generate
    loads."""
    import contextlib
    import io
    from yolo_tensorflow_tpu_torch import cli
    from yolo_tensorflow_tpu_torch import textgen as TT
    from yolo_tensorflow_tpu_torch.io.cfg import parse_cfg
    from yolo_tensorflow_tpu_torch.models import engine
    from yolo_tensorflow_tpu_torch.models import specs as S
    from yolo_tensorflow_tpu_torch.ops import layers as L
    from yolo_tensorflow_tpu_torch.train.loop import tree_leaves
    torch.backends.cudnn.benchmark = False
    specs, net, _ = parse_cfg(EXOTIC_CFG)
    require(isinstance(specs[0], S.Crop), "EXOTIC_CFG starts with [crop]")
    side = specs[0].crop_height
    specs = specs[1:] + (S.Detect(()),)
    raw, _ = engine.init_params(specs, side, SEED + 34)
    x = torch.as_tensor(np.random.default_rng(SEED + 34).uniform(
        0, 1, (EXOTIC_BATCH, 3, side, side)).astype(np.float32)).contiguous(
            memory_format=torch.channels_last)
    heads = engine.TrainNetwork(specs, raw)(x)[0]
    c = [torch.as_tensor(np.random.default_rng(SEED + 35 + i)
                         .standard_normal(tuple(d.shape)).astype(np.float32))
         for i, (d, _) in enumerate(heads)]
    outs = [_grads_of(engine.TrainNetwork(specs, raw, device=device),
                      x.to(device), c) for device in (dev, "cpu")]
    worst, n_floor = _hold_train(
        "34 exotic train", outs[0], outs[1], EXOTIC_TOL,
        lambda: _grads_of(engine.TrainNetwork(specs, raw), x.double(), c,
                          compute_dtype=torch.float64))
    print(f"[34 exotic train] BN conv, LRN, local, BN deconv, l2norm, "
          f"logistic, BN conv and BN connected at {side}^2, B={EXOTIC_BATCH},"
          f" one f32 TrainNetwork step on the card against the CPU port: "
          f"heads and batch statistics within {EXOTIC_TOL}, gradients "
          f"within {worst:.2g} of each leaf's largest (limit "
          f"{LAYER_GRAD_TOL}; {n_floor} leaves held by the float64 floor)")

    corpus = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          CORPUS)
    with open(corpus, "rb") as f:
        text = f.read()
    for name, cell in CHARRNN_CELLS.items():
        label = f"34 char-{name} train"
        cfg_path = os.path.join(tmp, f"train-{name}.cfg")
        with open(cfg_path, "w") as f:
            f.write(RNN_NET + (cell + "\n") * 3 + RNN_TAIL)
        specs = TT._with_output_marker(parse_cfg(
            RNN_NET + (cell + "\n") * 3 + RNN_TAIL)[0])
        vocab = 256
        params, stats = engine.init_params(specs, 1, SEED + 34,
                                           in_channels=vocab)
        batch, steps = CHARRNN_PARITY
        xs, ys = TT.batch_text(text, vocab, batch, steps,
                               np.random.default_rng(SEED + 34))
        xs = torch.from_numpy(xs).view(-1, vocab, 1, 1)
        ys = torch.from_numpy(ys).long()
        def char_step(device, dtype=torch.float32):
            tn = engine.TrainNetwork(specs, params, device=device)
            with L.exact_f32_convs(torch.device(device).type == "cuda"):
                dets, st = tn(xs.to(device, dtype), compute_dtype=dtype,
                              time_steps=steps)
                loss = TT._char_loss(dets[-1][0], ys.to(device), True)
                leaves = tree_leaves(tn.params_tree())
                grads = torch.autograd.grad(loss, [v for _, v in leaves])
            return ([dets[-1][0].detach().cpu()],
                    {"/".join(p): v.cpu() for p, v in tree_leaves(st)},
                    {"/".join(p): g.cpu()
                     for (p, _), g in zip(leaves, grads)},
                    float(loss.detach()))

        one = [char_step(dev), char_step("cpu")]
        np.testing.assert_allclose(one[0][3], one[1][3], rtol=1e-5,
                                   err_msg=f"{label}: loss")
        worst, n_floor = _hold_train(label, one[0][:3], one[1][:3],
                                     CHARRNN_TOL,
                                     lambda: char_step("cpu", torch.float64))

        b_train, t_train = CHARRNN_TRAIN
        iters = CHARRNN_ITERS[name]
        log = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tspecs, folded, _, (raw_p, raw_st) = TT.train_char_rnn(
            text, cfg_path, steps_per_seq=t_train, batch=b_train,
            iters=iters, seed=SEED, log_every=10, log=log.append,
            return_raw=True, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = [float(line.rsplit(" ", 1)[1]) for line in log]
        require(np.all(np.isfinite(losses)) and losses[-1] < losses[0],
                f"{label}: the loss did not fall: {log}")
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        torch.cuda.synchronize()
        prof.start()
        t1 = time.perf_counter()
        TT.train_char_rnn(text, cfg_path, steps_per_seq=t_train,
                          batch=b_train, iters=2, seed=SEED + 1,
                          log_every=0, params=raw_p, batch_stats=raw_st,
                          device=dev)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t1
        prof.stop()
        busy, n_spans = device_busy(prof, os.path.join(tmp,
                                                       f"{name}-train.json"))
        require(0 < busy < traced, f"{label}: device busy {busy} of {traced}"
                " s")
        gpu, cpu = (TT.CharRnnSampler(tspecs, folded, vocab,
                                      temperature=CHARRNN_TEMP, device=d)
                    for d in (dev, "cpu"))
        u = TT.gumbel_uniforms(SEED, CHARRNN_GEN, vocab)
        got = gpu.sample_tokens(seed_text=CHARRNN_SEED, n=CHARRNN_GEN,
                                uniforms=u).cpu().numpy()
        want = cpu.sample_tokens(seed_text=CHARRNN_SEED, n=CHARRNN_GEN,
                                 uniforms=u).numpy()
        require(np.array_equal(got, want), f"{label}: the trained weights' "
                f"text on the card differs from the CPU port's at "
                f"{int((got != want).sum())} of {CHARRNN_GEN} characters")
        chars = iters * b_train * t_train
        sample = bytes(int(ch) for ch in got).decode("utf-8",
                                                     errors="replace")
        print(f"[{label}] {name} x3 at 1024: one f32 step at B={batch}, "
              f"T={steps} on the card against the CPU port: loss "
              f"{one[0][3]:.7g} vs {one[1][3]:.7g}, output and statistics "
              f"within {CHARRNN_TOL}, gradients within {worst:.2g} of each "
              f"leaf's largest ({n_floor} leaves held by the float64 "
              f"floor); train_char_rnn B={b_train}, T={t_train} on "
              f"{len(text)} bytes of {CORPUS}: {iters} iterations in "
              f"{wall:.2f} s, {chars / wall:.0f} characters/s trained, loss "
              f"{' -> '.join(f'{v:.4f}' for v in losses)}; traced 2 "
              f"iterations {traced:.3f} s, device busy {busy:.4f} s "
              f"({n_spans} kernel, memcpy and memset intervals), idle share "
              f"{1 - busy / traced:.3f}; {CHARRNN_GEN} characters from the "
              f"trained weights equal to the CPU port's: {sample[:40]!r}...;"
              f" on {smi}")
        del gpu, cpu, raw_p, raw_st, folded

    # the CLI's rnn-train: its .weights load into generate
    cfg_path = os.path.join(tmp, "train-rnn.cfg")
    wpath = os.path.join(tmp, "rnn-train.weights")
    outs = []
    for argv in (["rnn-train", "--cfg", cfg_path, "--text", corpus,
                  "--steps", "16", "--batch", "8", "--iters", "2", "--out",
                  wpath, "--device", dev.type],
                 ["generate", "--cfg", cfg_path, "--weights", wpath, "-n",
                  "64", "--seed-text", "darknet", "--device", dev.type]):
        outs.append(io.StringIO())
        with contextlib.redirect_stdout(outs[-1]):
            cli.main(argv)
    trained, generated = (o.getvalue() for o in outs)
    require(f"wrote {wpath}" in trained.splitlines()
            and generated.startswith("darknet") and len(generated) > 64,
            f"34 rnn-train: {trained[-200:]!r}, {generated[:80]!r}")
    print(f"[34 rnn-train] the CLI trained rnn.cfg 2 iterations on the card "
          f"and wrote {os.path.getsize(wpath) / 2 ** 20:.1f} MiB of "
          f".weights, which generate loads: {generated[:48]!r}...")


def tree_dream_phase(dev, kind, smi, tmp, v3_path):
    """Phase 35: the region loss with a hand-written softmax tree (TREE_TEXT,
    three levels, a classification-only image among three) on the card
    against the CPU port (value, metrics and gradient within TREE_TOL);
    then dream for DREAM_OCTAVES octaves x DREAM_ITERS iterations on the
    seeded yolov3-416's prefix to DREAM_LAYER, the objective history card
    against the CPU port within DREAM_TOL and at most DREAM_PIXELS of the
    images' pixels more than a level apart."""
    from yolo_tensorflow_tpu_torch import config as C
    from yolo_tensorflow_tpu_torch import dream as D
    from yolo_tensorflow_tpu_torch.io import weights as W
    from yolo_tensorflow_tpu_torch.models.tree import SoftmaxTree
    from yolo_tensorflow_tpu_torch.train import losses as TLo
    tree = SoftmaxTree.parse(TREE_TEXT)
    cfg = C.get_config("yolov2", custom_classes=tuple(tree.names))
    grid, anchors = cfg.input_size // 32, cfg.num_anchors
    rng = np.random.default_rng(SEED + 35)
    raw = rng.standard_normal((3, grid, grid, anchors * (5 + tree.n))
                              ).astype(np.float32)
    tr = np.zeros((3, 4, 5), np.float32)
    tr[0, 0] = [0.5, 0.5, 0.4, 0.4, 5]
    tr[0, 1] = [0.2, 0.7, 0.2, 0.3, 2]
    tr[1, 0] = [0.3, 0.3, 0.5, 0.2, 8]
    tr[2, 0] = [2e5, 2e5, 1.0, 1.0, 6]          # classification-only
    out = {}
    for device in (dev, "cpu"):
        r = torch.as_tensor(raw, device=device).requires_grad_(True)
        loss, met = TLo.yolo_v2_region_loss(
            r, torch.as_tensor(tr, device=device), cfg, seen=20000,
            tree=tree)
        (g,) = torch.autograd.grad(loss, r)
        out[str(device)] = (float(loss.detach()),
                            {k: float(v) for k, v in met.items()},
                            g.cpu().numpy())
    card, cpu = out[str(dev)], out["cpu"]
    np.testing.assert_allclose(card[0], cpu[0], rtol=TREE_TOL["rtol"])
    for k, v in cpu[1].items():
        np.testing.assert_allclose(card[1][k], v, **TREE_TOL, err_msg=k)
    np.testing.assert_allclose(card[2], cpu[2], **TREE_TOL)
    print(f"[35 tree loss] yolov2's region loss at {grid}x{grid}x{anchors} "
          f"with a {tree.n}-node softmax tree ({tree.groups} groups, depth "
          f"{tree.max_depth}), B=3 with a classification-only image, on "
          f"the card against the CPU port: cost {card[0]:.7g} vs "
          f"{cpu[0]:.7g}, metrics and gradient within {TREE_TOL} (max "
          f"|grad err| {np.abs(card[2] - cpu[2]).max():.3g})")

    cfg = C.get_config(MODEL)
    specs = C.build_specs(cfg)
    params, _ = W.load_darknet_weights(specs, cfg.input_size, v3_path)
    img = np.random.default_rng(SEED + 36).integers(
        0, 256, (cfg.input_size, cfg.input_size, 3), dtype=np.uint8)
    torch.backends.cudnn.benchmark = False
    res = {}
    for device in (dev, "cpu"):
        t0 = time.perf_counter()
        image, hist = D.dream(cfg, specs, params, img, DREAM_LAYER,
                              iters=DREAM_ITERS, octaves=DREAM_OCTAVES,
                              seed=SEED, device=device)
        res[str(device)] = (image, hist, time.perf_counter() - t0)
    (gi, gh, gs), (ci, ch, cs) = res[str(dev)], res["cpu"]
    np.testing.assert_allclose(gh, ch, rtol=DREAM_TOL,
                               err_msg="35 dream: objective history")
    apart = np.abs(gi.astype(int) - ci)
    share = float((apart > 1).mean())
    require(share <= DREAM_PIXELS, f"35 dream: {share:.3g} of the pixels "
            f"more than a level apart (at most {int(apart.max())})")
    print(f"[35 dream] {MODEL}-{cfg.input_size}'s prefix to layer "
          f"{DREAM_LAYER} ({specs[DREAM_LAYER]}), {DREAM_OCTAVES} octaves x "
          f"{DREAM_ITERS} iterations: objective "
          f"{', '.join(f'{v:.6g}' for v in gh)} on the card in {gs:.2f} s, "
          f"within {DREAM_TOL} of the CPU port's ({cs:.1f} s); images: "
          f"{share:.3g} of the pixels more than a level apart, at most "
          f"{int(apart.max())}; on {smi}")


def _tree_np(tree, prefix):
    """{"prefix/layer/name": numpy} of a nested dict of tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_tree_np(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v.detach().float().cpu().numpy()
    return out


def _state_np(state):
    """A TrainState's parameters, running statistics and SGD momentum as
    one flat dict of numpy arrays."""
    return {**_tree_np(state.params, "params"),
            **_tree_np(state.batch_stats, "stats"),
            **_tree_np(state.opt_state.momentum, "momentum")}


def _dp_tx():
    """SGD without weight decay: after one step the momentum buffer is the
    gradient itself."""
    from yolo_tensorflow_tpu_torch.train import loop as TL
    return TL.make_optimizer(TL.darknet_lr_schedule(1e-3, burn_in=1000),
                             weight_decay=0.0)


def _hold_state(label, got, want, names, tol):
    """Each of ``names`` (params/..., stats/... keys of _state_np) of
    ``got`` within tol["rtol"] * |want| + tol["atol"] of ``want``.
    Returns the largest error over each leaf's largest value."""
    worst = 0.0
    for key in names:
        err = np.abs(got[key] - want[key])
        lim = tol["rtol"] * np.abs(want[key]) + tol["atol"]
        require(np.all(err <= lim), f"{label}: {key}: |err| {err.max():.3g} "
                f"beyond rtol {tol['rtol']} / atol {tol['atol']}")
        worst = max(worst, float(err.max()) / max(
            float(np.abs(want[key]).max()), 1e-30))
    return worst


def _momentum_tree(flat):
    """{layer: {name: tensor}} of the momentum/... keys of _state_np."""
    out = collections.defaultdict(dict)
    for key, v in flat.items():
        if key.startswith("momentum/"):
            _, layer, name = key.split("/", 2)
            out[layer][name] = torch.from_numpy(v)
    return out


def _counting(calls, name, fn):
    """``fn`` that first appends (name, the element count of its first
    argument) to ``calls``: a collective counted on the host."""
    def call(*args, **kw):
        calls.append((name, args[0].numel() if args
                      and torch.is_tensor(args[0]) else 0))
        return fn(*args, **kw)
    return call


def dp_one_card(cfg, specs, n_fused, dev, smi, tmp):
    """Phase 36 (a): one rank on the card over NCCL (gloo on a CPU
    rehearsal). make_sharded_train_step against make_train_step from one
    seeded state, f32 onepass at DP_PARITY_BATCH: the sharded step's
    conv_bnstat launches counted, its metrics and running statistics
    within TRAIN_TOL, every gradient within GRAD_FLOOR[1] relative L2 (the
    same program, so bit for bit but for cuDNN's run-to-run order); bf16
    onepass at DP_RATE_BATCH, 3 samples of 5 steps of each in turns, the
    device busy time of one step of each from a torch.profiler trace, and
    the collectives of a sharded step counted on the host: none, since a
    mesh of one rank reduces nothing; one lone all-reduce call's host
    time. Returns the sharded step's conv_bnstat launches."""
    from yolo_tensorflow_tpu_torch.models import engine
    from yolo_tensorflow_tpu_torch.ops.kernels import conv_bnstat as BS
    from yolo_tensorflow_tpu_torch.parallel import mesh as P
    from yolo_tensorflow_tpu_torch.train import loop as TL
    label = "36a data parallel, one rank"
    P.init_distributed(f"localhost:{P.free_port()}", 1, 0, device=dev)
    try:
        mesh = P.make_mesh()
        backend = "nccl" if dev.type == "cuda" else "gloo"
        require(mesh.backend == backend and mesh.device == dev
                and mesh.num_data == 1, f"{label}: mesh {mesh}")
        params, stats = engine.init_params(specs, cfg.input_size, SEED,
                                           obj_bias=OBJ_BIAS)

        def make(sharded, batch, seed, **kw):
            tx = _dp_tx()
            state = TL.create_train_state(
                cfg, tx, device=dev, params=params, batch_stats=stats,
                specs=specs, mesh=mesh if sharded else None)
            kw = dict(specs=specs, bn_stats="onepass", **kw)
            step = (TL.make_sharded_train_step(cfg, tx, mesh, **kw)
                    if sharded else TL.make_train_step(cfg, tx, **kw))
            imgs, tr = train_inputs(cfg, batch, seed)
            imgs, tr = P.shard_batch(mesh, imgs, tr)
            return state, step, imgs, tr

        runs = {}
        for sharded in (False, True):
            state, step, imgs, tr = make(sharded, DP_PARITY_BATCH, SEED + 9)
            torch.cuda.synchronize()
            BS.launches = 0
            state, m = step(state, imgs, tr)
            torch.cuda.synchronize()
            runs[sharded] = (BS.launches, _state_np(state),
                             {k: float(v) for k, v in m.items()})
            del state, step
        (n_plain, plain, m_plain), (launches, dp, m_dp) = runs[False], \
            runs[True]
        require(launches == n_plain == n_fused, f"{label}: conv_bnstat "
                f"launches {launches} sharded, {n_plain} plain, expected "
                f"{n_fused}")
        for key, want in m_plain.items():
            np.testing.assert_allclose(m_dp[key], want,
                                       rtol=TRAIN_TOL["rtol"],
                                       err_msg=f"{label}: metric {key}")
        stat_err = _hold_state(label, dp, plain,
                               [k for k in plain if k.startswith("stats/")],
                               TRAIN_TOL)
        g_dp, g_plain = _momentum_tree(dp), _momentum_tree(plain)
        errs = {f"{k}/{n}": rel_l2(g_dp[k][n], g_plain[k][n])
                for k in g_plain for n in g_plain[k]}
        worst = max(errs, key=errs.get)
        require(errs[worst] <= GRAD_FLOOR[1], f"{label}: gradient {worst}: "
                f"relative L2 {errs[worst]:.3g} > {GRAD_FLOOR[1]}")
        same = sum(np.array_equal(dp[k], plain[k]) for k in plain)
        print(f"[{label}] {cfg.name}-{cfg.input_size} f32 onepass "
              f"B={DP_PARITY_BATCH}, {mesh.backend} world 1: "
              f"make_sharded_train_step launched conv_bnstat {launches} "
              f"times; cost {m_dp['cost']:.6g} vs plain {m_plain['cost']:.6g}, "
              f"metrics within rtol {TRAIN_TOL['rtol']}, running stats "
              f"within {stat_err:.2g} of each leaf's max, gradients' "
              f"relative L2 max {errs[worst]:.3g} ({worst}); {same} of "
              f"{len(plain)} leaves bit for bit")
        del runs, dp, plain, g_dp, g_plain

        # bf16 in turns: a mesh of one rank calls no collective, so its
        # step should cost what the plain step costs
        import torch.distributed as dist
        torch.backends.cudnn.benchmark = True
        names = ("plain", "sharded")
        paths = {name: make(name != "plain", DP_RATE_BATCH, SEED + 10,
                            compute_dtype=torch.bfloat16) for name in names}
        states = {name: p[0] for name, p in paths.items()}
        enqueue = collections.defaultdict(list)

        def steps(name, n):
            _, step, imgs, tr = paths[name]
            for _ in range(n):
                t0 = time.perf_counter()
                states[name], m = step(states[name], imgs, tr)
                enqueue[name].append(time.perf_counter() - t0)
            return m
        for name in names:
            steps(name, 2)
        enqueue.clear()
        times = collections.defaultdict(list)
        for order in (names, names[::-1], names):
            for name in order:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = steps(name, 5)
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3 / 5)
                require(np.isfinite(float(m["cost"])),
                        f"{label}: {name} bf16 cost not finite")
        ms = {name: statistics.median(v) for name, v in times.items()}
        host = {name: statistics.median(v) * 1e3
                for name, v in enqueue.items()}

        # one step of each traced (CUDA activity only); the sharded step's
        # collectives counted on the host
        calls, busy = [], {}
        real = {k: getattr(dist, k)
                for k in ("all_reduce", "broadcast", "all_gather")}
        for name in names:
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            torch.cuda.synchronize()
            prof.start()
            for k, fn in real.items():
                setattr(dist, k, _counting(calls, k, fn))
            try:
                _, step, imgs, tr = paths[name]
                step(states[name], imgs, tr)
            finally:
                for k, fn in real.items():
                    setattr(dist, k, fn)
            torch.cuda.synchronize()
            prof.stop()
            busy[name] = device_busy(prof, os.path.join(
                tmp, f"dp_{name}_trace.json"))[0] * 1e3
        require(not calls, f"{label}: a step over one rank called "
                f"{len(calls)} collectives ({calls[:5]})")

        # one all-reduce call's host time, the card kept busy meanwhile
        small = torch.ones(1024, device=dev)
        for _ in range(20):
            real["all_reduce"](small, group=mesh.group)
        torch.cuda.synchronize()
        per_call = []
        for _ in range(3):
            torch.cuda._sleep(4 * SPIN)
            t0 = time.perf_counter()
            for _ in range(100):
                real["all_reduce"](small, group=mesh.group)
            per_call.append((time.perf_counter() - t0) * 1e4)
            torch.cuda.synchronize()
        print(f"[{label}] {cfg.name}-{cfg.input_size} bf16 onepass "
              f"B={DP_RATE_BATCH}, 3 samples of 5 steps each in turns "
              f"(ms a step, the host's enqueue of a step beside it): "
              + "; ".join(f"{name} {ms[name]:.2f} (samples "
                          f"{[round(t, 2) for t in times[name]]}, host "
                          f"{host[name]:.2f})" for name in names)
              + f"; sharded - plain {ms['sharded'] - ms['plain']:+.2f} ms; "
              f"device busy a step (trace) plain {busy['plain']:.2f}, "
              f"sharded {busy['sharded']:.2f} ms; collectives a sharded "
              f"step over one rank calls: {len(calls)}; one all-reduce of "
              f"1024 floats alone, host {statistics.median(per_call):.1f} "
              f"us a call (samples {[round(t, 1) for t in per_call]}); on "
              f"{smi}")
        del paths, states
    finally:
        P.shutdown_distributed()
    return launches


def dp_rank(rank, port, out, device):
    """Phase 36 (b), one of two ranks spawned on one card: gloo over CUDA
    tensors, one f32 onepass make_sharded_train_step of yolov3-416 on its
    half of a DP_TWO_BATCH batch from the seeded state. Into
    ``out``/rank<rank>.npz: its metrics, conv_bnstat launches, the
    all-reduces of its step (counted on the host, with their elements) and
    the sha256 of each array of its state; rank 0's arrays themselves
    too."""
    import torch.distributed as dist
    from yolo_tensorflow_tpu_torch import config as C
    from yolo_tensorflow_tpu_torch.models import engine
    from yolo_tensorflow_tpu_torch.ops.kernels import conv_bnstat as BS
    from yolo_tensorflow_tpu_torch.parallel import mesh as P
    from yolo_tensorflow_tpu_torch.train import loop as TL
    torch.backends.cudnn.benchmark = False
    P.init_distributed(f"localhost:{port}", 2, rank, device=device,
                       backend="gloo")
    try:
        mesh = P.make_mesh()
        cfg = C.get_config(MODEL)
        specs = C.build_specs(cfg)
        params, stats = engine.init_params(specs, cfg.input_size, SEED,
                                           obj_bias=OBJ_BIAS)
        tx = _dp_tx()
        state = TL.create_train_state(cfg, tx, device=mesh.device,
                                      params=params, batch_stats=stats,
                                      specs=specs, mesh=mesh)
        step = TL.make_sharded_train_step(cfg, tx, mesh, specs=specs,
                                          bn_stats="onepass")
        imgs, tr = P.shard_batch(mesh, *train_inputs(cfg, DP_TWO_BATCH,
                                                     SEED + 36))
        if mesh.device.type == "cuda":
            torch.cuda.synchronize()
        BS.launches = 0
        calls, real = [], dist.all_reduce
        dist.all_reduce = _counting(calls, "all_reduce", real)
        try:
            state, m = step(state, imgs, tr)
        finally:
            dist.all_reduce = real
        flat = _state_np(state)
        digests = {f"sha256/{k}": hashlib.sha256(
            np.ascontiguousarray(v).tobytes()).hexdigest()
            for k, v in flat.items()}
        np.savez(os.path.join(out, f"rank{rank}.npz"), launches=BS.launches,
                 backend=mesh.backend,
                 all_reduce=np.array([n for _, n in calls], np.int64),
                 **digests, **(flat if rank == 0
                                                      else {}),
                 **{f"metric/{k}": float(v) for k, v in m.items()})
    finally:
        P.shutdown_distributed()


def dp_two_ranks(cfg, specs, n_fused, dev, smi, tmp):
    """Phase 36 (b): two ranks spawned on the one card (``dp_rank``), then
    the one-process step over the whole DP_TWO_BATCH batch on the card,
    and over the same batch with its halves swapped: the distance between
    those two correct float32 evaluations, which sum in other orders, is
    GRAD_FLOOR's floor (at full depth a permuted batch alone moves some
    leaves' gradients past 1e-4 relative L2). Both ranks'
    parameters, running statistics and gradients equal bit for bit; theirs
    against the one-process step: parameters and running statistics within
    DP_LEAF_TOL, metrics within TRAIN_TOL, gradients within GRAD_FLOOR.
    Both ranks call the same all-reduces: one a BN conv forward and one
    backward (onepass), one of the loss's metric sums, one gradient
    bucket."""
    import torch.multiprocessing as mp
    from yolo_tensorflow_tpu_torch.models import engine
    from yolo_tensorflow_tpu_torch.models.specs import Conv
    from yolo_tensorflow_tpu_torch.parallel import mesh as P
    from yolo_tensorflow_tpu_torch.train import loop as TL
    label = "36b data parallel, two ranks on one card"
    out = os.path.join(tmp, "dp_two_ranks")
    os.makedirs(out)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mp.start_processes(dp_rank, args=(P.free_port(), out, str(dev)),
                       nprocs=2, start_method="spawn", join=True)
    spawn_s = time.perf_counter() - t0
    ranks = []
    for r in range(2):
        with np.load(os.path.join(out, f"rank{r}.npz")) as f:
            ranks.append({k: f[k] for k in f.files})
    require(all(int(r["launches"]) == n_fused for r in ranks),
            f"{label}: conv_bnstat launches "
            f"{[int(r['launches']) for r in ranks]}, expected {n_fused} each")
    n_bn = sum(1 for sp in specs if isinstance(sp, Conv) and sp.bn)
    sizes = [r["all_reduce"] for r in ranks]
    require(np.array_equal(sizes[0], sizes[1])
            and len(sizes[0]) == 2 * n_bn + 2,
            f"{label}: all-reduces a step {[len(n) for n in sizes]}, "
            f"expected {2 * n_bn + 2} on each rank (2 x {n_bn} BN convs, "
            f"the metrics, the gradients)")
    keys = [k for k in ranks[0] if k.startswith("sha256/")]
    differ = [k for k in keys if str(ranks[0][k]) != str(ranks[1][k])]
    require(len(keys) > 0 and not differ,
            f"{label}: the ranks differ in {differ[:5]}")
    params, stats = engine.init_params(specs, cfg.input_size, SEED,
                                       obj_bias=OBJ_BIAS)
    imgs, tr = train_inputs(cfg, DP_TWO_BATCH, SEED + 36)

    def one_process(order):
        tx = _dp_tx()
        state = TL.create_train_state(cfg, tx, device=dev, params=params,
                                      batch_stats=stats, specs=specs)
        state, m = TL.make_train_step(cfg, tx, specs=specs,
                                      bn_stats="onepass")(
            state, imgs[order], tr[order])
        return _state_np(state), {k: float(v) for k, v in m.items()}
    half = DP_TWO_BATCH // 2
    rows = np.arange(DP_TWO_BATCH)
    want, m_want = one_process(rows)
    alt, _ = one_process(np.roll(rows, half))
    got = ranks[0]
    for key, v in m_want.items():
        np.testing.assert_allclose(float(got[f"metric/{key}"]), v,
                                   rtol=TRAIN_TOL["rtol"],
                                   err_msg=f"{label}: metric {key}")
    p_err = _hold_state(label, got, want,
                        [k for k in want if k.startswith("params/")],
                        DP_LEAF_TOL)
    s_err = _hold_state(label, got, want,
                        [k for k in want if k.startswith("stats/")],
                        DP_LEAF_TOL)
    g_got, g_want, g_alt = (_momentum_tree(got), _momentum_tree(want),
                             _momentum_tree(alt))
    names = [(k, n) for k in sorted(g_want) for n in sorted(g_want[k])]
    summary = grad_floor_check(label, names, g_got, g_alt, g_want,
                               what=("two ranks", "halves swapped"))
    print(f"[{label}] {cfg.name}-{cfg.input_size} f32 onepass, "
          f"{str(got['backend'])} over CUDA tensors, two ranks spawned on "
          f"{dev} ({spawn_s:.1f} s with their start) of "
          f"{DP_TWO_BATCH // 2} rows each: {n_fused} conv_bnstat launches "
          f"and {len(sizes[0])} all-reduces ({int(sizes[0].sum())} "
          f"elements, the largest {int(sizes[0].max())}) each, "
          f"parameters, running statistics and gradients equal bit "
          f"for bit across the ranks; against one process over the "
          f"{DP_TWO_BATCH} rows: cost {float(got['metric/cost']):.6g} vs "
          f"{m_want['cost']:.6g}, parameters within {p_err:.2g} and running "
          f"stats within {s_err:.2g} of each leaf's max (rtol "
          f"{DP_LEAF_TOL['rtol']}, atol {DP_LEAF_TOL['atol']}); gradients, "
          f"{summary}")


def dp_run_training(dev, smi, tmp):
    """Phase 36 (c): train/runner.run_training over phase 22's files
    (yolov2-416 cfg with random=1, seeded .weights, RUN_SCENES scenes
    through read_fn and the native kernel), bf16 onepass, DP_RUN_STEPS
    steps: once plain and once with a coordinator of one rank (NCCL, the
    sharded step), each from a fresh checkpoint directory. Each launches
    conv_bnstat for every fused conv of every step; their costs agree,
    within TRAIN_TOL (a coordinator of one rank calls no collective: the
    same program)."""
    from yolo_tensorflow_tpu_torch.parallel import mesh as P
    import argparse
    import contextlib
    import io
    from yolo_tensorflow_tpu_torch import config as C
    from yolo_tensorflow_tpu_torch.ops.kernels import conv_bnstat as BS
    from yolo_tensorflow_tpu_torch.train import runner
    label = "36c data parallel, run_training"
    root = os.path.join(tmp, "run_training")
    with open(os.path.join(root, "train.txt")) as f:
        pixels = dict(zip(f.read().split(), scenes(RUN_SCENES,
                                                   SEED + 22)[0]))
    cfg = C.get_config("yolov2")
    n_fused = sum(bnstat_shapes(C.build_specs(cfg), cfg).values())

    def call(name, **kw):
        args = argparse.Namespace(
            model=None, cfg=os.path.join(root, "yolov2.cfg"), names=None,
            list=os.path.join(root, "train.txt"), val_list=None,
            weights=os.path.join(root, "yolov2.weights"),
            partial_weights=False, ckpt_dir=os.path.join(root, name),
            batch_size=None, steps=DP_RUN_STEPS, lr=None, burn_in=None,
            input_size=None, multiscale=False, bf16=True, bn_onepass=True,
            num_data=1, num_spatial=1, cache_images=False,
            save_every=DP_RUN_STEPS, log_every=1, device=str(dev), **kw)
        out = io.StringIO()
        BS.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            state = runner.run_training(args, read_fn=pixels.__getitem__)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = BS.launches
        costs = [float(line.split("cost ")[1].split()[0])
                 for line in out.getvalue().splitlines()
                 if line.startswith("step ")]
        require(int(state.step) == DP_RUN_STEPS == len(costs)
                and launches == n_fused * DP_RUN_STEPS,
                f"{label}: {name}: step {int(state.step)}, costs {costs}, "
                f"conv_bnstat launches {launches} (expected "
                f"{n_fused * DP_RUN_STEPS})")
        return costs, wall, out.getvalue()

    os.environ["YOLO_NATIVE_LOADER"] = "1"
    torch.backends.cudnn.benchmark = False
    try:
        plain, plain_s, _ = call("dp_plain")
        sharded, sharded_s, log = call(
            "dp_sharded", coordinator=f"localhost:{P.free_port()}",
            num_processes=1, process_id=0)
    finally:
        os.environ.pop("YOLO_NATIVE_LOADER", None)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    require(f"distributed: rank 0 of 1 ({backend})" in log,
            f"{label}: the sharded run did not join a {backend} group")
    np.testing.assert_allclose(sharded, plain, rtol=TRAIN_TOL["rtol"],
                               err_msg=f"{label}: costs")
    print(f"[{label}] yolov2-416 from phase 22's cfg and .weights, bf16 "
          f"onepass, {DP_RUN_STEPS} steps each: plain costs {plain} "
          f"({plain_s:.1f} s), with a coordinator of one rank ({backend}) "
          f"{sharded} ({sharded_s:.1f} s); {n_fused * DP_RUN_STEPS} "
          f"conv_bnstat launches each; on {smi}")


def data_parallel_phase(cfg, specs, n_fused, dev, smi, tmp):
    """Phase 36: parallel/mesh.py on the card (``dp_one_card``,
    ``dp_two_ranks``, ``dp_run_training``). Returns the conv_bnstat
    launches of (a)'s sharded step."""
    t0 = time.perf_counter()
    launches = dp_one_card(cfg, specs, n_fused, dev, smi, tmp)
    torch.backends.cudnn.benchmark = False
    dp_two_ranks(cfg, specs, n_fused, dev, smi, tmp)
    dp_run_training(dev, smi, tmp)
    print(f"[36 data parallel] {time.perf_counter() - t0:.1f} s")
    return launches


def shapes_generator(scenes):
    """Phase 37 (a): SHAPES_SCENES hard scenes at 416 and at 160 rendered
    on the card's host (tools.raster, no cv2), every box inside its image
    with positive extent (tests/test_synthetic_task.py's gates)."""
    from yolo_tensorflow_tpu_torch.tools import synthetic_train_demo as SD
    rng = np.random.default_rng(SEED + 37)
    for size in (416, 160):
        t0 = time.perf_counter()
        n_boxes, seen = 0, set()
        for _ in range(scenes):
            img, boxes = SD.make_scene(rng, hard=True, size=size)
            require(img.shape == (size, size, 3) and img.dtype == np.uint8,
                    f"37 (a) scene {img.shape} {img.dtype}")
            cx, cy, w, h, cls = boxes.T
            eps = 1 / size
            require(len(boxes) > 0 and (w > 0).all() and (h > 0).all()
                    and (cx - w / 2 >= -eps).all()
                    and (cy - h / 2 >= -eps).all()
                    and (cx + w / 2 <= 1 + eps).all()
                    and (cy + h / 2 <= 1 + eps).all()
                    and ((cls >= 0) & (cls < len(SD.HARD_CLASSES))).all(),
                    f"37 (a) a box outside its {size} scene or empty: "
                    f"{boxes}")
            n_boxes += len(boxes)
            seen |= set(cls.astype(int).tolist())
        dt = time.perf_counter() - t0
        print(f"[37 shapes] (a) {scenes} hard scenes at {size}: "
              f"{scenes / dt:.1f} scenes/s on the host, {n_boxes} boxes, "
              f"{len(seen)} of 12 classes, every box inside with positive "
              "extent")
    bad = sorted(m for m in sys.modules if m.split(".")[0] == "cv2")
    require(not bad, f"37 (a) the generator loaded {bad}")


def shapes_demo(dev):
    """Phase 37 (b): tools.synthetic_train_demo.main on the easy task as
    the tool trains it (yolov3-tiny from scratch, f32, batch 32), its five
    legs scored; the float mAP@0.5 must reach DEMO_FLOOR. Returns the
    launches of each hand kernel over the run ({wrapper: n}, conv_bnstat
    under "bnstat")."""
    from yolo_tensorflow_tpu_torch.ops.kernels import conv_bnstat as BS
    from yolo_tensorflow_tpu_torch.tools import synthetic_train_demo as SD
    torch.backends.cudnn.benchmark = False      # a user's default
    t0 = time.perf_counter()
    reset_counts()
    BS.launches = 0
    legs = SD.main(DEMO_STEPS, model="yolov3-tiny", device=dev.type)
    torch.cuda.synchronize()
    launched = dict(counts(), bnstat=BS.launches)
    dt = time.perf_counter() - t0
    require(set(legs) == {"float", "flip-TTA[darknet]", "flip-TTA[corrected]",
                          "int8 PTQ", "int8 QAT"}, f"37 (b) legs {legs}")
    require(all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in legs.values()),
            f"37 (b) a leg outside [0, 1]: {legs}")
    require(legs["float"] >= DEMO_FLOOR,
            f"37 (b) the demo's float mAP@0.5 after {DEMO_STEPS} steps is "
            f"{legs['float']:.4f}, under {DEMO_FLOOR}: the port does not "
            "learn the task as the TPU package does")
    for name in ("decode", "nms", "int8", "int8_direct", "bnstat"):
        require(launched[name] > 0, f"37 (b) the demo launched no {name} "
                f"kernel: {launched}")
    print(f"[37 shapes] (b) synthetic_train_demo.main({DEMO_STEPS}, "
          f"yolov3-tiny) easy, f32: "
          + ", ".join(f"{k} {v:.4f}" for k, v in legs.items())
          + f" (floor {DEMO_FLOOR} on the float leg); {dt:.1f} s; hand "
          f"kernel launches {launched}")
    return launched


def shapes_flagship(dev, tmp):
    """Phase 37 (c): tools.flagship_train at yolov3-416 in its own process,
    cut to FLAGSHIP_PLUMBING: the dataset, the interrupted run and its
    resume, the QAT leg, each a fresh CLI process, then the five-leg
    suite."""
    p = FLAGSHIP_PLUMBING
    root = os.path.join(tmp, "flagship")
    t0 = time.perf_counter()
    env = {k: v for k, v in os.environ.items()
           if k not in ("FLAGSHIP_SIZE", "FLAGSHIP_MODEL")}
    proc = subprocess.run(
        [sys.executable, "-m", "yolo_tensorflow_tpu_torch.tools."
         "flagship_train", "--root", root, "--steps", str(p["steps"]),
         "--n-train", str(p["n_train"]), "--n-val", str(p["n_val"]),
         "--qat-steps", str(p["qat_steps"]), "--eval-every",
         str(p["every"]), "--save-every", str(p["every"]), "--device",
         dev.type],
        capture_output=True, text=True, env=env, timeout=900)
    dt = time.perf_counter() - t0
    require(proc.returncode == 0, "37 (c) flagship_train failed: "
            f"{proc.stdout[-3000:]} {proc.stderr[-3000:]}")
    with open(os.path.join(root, "train.log")) as f:
        log = f.read()
    n_cli = log.count("\n$ ")
    resumed = f"resumed from step {p['steps'] // 2}"
    require(n_cli == 3, f"37 (c) {n_cli} CLI processes, expected 3")
    require(resumed in log, f"37 (c) the log lacks '{resumed}'")
    require(os.path.exists(os.path.join(root, "ckpts", "int8-qat.npz")),
            "37 (c) the QAT leg shipped no int8-qat.npz")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    legs = {"float bf16", "flip-TTA[darknet]", "flip-TTA[corrected]",
            "int8 PTQ", "int8 QAT"}
    require(out.get("flagship") == "yolov3-416 hard12"
            and out.get("step") == p["steps"]
            and set(out.get("results", {})) == legs
            and all(0.0 <= v <= 1.0 for v in out["results"].values()),
            f"37 (c) the suite's line: {out}")
    times = re.findall(r"-> exit 0 in (\d+)s", proc.stdout)
    print(f"[37 shapes] (c) flagship_train yolov3-416, {p['n_train']} + "
          f"{p['n_val']} scenes, {p['steps'] // 2} steps then resumed to "
          f"{p['steps']}, {p['qat_steps']} QAT steps: {n_cli} CLI processes "
          f"({', '.join(times)} s), '{resumed}', int8-qat.npz written; "
          f"suite {out['results']} (untrained: plumbing only); {dt:.1f} s")


def shapes_phase(dev, tmp):
    """Phase 37: the synthetic-shapes tools (yolo_tensorflow_tpu_torch/
    tools/). Returns (b)'s hand kernel launches."""
    t0 = time.perf_counter()
    shapes_generator(SHAPES_SCENES)
    launched = shapes_demo(dev)
    shapes_flagship(dev, tmp)
    print(f"[37 shapes] {time.perf_counter() - t0:.1f} s")
    return launched


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(
        description="Drive the PyTorch port's main paths on one GPU.")
    parser.add_argument("--parent", default=None, help=(
        "an earlier checkout (git archive) whose direct int8 kernel and "
        "NMS stage are timed in turns with this one's"))
    parent = parser.parse_args(argv).parent
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
    from yolo_tensorflow_tpu_torch.ops.kernels import direct_probe as DP
    from yolo_tensorflow_tpu_torch.ops.kernels import nms as NK
    from yolo_tensorflow_tpu_torch.pipeline import Detector, normalize_images
    from yolo_tensorflow_tpu_torch.post import nms as NMS

    t_start = time.perf_counter()

    def elapsed(phases):
        print(f"[time] phases {phases} done, "
              f"{time.perf_counter() - t_start:.1f} s into the script",
              flush=True)

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

    # 2. build (the parent's first-conv kernel beside, where --parent gave
    # a checkout)
    t0 = time.perf_counter()
    parent_job = (None if parent is None else DP.start_build(
        "parent", os.path.join(parent, "yolo_tensorflow_tpu_torch", "csrc")))
    parent_nms_job = None if parent is None else parent_nms(parent)
    lib_path = build.build(force=True)
    build_s = time.perf_counter() - t0
    build.load()
    parent_lib = (None if parent_job is None else
                  DP.finish_build(parent_job))
    parent_nms_lib = None if parent is None else parent_nms_job()
    print(f"[2 build] nvcc built {[s.name for s in build.sources()]} -> "
          f"{lib_path.name} in {build_s:.2f} s"
          + ("" if parent is None else
             f"; the parent's conv_int8.cu and nms.cu from {parent} in "
             f"{time.perf_counter() - t0:.2f} s"))

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
        with torch.inference_mode():       # phase 14's ties: bf16 scores
            decoded_bf16 = K.decode_fused(
                det.network(normalize_images(x, cfg, det.network.dtype)),
                cfg, score_dtype=torch.bfloat16)
        step = statistics.median(step_ms)
        float_rate = statistics.median(rates)
        print(f"[5 bf16] detect_batch B={SERVE_BATCH} at {cfg.input_size}, "
              f"images on the card: {float_rate:.1f} img/s median of 3 x 5 "
              f"steps (spread {min(rates):.1f}..{max(rates):.1f}), step "
              f"{step:.2f} ms; backbone {net_ms:.2f} ms, decode "
              f"{dec_ms:.4f} ms, NMS {nms_ms:.4f} ms (device: one kernel), "
              f"the rest "
              f"{step - net_ms - dec_ms - nms_ms:.2f} ms; "
              f"peak memory {peak:.2f} GiB; mean num {out.num.mean():.1f}; "
              f"on {smi}")
        del det

        # 6. int8 conv kernel vs plain, at the shapes the int8 path runs
        convs = {i for i, sp in enumerate(specs) if isinstance(sp, S.Conv)}
        int8_fields, direct_fields = int8_kernel_phase(
            int8_shapes(specs, cfg, convs - Q.head_conv_layers(specs)), dev,
            smi, parent_lib)

        # 7. the int8 main path
        (int8_launches, direct_launches, qparams, calib, int8_rate,
         int8_net_ms) = int8_path_phase(specs, cfg, path, imgs, x, dev,
                                        float_rate, kind)
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
        elapsed("4-10")

        # 11-12. yolov2-416: the region head on its real path; 13. yolov1
        v2_launches, v2_path, v2_decoded = family_phases(
            "yolov2", ("11 yolov2 f32", "12 yolov2 bf16"), dev, kind, smi,
            tmp)
        _, v1_path, v1_decoded = family_phases(
            "yolov1", ("13 yolov1 f32", "13 yolov1 bf16"), dev, kind, smi,
            tmp)
        require(launches == v2_launches == 1, "decode launches per forward: "
                f"yolov3 {launches}, yolov2 {v2_launches}, expected 1 each")

        # 14. the NMS kernel vs plain at the decodes of phases 5, 12 and
        # 13 and odd cases
        nms_fields = nms_kernel_phase({
            f"{MODEL}-{cfg.input_size}": (decoded, CONF),
            f"{MODEL}-{cfg.input_size} bf16 scores": (decoded_bf16, CONF),
            "yolov2-416": v2_decoded, "yolov1-448": v1_decoded}, cfg, dev,
            smi, parent_nms_lib)
        del decoded, decoded_bf16, v2_decoded, v1_decoded
        elapsed("11-14")

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
            qparams, calib, imgs, dev, int8_rate, int8_net_ms, kind, smi,
            parent_lib)
        del calib
        elapsed("15-18")

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
        elapsed("19-22")

        # 23. the int8 kernel at yolov1's 7x7 first conv; int8 yolov1;
        # int8 convs of any geometry
        v1_qparams, _ = int8_k7_phase(dev, kind, smi, v1_path, parent_lib)
        int8_geometry_phase(dev, kind, smi)

        # 24-26. evaluation, the classifier, in-training evaluation
        eval_phase(dev, kind, smi, tmp, v2_path, v1_qparams)
        del v1_qparams
        classifier_phase(dev, kind, smi, tmp)
        torch.backends.cudnn.benchmark = False
        run_training_eval_phase(dev, smi, tmp)
        elapsed("23-26")

        # 27-29. the serving surface: the operators' cost, the torch.export
        # artifacts through the CLI, the HTTP server, the stream
        operators_phase(cfg, path, qparams, dev, smi)
        export_phase(cfg, path, qparams, int8_launches, dev, smi, tmp)
        server_phase(path, qparams, tmp, smi)
        stream_phase(cfg, path, tmp, smi)
        del qparams
        elapsed("27-29")

        # 30. the command line; the random lr policy with no host sync
        cli_phase(dev, kind, smi, tmp, path)
        random_policy_phase(dev, smi)
        elapsed("30")

        # 31-32. darknet's other layers: its full YOLOv1 ([local]) and the
        # other new sections; the char-RNN family and [crnn]
        yolov1_full_phase(dev, kind, smi, tmp)
        charrnn_phase(dev, kind, smi, tmp)
        elapsed("31-32")

        # 33-35. quantization-aware training and serving its int8 export;
        # training darknet's other layers and the char-RNN; the softmax
        # tree and nightmare's dream
        bnstat_launches += qat_phase(cfg, specs, n_fused, dev, kind, smi,
                                     tmp, path)
        elapsed("33")
        layers_train_phase(dev, kind, smi, tmp)
        elapsed("34")
        tree_dream_phase(dev, kind, smi, tmp, path)
        elapsed("35")

        # 36. data parallel: one rank over NCCL, two ranks on the card,
        # run_training with a coordinator
        bnstat_launches += data_parallel_phase(cfg, specs, n_fused, dev, smi,
                                               tmp)
        elapsed("36")

        # 37. the synthetic-shapes tools: scenes without cv2, the demo
        # learns, the flagship recipe's plumbing at yolov3-416
        shapes = shapes_phase(dev, tmp)
        launches += shapes["decode"]
        nms_launches += shapes["nms"]
        int8_launches += shapes["int8"]
        q_launches += shapes["int8_q"]
        direct_launches += shapes["int8_direct"]
        bnstat_launches += shapes["bnstat"]
        elapsed("37")

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
        "name": "conv_int8_direct", "route": "cuda",
        "source": "yolo_tensorflow_tpu_torch/csrc/conv_int8.cu",
        "replaces": "tools/probe_int8_3x3.py:35",
        "launches": direct_launches, **direct_fields}, {
        "name": "conv3x3_bnstat", "route": "cuda",
        "source": "yolo_tensorflow_tpu_torch/csrc/conv_bnstat.cu",
        "replaces": "tools/probe_conv_bnstat.py:47",
        "launches": bnstat_launches, **bnstat_entry}, {
        "name": "greedy_nms", "route": "cuda",
        "source": "yolo_tensorflow_tpu_torch/csrc/nms.cu",
        "replaces": "yolo_tensorflow_tpu/post/nms.py:126",
        "launches": nms_launches, **nms_fields}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
