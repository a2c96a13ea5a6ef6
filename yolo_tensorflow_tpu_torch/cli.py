"""Command line of the port's serving surface.

Counterpart of the serving subcommands of yolo_tensorflow_tpu/cli.py, on
the card unless ``--device cpu``:

  python -m yolo_tensorflow_tpu_torch detect  --model yolov3 --weights w.weights img...
  python -m yolo_tensorflow_tpu_torch detect  --artifact model.ytt img...
  python -m yolo_tensorflow_tpu_torch convert --model yolov3 --weights w.weights --out params.npz
  python -m yolo_tensorflow_tpu_torch export  --model yolov3 --weights w.weights --out model.ytt
  python -m yolo_tensorflow_tpu_torch serve   --artifact model.ytt < paths.txt
  python -m yolo_tensorflow_tpu_torch serve-http --model yolov3 --weights w.weights --bf16
  python -m yolo_tensorflow_tpu_torch stream  --model yolov3 --weights w.weights --source dir/
  python -m yolo_tensorflow_tpu_torch quantize --model yolov3 --weights w.weights --calib-dir imgs/ --out q.npz

Parameter files (.npz, ``convert`` and ``quantize`` outputs, ``--weights``
inputs) are in the TPU package's layout, so either package reads the
other's. The TPU package's other subcommands (train, eval, classify,
summary, inspect, the darknet weight tools, the rest) are not part of this
command line yet (ROADMAP.md, Queue 1 item 12).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from yolo_tensorflow_tpu_torch.config import MODEL_NAMES


def _add_model_args(p, weights_required=True):
    p.add_argument("--model", choices=MODEL_NAMES,
                   help="registry model (or use --cfg for any darknet cfg)")
    p.add_argument("--cfg", help="arbitrary darknet .cfg file")
    p.add_argument("--names", help="class-names file (one per line, for --cfg)")
    p.add_argument("--data",
                   help="darknet .data key-value file (read_data_cfg, "
                        "src/option_list.c:7): names/labels; explicit flags "
                        "override its keys")
    p.add_argument("--weights", required=weights_required,
                   help="darknet .weights file (or .npz parameters)")
    p.add_argument("--conf-threshold", type=float, default=None)
    p.add_argument("--iou-threshold", type=float, default=None)
    p.add_argument("--max-detections", type=int, default=None)
    p.add_argument("--input-size", type=int, default=None)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (serving mode)")
    p.add_argument("--letterbox", action="store_true",
                   help="aspect-preserving letterbox preprocessing "
                        "(darknet's test path) instead of stretch resize")
    p.add_argument("--fused-letterbox", action="store_true",
                   help="with --letterbox: run the resize/pad/box-unmap "
                        "on the device (ops/preprocess.py)")
    _add_device_arg(p)


def _add_device_arg(p):
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the model runs (default: the card)")


def _load_npz_params(path):
    """A flat 'layer/field' .npz (the TPU package's layout) -> the port's
    params."""
    from yolo_tensorflow_tpu_torch.io.weights import params_from_jax
    with np.load(path) as z:
        params = {}
        for k in z.files:
            layer, field = k.rsplit("/", 1)
            params.setdefault(layer, {})[field] = z[k]
    return params_from_jax(params)


def _model(args):
    """(cfg, specs) from --cfg or --model (with --input-size, --names)."""
    import dataclasses
    from yolo_tensorflow_tpu_torch import config as C
    if getattr(args, "cfg", None):
        cfg, specs = C.config_from_cfg(
            args.cfg, class_names_file=getattr(args, "names", None))
        if args.input_size:
            if cfg.head == 1:
                raise SystemExit("--input-size cannot override a v1 (FC-head)"
                                 " cfg: the dense layer fixes the input size")
            cfg = dataclasses.replace(cfg, input_size=args.input_size)
        return cfg, specs
    if not args.model:
        raise SystemExit("need --model or --cfg")
    over = {}
    if args.input_size:
        over["input_size"] = args.input_size
    if getattr(args, "names", None):
        # a names/labels file (flag or .data key) renames the registry
        # model's classes, like the C's per-command name_list reads
        # (examples/detector.c:565 option_find_str "names")
        with open(args.names) as f:
            over["custom_classes"] = tuple(
                line.strip() for line in f if line.strip())
    cfg = C.get_config(args.model, **over)
    return cfg, C.build_specs(cfg)


def _folded_params(args, cfg, specs):
    """The folded params of --weights (.weights or .npz), port layout."""
    if args.weights.endswith(".npz"):
        return _load_npz_params(args.weights)
    from yolo_tensorflow_tpu_torch.io import weights as W
    params, _ = W.load_darknet_weights(specs, cfg.input_size, args.weights)
    return params


def _build_detector(args):
    import torch
    from yolo_tensorflow_tpu_torch.pipeline import Detector
    nms = {k: getattr(args, k) for k in
           ("conf_threshold", "iou_threshold", "max_detections")
           if getattr(args, k) is not None}
    cfg, specs = _model(args)
    return Detector(cfg, params=_folded_params(args, cfg, specs), specs=specs,
                    device=args.device,
                    compute_dtype=torch.bfloat16 if args.bf16 else None,
                    letterbox=getattr(args, "letterbox", False),
                    fused=getattr(args, "fused_letterbox", False), **nms)


def cmd_detect(args):
    import cv2
    if args.artifact:
        # model-knowledge-free path (the object_detect.py consumer app,
        # YOLO_V1/.../object_detect.py:256)
        from yolo_tensorflow_tpu_torch.export import ArtifactDetector
        det = ArtifactDetector(args.artifact)
    elif args.weights or args.cfg or args.model:
        det = _build_detector(args)
    else:
        raise SystemExit("need --artifact, or --model/--cfg with --weights")
    os.makedirs(args.out_dir, exist_ok=True)
    for path in args.images:
        t0 = time.time()
        results = det.detect_from_file(path)
        dt = time.time() - t0
        print(f"{path}: {len(results)} objects in {dt*1e3:.1f} ms")
        img = cv2.imread(path)
        for r in results:
            x0, y0, x1, y1 = (int(v) for v in r["box"])
            print(f"  {r['class']:<14s} {r['score']:.3f} "
                  f"[{x0}, {y0}, {x1}, {y1}]")
            cv2.rectangle(img, (x0, y0), (x1, y1), (0, 255, 0), 2)
            cv2.putText(img, f"{r['class']} {r['score']:.2f}",
                        (x0, max(y0 - 6, 12)), cv2.FONT_HERSHEY_SIMPLEX,
                        0.5, (0, 255, 0), 1)
        out = os.path.join(args.out_dir,
                           "detected_" + os.path.basename(path))
        cv2.imwrite(out, img)
        if args.boxes_txt:
            from yolo_tensorflow_tpu_torch.utils.drawing import (
                write_boxes_txt)
            write_boxes_txt(args.boxes_txt, results)


def cmd_convert(args):
    from yolo_tensorflow_tpu_torch.io.checkpoint import save_params_npz
    cfg, specs = _model(args)
    params = _folded_params(args, cfg, specs)
    save_params_npz(params, args.out)
    print(f"wrote {args.out} "
          f"({sum(np.asarray(v).size for d in params.values() for v in d.values())} params)")


def cmd_export(args):
    from yolo_tensorflow_tpu_torch.export import export_detector
    det = _build_detector(args)
    export_detector(det, args.out, batch_size=args.batch,
                    canvas_size=getattr(args, "canvas_size", 0))
    print(f"wrote {args.out}")


def cmd_serve(args):
    """Artifact serving loop, the standalone frozen-artifact app the
    reference ships as object_detect.py (P3/P12/P22): consume a serialized
    model by its named outputs only, no model code. Paths come from stdin
    (one per line) or a watched directory; one JSON line out per image."""
    from yolo_tensorflow_tpu_torch.export import ArtifactDetector
    det = ArtifactDetector(args.artifact)
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)

    def handle(path):
        try:
            t0 = time.time()
            results = det.detect_from_file(path)
            dt = (time.time() - t0) * 1e3
        except (FileNotFoundError, OSError) as e:
            print(json.dumps({"image": path, "error": str(e)}), flush=True)
            return
        print(json.dumps({"image": path, "ms": round(dt, 1),
                          "detections": results}), flush=True)
        if args.out_dir:
            import cv2
            from yolo_tensorflow_tpu_torch.utils.drawing import (
                draw_detections)
            img = cv2.imread(path)
            draw_detections(img, results)
            cv2.imwrite(os.path.join(args.out_dir,
                                     "detected_" + os.path.basename(path)),
                        img)

    if args.watch:
        exts = (".jpg", ".jpeg", ".png", ".bmp")
        # keyed on (path -> mtime): a re-written image is re-processed, and
        # entries whose files vanished are dropped each poll so the map
        # stays bounded by the directory contents
        seen = {}
        while True:
            names = sorted(os.listdir(args.watch))
            live = set()
            for name in names:
                if not name.lower().endswith(exts):
                    continue
                p = os.path.join(args.watch, name)
                try:
                    mtime = os.stat(p).st_mtime_ns
                except OSError:
                    continue   # raced with a delete
                live.add(p)
                if seen.get(p) == mtime:
                    continue
                seen[p] = mtime
                handle(p)
            for p in list(seen):
                if p not in live:
                    del seen[p]
            if args.once:
                break
            time.sleep(args.poll_interval)
    else:
        for line in sys.stdin:
            path = line.strip()
            if path:
                handle(path)


def cmd_stream(args):
    from yolo_tensorflow_tpu_torch.serving import stream_detect
    det = _build_detector(args)
    on_batch = None
    if args.save_dir or args.display:
        # src/demo.c:185 behavior: draw detections (+FPS overlay) on each
        # frame and display/save it
        import cv2
        from yolo_tensorflow_tpu_torch.utils.drawing import draw_detections
        if args.save_dir:
            os.makedirs(args.save_dir, exist_ok=True)
        state = {"n": 0, "t": time.perf_counter()}

        def on_batch(dets, images):
            now = time.perf_counter()
            fps = images.shape[0] / max(now - state["t"], 1e-6)
            state["t"] = now
            s = images.shape[1]
            for b in range(images.shape[0]):
                frame = cv2.cvtColor(images[b], cv2.COLOR_RGB2BGR)
                results = [{
                    "class_id": int(dets.classes[b, i]),
                    "class": det.cfg.classes[int(dets.classes[b, i])],
                    "score": float(dets.scores[b, i]),
                    "box": tuple(float(v) * s for v in dets.boxes[b, i]),
                } for i in range(int(dets.num[b]))]
                draw_detections(frame, results,
                                num_classes=det.cfg.num_classes)
                cv2.putText(frame, f"FPS {fps:.1f}", (8, 22),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.7, (0, 255, 255), 2)
                if args.save_dir:
                    cv2.imwrite(os.path.join(
                        args.save_dir, f"frame_{state['n']:06d}.jpg"), frame)
                if args.display:
                    cv2.imshow("yolo_tensorflow_tpu_torch", frame)
                    cv2.waitKey(1)
                state["n"] += 1

    frames, dt, fps = stream_detect(
        det, args.source, batch_size=args.batch, loops=args.loops,
        max_batches=args.max_batches, on_batch=on_batch,
        avg_frames=args.avg_frames,
        read_fn=np.load if args.npy_frames else None)
    print(f"{frames} frames in {dt:.2f}s -> {fps:.1f} FPS "
          f"(batch {args.batch})")


def cmd_quantize(args):
    """Post-training int8 quantization: calibrate activation ranges on a
    directory of images (on --device), emit a quantized .npz the detect,
    stream and serve commands load as they load float parameters."""
    import glob
    import cv2
    import torch
    from yolo_tensorflow_tpu_torch import config as C
    from yolo_tensorflow_tpu_torch.io.checkpoint import save_params_npz
    from yolo_tensorflow_tpu_torch.ops import quant as Q
    cfg = C.get_config(args.model, **({"input_size": args.input_size}
                                      if args.input_size else {}))
    specs = C.build_specs(cfg)
    params = _folded_params(args, cfg, specs)
    paths = sorted(glob.glob(os.path.join(args.calib_dir, "*")))[
        :args.calib_images]
    if not paths:
        raise SystemExit(f"no calibration images in {args.calib_dir}")
    batches = []
    for pth in paths:
        img = cv2.imread(pth)
        if img is None:
            continue
        img = cv2.cvtColor(cv2.resize(img, (cfg.input_size, cfg.input_size)),
                           cv2.COLOR_BGR2RGB)
        batches.append(img[None])
    scales = Q.calibrate_activations(specs, params, batches, cfg=cfg,
                                     device=torch.device(args.device))
    qparams = Q.quantize_params(specs, params, scales)
    save_params_npz(qparams, args.out)
    n_q = sum(1 for v in qparams.values() if "w_q" in v)
    print(f"wrote {args.out}: {n_q} int8 convs, "
          f"{len(qparams) - n_q} full-precision layers, "
          f"calibrated on {len(batches)} images")


def decode_npy(body: bytes):
    """A request body holding a .npy array: RGB uint8 (H, W, 3)."""
    import io
    img = np.load(io.BytesIO(body), allow_pickle=False)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"a .npy body must be uint8 (H, W, 3), not "
                         f"{img.dtype} {img.shape}")
    return img


def cmd_serve_http(args):
    """HTTP detection server with dynamic micro-batching (server.py):
    concurrent POST /detect requests coalesce into fixed-shape device
    batches on the fused-letterbox path (any input size, boxes back in
    original pixels)."""
    from yolo_tensorflow_tpu_torch.server import serve_http
    args.letterbox = True
    args.fused_letterbox = True
    det = _build_detector(args)
    serve_http(det, host=args.host, port=args.port,
               batch_size=args.batch, max_wait_ms=args.max_wait_ms,
               max_canvas=args.max_canvas,
               max_body_bytes=args.max_body_mb << 20,
               queue_depth=args.queue_depth,
               model_name=args.model or args.cfg or "model",
               decode_fn=decode_npy if args.body == "npy" else None)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="yolo_tensorflow_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("detect", help="detect objects in images")
    _add_model_args(p, weights_required=False)
    p.add_argument("images", nargs="+")
    p.add_argument("--artifact", default=None,
                   help="exported .ytt artifact: detect with zero model "
                        "knowledge (the frozen-pb consumer path)")
    p.add_argument("--out-dir", default="out")
    p.add_argument("--boxes-txt", default=None,
                   help="append class,x0,y0,x1,y1,score lines (boxes.txt "
                        "format of YOLO_V1_Inference.py:418)")
    p.set_defaults(fn=cmd_detect)

    p = sub.add_parser("serve",
                       help="serve an exported artifact: read image paths "
                            "from stdin (or --watch a directory), print one "
                            "JSON line of detections per image")
    p.add_argument("--artifact", required=True)
    p.add_argument("--watch", default=None,
                   help="poll this directory for new images instead of stdin")
    p.add_argument("--out-dir", default=None,
                   help="also write annotated copies here")
    p.add_argument("--poll-interval", type=float, default=0.5)
    p.add_argument("--once", action="store_true",
                   help="with --watch: process current contents and exit")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("convert", help=".weights -> folded .npz parameters")
    _add_model_args(p)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser("export", help="serialize an inference artifact "
                                      "(torch.export) on --device")
    _add_model_args(p)
    p.add_argument("--out", required=True)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--canvas-size", type=int, default=0,
                   help="with --letterbox --fused-letterbox: canvas side "
                        "of the arbitrary-input-size artifact (default "
                        "2x model input)")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("stream", help="streaming demo (video/camera/dir)")
    _add_model_args(p)
    p.add_argument("--source", required=True,
                   help="video file, camera index, or image directory")
    p.add_argument("--npy-frames", action="store_true",
                   help="the directory holds .npy RGB uint8 frames (read "
                        "with np.load; no cv2 needed at the input size)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--loops", type=int, default=1)
    p.add_argument("--max-batches", type=int, default=0)
    p.add_argument("--avg-frames", type=int, default=0,
                   help="rolling prediction average over N frames "
                        "(demo.c demo_frame=3 smoothing; 0 = off)")
    p.add_argument("--save-dir", default=None,
                   help="write annotated frames here (demo.c drawing)")
    p.add_argument("--display", action="store_true",
                   help="show annotated frames in a window (needs a GUI)")
    p.set_defaults(fn=cmd_stream)

    p = sub.add_parser("quantize", help="post-training int8 quantization")
    p.add_argument("--model", required=True, choices=MODEL_NAMES)
    p.add_argument("--weights", required=True)
    p.add_argument("--calib-dir", required=True,
                   help="directory of calibration images")
    p.add_argument("--calib-images", type=int, default=64)
    p.add_argument("--input-size", type=int, default=None)
    p.add_argument("--out", required=True)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_quantize)

    p = sub.add_parser("serve-http",
                       help="HTTP detection server with dynamic "
                            "micro-batching (POST /detect, GET /healthz, "
                            "GET /stats)")
    _add_model_args(p)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--batch", type=int, default=8,
                   help="batch size requests coalesce into")
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="batching window after the first request")
    p.add_argument("--max-canvas", type=int, default=1024,
                   help="largest on-device canvas bucket; bigger images "
                        "are host-downscaled first")
    p.add_argument("--max-body-mb", type=int, default=32,
                   help="per-request POST body cap in MiB (413 beyond it) "
                        "— bounds host memory per request")
    p.add_argument("--queue-depth", type=int, default=64,
                   help="max requests waiting for a batch slot; beyond it "
                        "requests are shed immediately with 503 + "
                        "Retry-After")
    p.add_argument("--body", choices=("image", "npy"), default="image",
                   help="what a POST body holds: an encoded image (cv2 "
                        "decodes it) or a .npy RGB uint8 array (no cv2)")
    p.set_defaults(fn=cmd_serve_http)

    args = ap.parse_args(argv)
    if getattr(args, "data", None):
        from yolo_tensorflow_tpu_torch.io.datacfg import apply_data_cfg
        apply_data_cfg(args, args.fn.__name__.replace("cmd_", ""))
    return args.fn(args)


if __name__ == "__main__":
    main()
