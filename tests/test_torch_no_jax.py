"""The PyTorch port imports neither jax (absent where the port runs), nor
anything of the JAX package yolo_tensorflow_tpu (not even its framework-free
modules: the port keeps its own copies), nor triton (not one of its routes),
at import of any of its modules; and chip_smoke.py names none of them in an
import."""

import ast
import os
import pkgutil
import subprocess
import sys

import yolo_tensorflow_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "triton", "yolo_tensorflow_tpu")


def test_port_imports_no_jax_and_no_triton():
    modules = [m.name for m in pkgutil.walk_packages(
        yolo_tensorflow_tpu_torch.__path__, "yolo_tensorflow_tpu_torch.")]
    assert "yolo_tensorflow_tpu_torch.pipeline" in modules
    assert "yolo_tensorflow_tpu_torch.ops.quant" in modules
    for name in ("train.loop", "train.losses", "ops.kernels.conv_bnstat",
                 "ops.preprocess", "ops.kernels.nms", "train.runner",
                 "io.cfg", "io.datacfg", "io.checkpoint", "data.datasets",
                 "data.augment", "data.native", "data.loader",
                 "eval.batched", "eval.map", "eval.classify",
                 "post.numpy_post"):
        assert f"yolo_tensorflow_tpu_torch.{name}" in modules
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_imports_no_jax_package():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "yolo_tensorflow_tpu_torch.pipeline" in names
    bad = [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad
