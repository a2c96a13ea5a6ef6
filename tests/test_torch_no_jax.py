"""The PyTorch port imports neither jax (absent where the port runs), nor
anything of the JAX package yolo_tensorflow_tpu (not even its framework-free
modules: the port keeps its own copies), nor triton (not one of its routes),
at import of any of its modules; and chip_smoke.py names none of them in an
import. QAT, the softmax tree, dream and the training tools import no cv2
either, on import or when they run (the card's machine has none)."""

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
                 "post.numpy_post", "serving", "server", "export", "cli",
                 "__main__", "utils.drawing", "ops.kernels.library",
                 "utils.profiling", "utils.summary", "io.netops",
                 "utils.netviz", "train.threefry", "ops.recurrent",
                 "textgen", "ops.qat", "models.tree", "dream",
                 "parallel.mesh", "tools.raster",
                 "tools.synthetic_train_demo", "tools.flagship_train",
                 "tools.transfer_pretrain", "tools.flagship_probe"):
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


def test_qat_tree_and_dream_need_no_cv2():
    """Importing ops.qat, models.tree and dream, and running a dream with
    octaves, flips, rotation and zoom and a reconstruct, loads no cv2."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from yolo_tensorflow_tpu_torch.ops import qat\n"
        "from yolo_tensorflow_tpu_torch.models import tree\n"
        "from yolo_tensorflow_tpu_torch import dream as D\n"
        "from yolo_tensorflow_tpu_torch import config as C\n"
        "from yolo_tensorflow_tpu_torch.io import weights as W\n"
        "from yolo_tensorflow_tpu_torch.models import engine\n"
        "assert 'cv2' not in sys.modules\n"
        "cfg = C.get_config('yolov3-tiny', input_size=64)\n"
        "specs = C.build_specs(cfg)\n"
        "params = W.fold_params(*engine.init_params(specs, 64, 0), 1e-5)\n"
        "img = np.random.default_rng(3).integers(0, 256, (50, 40, 3),"
        " dtype=np.uint8)\n"
        "D.dream(cfg, specs, params, img, 4, iters=2, octaves=2, rotate=9.0,"
        " zoom=0.9, device='cpu')\n"
        "D.reconstruct(cfg, specs, params, img, 4, iters=1, device='cpu')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] == 'cv2')\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_training_tools_need_no_cv2():
    """Importing the four tools modules, and drawing every primitive and
    hard and easy scenes at 160 and 416 (clutter, all 12 classes) and a
    classifier crop, loads no cv2; with cv2 made unimportable they run
    the same."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from yolo_tensorflow_tpu_torch.tools import raster as R\n"
        "from yolo_tensorflow_tpu_torch.tools import synthetic_train_demo"
        " as P\n"
        "from yolo_tensorflow_tpu_torch.tools import flagship_train\n"
        "from yolo_tensorflow_tpu_torch.tools import transfer_pretrain as T\n"
        "assert sys.modules.get('cv2') is None\n"
        "img = np.zeros((64, 64, 3), np.uint8)\n"
        "R.line(img, (1, 2), (60, 40), (9, 9, 9), 1)\n"
        "R.line(img, (1, 2), (60, 40), (9, 9, 9), 5)\n"
        "R.circle(img, (30, 30), 9, (9, 9, 9), -1)\n"
        "R.circle(img, (30, 30), 20, (9, 9, 9), 4)\n"
        "R.rectangle(img, (3, 3), (9, 12), (9, 9, 9), -1)\n"
        "R.fill_poly(img, [P._poly(30, 30, 20, 5, 0.3)], (9, 9, 9))\n"
        "R.ellipse(img, (30, 30), (20, 9), 0, 0, 360, (9, 9, 9), -1)\n"
        "R.ellipse(img, (30, 30), (20, 20), 90, 0, 180, (9, 9, 9), -1)\n"
        "rng = np.random.default_rng(0)\n"
        "seen = set()\n"
        "for size in (160, 416):\n"
        "    for _ in range(40):\n"
        "        _, b = P.make_scene(rng, hard=True, size=size)\n"
        "        seen |= set(b[:, 4].astype(int))\n"
        "    P.make_batch(rng, 2, size=size)\n"
        "assert seen == set(range(12)), seen\n"
        "next(T.scene_crops(rng, 1))\n"
        "bad = sorted(m for m, v in sys.modules.items()\n"
        "             if m.split('.')[0] == 'cv2' and v is not None)\n"
        "assert not bad, bad\n")
    for block in (False, True):
        pre = "import sys\nsys.modules['cv2'] = None\n" if block else ""
        proc = subprocess.run([sys.executable, "-c", pre + code], cwd=REPO,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
