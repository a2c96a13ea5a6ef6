"""The PyTorch port imports neither jax (absent where the port runs) nor
triton (not one of its routes), at import of any of its modules."""

import os
import pkgutil
import subprocess
import sys

import yolo_tensorflow_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax_and_no_triton():
    modules = [m.name for m in pkgutil.walk_packages(
        yolo_tensorflow_tpu_torch.__path__, "yolo_tensorflow_tpu_torch.")]
    assert "yolo_tensorflow_tpu_torch.pipeline" in modules
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'triton'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
