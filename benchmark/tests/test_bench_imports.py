"""What a run loads: nothing of JAX or of the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's, so a prefix test would be wrong); and the reference alone loads
nothing of the port. Each check runs in a fresh interpreter."""

import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
BANNED = {"jax", "jaxlib", "flax", "yolo_tensorflow_tpu"}

RUN = f"""
import json, sys
sys.path.insert(0, {str(HERE)!r}); sys.path.append({str(ROOT)!r})
import run as R
reg = R.Registry()
for w in reg.spec["workloads"]:
    reg.config(w["config"]); reg.limits(w["name"])
    reg.driver(reg.traffic(w["traffic"])["kind"])
for m in reg.spec["per_layer"]:
    reg.reader(m["name"])
import calibrate, compare, counts, trace
from yolo_tensorflow_tpu_torch import config
from yolo_tensorflow_tpu_torch.io import weights
from yolo_tensorflow_tpu_torch.ops import quant
from yolo_tensorflow_tpu_torch.pipeline import Detector
from yolo_tensorflow_tpu_torch.post import nms
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = f"""
import json, sys
sys.path.insert(0, {str(HERE)!r})
from reference import detect, model
import compare, counts, weights
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax():
    names = top_level(RUN)
    assert "yolo_tensorflow_tpu_torch" in names
    assert not names & BANNED, names & BANNED


def test_reference_loads_nothing_of_the_port():
    names = top_level(REFERENCE)
    assert not names & (BANNED | {"yolo_tensorflow_tpu_torch"})
