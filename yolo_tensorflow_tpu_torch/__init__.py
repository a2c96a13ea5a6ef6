"""yolo_tensorflow_tpu_torch: the PyTorch/CUDA port of yolo_tensorflow_tpu.

The JAX package beside it stays the reference. This package imports torch
and nothing of the JAX package, not even its framework-free modules: it
keeps its own copies of what it needs (config, layer specs, model zoo,
labels). Module names mirror the JAX package's so each counterpart is easy
to find. The Pallas TPU kernels become hand-written CUDA kernels
(``csrc/``), built with nvcc at first use.
"""

__version__ = "0.1.0"

from yolo_tensorflow_tpu_torch.config import MODEL_NAMES, ModelConfig, get_config

__all__ = ["ModelConfig", "get_config", "MODEL_NAMES", "__version__"]
