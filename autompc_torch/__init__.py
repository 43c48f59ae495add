"""autompc_torch: the PyTorch + CUDA port of ``autompc_tpu``.

The JAX package ``autompc_tpu`` is the reference; this package mirrors
its file layout module for module (``autompc_torch/x/y.py`` <->
``autompc_tpu/x/y.py``). Plain tensor code is PyTorch; every Pallas
TPU kernel on the ported path is a CUDA C++ kernel written by hand for
Hopper (``csrc/``), built at first use by ``ops/_build.py``.

Numeric policy, kept in this one place:

* float64 on the CPU (the parity tests against the JAX package, which
  run it under x64) and float32 on CUDA (the kernels' working type);
* TF32 off for every float32 matmul and convolution on the card — a
  reduced-precision product drifts the Riccati recursion and the
  knife-edge line-search acceptance (ROADMAP §C).

Importing this package never imports ``jax`` or ``autompc_tpu``.
"""

import torch

from .core import System, Task, TimeStep, Trajectory, TrajectoryBatch, batch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"


def default_dtype(device) -> torch.dtype:
    """The compute dtype for ``device``: float64 on the CPU, float32
    on CUDA."""
    return torch.float64 if torch.device(device).type == "cpu" else torch.float32


__all__ = [
    "System",
    "Task",
    "TimeStep",
    "Trajectory",
    "TrajectoryBatch",
    "batch",
    "default_dtype",
]
