"""autompc_torch: the PyTorch + CUDA port of ``autompc_tpu``.

The JAX package ``autompc_tpu`` is the reference; this package mirrors
its file layout module for module (``autompc_torch/x/y.py`` <->
``autompc_tpu/x/y.py``). Plain tensor code is PyTorch; every Pallas
TPU kernel on the ported path is a CUDA C++ kernel written by hand for
Hopper (``csrc/``), built at first use by ``ops/_build.py``.

Numeric policy, kept in this one place:

* float64 on the CPU (the parity tests against the JAX package, which
  run it under x64) and float32 on CUDA (the kernels' working type);
* entry points that create tensors (data generation, the models) run on
  the card unless the caller passes ``device`` (``resolve_device``);
  the solvers run where their input tensors lie;
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


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card (``cuda:0``) unless
    the caller names one. Raises when no device is named and there is
    no card — nothing falls back to the CPU unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda", 0)


__all__ = [
    "System",
    "Task",
    "TimeStep",
    "Trajectory",
    "TrajectoryBatch",
    "batch",
    "default_dtype",
    "resolve_device",
]
