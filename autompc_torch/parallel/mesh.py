"""Batch helpers of the fan-out (port of ``autompc_tpu/parallel/mesh.py``).

Only ``pad_to_multiple`` is ported: the device mesh and the sharded
``vmap`` of the JAX package belong to the multi-card slice
(ROADMAP.md §A).
"""

from __future__ import annotations

import torch


def pad_to_multiple(batch, multiple: int, axis: int = 0):
    """Pad every tensor of ``batch`` (a tensor, or a dict / list / tuple
    of them) along ``axis`` up to a multiple of ``multiple`` by repeating
    its last entry (``mode="edge"``: a padded lane is a copy of a real
    one, so a padded cost row never holds a zero that a solver would
    divide by). Returns ``(padded, original_size)``."""

    def leaves(b):
        if isinstance(b, dict):
            return [t for v in b.values() for t in leaves(v)]
        if isinstance(b, (list, tuple)):
            return [t for v in b for t in leaves(v)]
        return [b]

    n = leaves(batch)[0].shape[axis]
    target = -(-n // multiple) * multiple
    if target == n:
        return batch, n

    def pad(x):
        if isinstance(x, dict):
            return {k: pad(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(pad(v) for v in x)
        last = x.narrow(axis, n - 1, 1)
        reps = [1] * x.ndim
        reps[axis] = target - n
        return torch.cat([x, last.repeat(reps)], dim=axis)

    return pad(batch), n
