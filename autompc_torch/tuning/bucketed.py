"""Width-padded MLP candidates (port of ``autompc_tpu/tuning/bucketed.py``:
``_mlp_masks`` and ``_mlp_padded_init``; the bucket evaluators are not
ported yet).

An MLP with hidden widths ``widths`` is embedded in the ``max_width``
net of the same depth: its weights sit in the top-left corner of each
max-width layer, and 0/1 masks multiplied into the weights inside the
forward pass keep every other entry out of the loss, so those entries
get exactly zero gradients and the lane trains as the unpadded net.
"""

from __future__ import annotations

import numpy as np
import torch

from ..sysid.mlp import net_init


def _mlp_masks(nxu, nx, widths, max_width):
    """Per-layer weight and bias masks (numpy 0/1 arrays) embedding an
    MLP with hidden widths ``widths`` inside the max-width net."""
    L = len(widths)
    wmasks, bmasks = [], []
    col = np.zeros(max_width)
    col[: widths[0]] = 1.0
    wmasks.append(np.broadcast_to(col, (nxu, max_width)).copy())
    bmasks.append(col.copy())
    for i in range(1, L):
        row = np.zeros(max_width)
        row[: widths[i - 1]] = 1.0
        col = np.zeros(max_width)
        col[: widths[i]] = 1.0
        wmasks.append(np.outer(row, col))
        bmasks.append(col.copy())
    row = np.zeros(max_width)
    row[: widths[-1]] = 1.0
    wmasks.append(np.broadcast_to(row[:, None], (max_width, nx)).copy())
    bmasks.append(np.ones(nx))
    return wmasks, bmasks


def _mlp_padded_init(seed, nxu, nx, widths, max_width, dtype, device):
    """The initial weights ``MLP`` draws for ``seed`` at the candidate's
    true sizes (``sysid/mlp.py::net_init``), embedded in the max-width
    layout with zeros elsewhere: a list of ``{"W", "b"}`` tensors."""
    sizes = [nxu] + [int(w) for w in widths] + [nx]
    L = len(widths)
    shapes = [(nxu, max_width)] + [(max_width, max_width)] * (L - 1) + [(max_width, nx)]
    padded = []
    for layer, shape in zip(net_init(sizes, seed, dtype, device), shapes):
        W = torch.zeros(shape, dtype=dtype, device=device)
        W[: layer["W"].shape[0], : layer["W"].shape[1]] = layer["W"]
        b = torch.zeros(shape[1], dtype=dtype, device=device)
        b[: layer["b"].shape[0]] = layer["b"]
        padded.append({"W": W, "b": b})
    return padded
