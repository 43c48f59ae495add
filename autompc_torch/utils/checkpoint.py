"""Checkpoint / resume (port of ``autompc_tpu/utils/checkpoint.py``).

Payloads are pickled atomically (a temporary file, then a rename), every
tensor converted to a host numpy array first. The batched BO tuner's
whole state (encoded history, costs, configurations) is saved after
every batch, so ``PipelineTuner.run(checkpoint_path=...)`` resumes where
a killed run stopped. The model save/restore helpers of the JAX
module are not ported yet.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from typing import Any, Dict

import numpy as np
import torch


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def save_checkpoint(path: str, payload: Dict[str, Any]):
    """Atomic pickle write (write temp + rename)."""
    payload = _to_numpy(payload)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(payload, f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_checkpoint(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return pickle.load(f)


def bo_state_dict(bo) -> Dict[str, Any]:
    return {
        "kind": "bo_state",
        "X": [np.asarray(x) for x in bo._X],
        "y": list(bo._y),
        "cfg_dicts": [c.get_dictionary() for c in bo._cfgs],
        "default_proposed": bo._default_proposed,
    }


def bo_load_state(bo, state: Dict[str, Any]):
    if state.get("kind") != "bo_state":
        raise ValueError("Not a BO state checkpoint")
    bo._X = [np.asarray(x) for x in state["X"]]
    bo._y = list(state["y"])
    bo._cfgs = [bo.space.configuration_from_dict(d) for d in state["cfg_dicts"]]
    bo._default_proposed = bool(state["default_proposed"])
    return bo
