"""Timing helpers (port of ``autompc_tpu/utils/profiling.py``:
``timeit_distinct``)."""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch


def _wait():
    """Wait for the card's queued work (CUDA calls return before the
    device finishes); nothing to wait for on the CPU."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def timeit_distinct(
    fn: Callable,
    inputs,
    warmup: int = 1,
    name: Optional[str] = None,
    silent: bool = False,
):
    """Time ``fn`` over a list of DISTINCT inputs, waiting for the
    device once at the end.

    ``inputs`` is a sequence of argument TUPLES; the first ``warmup`` of
    them run untimed (first-use costs: the kernel build, the allocator's
    pool). A different input per rep keeps any cache between the caller
    and the device from answering a repeated call. Returns
    (mean_seconds, result_of_last_call).
    """
    out = None
    for a in inputs[:warmup]:
        out = fn(*a)
    _wait()
    timed = inputs[warmup:] if warmup else inputs
    start = time.perf_counter()
    for a in timed:
        out = fn(*a)
    _wait()
    mean = (time.perf_counter() - start) / max(1, len(timed))
    if not silent:
        label = name or getattr(fn, "__name__", "fn")
        print(
            f"[timeit-distinct] {label}: {mean * 1e3:.3f} ms/call "
            f"({len(timed)} distinct reps)"
        )
    return mean, out
