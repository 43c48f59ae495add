"""autompc_torch/core/trajectory.py::zeros against the JAX package's
zeros: the same all-zero trajectory, on the device the caller names, in
that device's working type; with no device named and no card it raises,
as every entry point of the port does, instead of running on the CPU."""

import numpy as np
import pytest
import torch

from autompc_torch.benchmarks import CartpoleSwingupBenchmark as TCartpole
from autompc_torch.core.trajectory import zeros
from autompc_tpu.benchmarks import CartpoleSwingupBenchmark
from autompc_tpu.core.trajectory import zeros as jzeros

# The tensors here are small: one intra-op thread (six test workers with a
# thread pool each oversubscribe the cores).
torch.set_num_threads(1)


def test_zeros_on_the_named_device_matches_the_reference():
    system = TCartpole().system
    t = zeros(system, 5, device="cpu")
    ref = jzeros(CartpoleSwingupBenchmark().system, 5)
    for got, want in ((t.obs, ref.obs), (t.ctrls, ref.ctrls)):
        assert got.device.type == "cpu" and got.dtype == torch.float64
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert zeros(system, 2, dtype=torch.float32, device="cpu").obs.dtype == torch.float32


def test_zeros_without_a_device_and_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    system = TCartpole().system
    with pytest.raises(RuntimeError, match="no CUDA device"):
        zeros(system, 3)
