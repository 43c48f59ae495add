"""The port imports without JAX, chip_smoke.py refuses to run without a
CUDA device, and the kernel build is configured for sm_90a without fast
math."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

PORT_MODULES = [
    "autompc_torch",
    "autompc_torch.benchmarks",
    "autompc_torch.control",
    "autompc_torch.control.ilqr",
    "autompc_torch.control.receding",
    "autompc_torch.costs",
    "autompc_torch.ops._build",
    "autompc_torch.ops.cuda_linesearch",
    "autompc_torch.ops.cuda_relin",
    "autompc_torch.ops.cuda_riccati",
    "autompc_torch.ops.lstsq",
    "autompc_torch.sysid",
]


def _run(code):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, cwd=str(ROOT), timeout=300,
    )


def test_port_imports_without_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('autompc_tpu') or m.startswith('jaxlib'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_chip_smoke_imports_without_jax():
    proc = _run(
        "import sys, chip_smoke\n"
        "assert 'jax' not in sys.modules and 'autompc_tpu' not in sys.modules\n"
    )
    assert proc.returncode == 0, proc.stderr


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_device_check_raises_without_cuda(monkeypatch):
    cs = _load_chip_smoke()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        cs.check_device()


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    """Copied into an empty directory the script fails and prints no
    result line."""
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], capture_output=True, text=True,
        cwd=str(tmp_path), timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_build_flags_target_sm90a_without_fast_math():
    from autompc_torch.ops import _build

    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    names = {p.name for p in _build.sources()}
    assert {"relin.cu", "riccati_quad.cu", "linesearch_fused.cu", "features.cuh"} <= names
    for p in _build.sources():
        src = p.read_text()
        assert "__sinf" not in src and "__cosf" not in src and "__expf" not in src
    assert _build.library_path().parent == _build.BUILD_DIR


def test_build_digest_follows_sources(tmp_path, monkeypatch):
    from autompc_torch.ops import _build

    for p in _build.sources():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    before = _build.source_digest()
    (tmp_path / "relin.cu").write_text((tmp_path / "relin.cu").read_text() + "\n// edit\n")
    assert _build.source_digest() != before


def test_feat_table_mirrors_descriptors():
    from autompc_torch.ops import _build
    from autompc_torch.sysid.basis import FeatureLibrary

    lib = FeatureLibrary.from_config(5, trig_basis=True, trig_interaction=True)
    terms = tuple(lib.terms[k] for k in (0, 4, 5, 8, 35))
    tab = _build.feat_table(terms)
    assert (tab.n, tab.d) == (5, 5)
    for k, t in enumerate(terms):
        assert list(tab.exps[k])[:5] == list(t.exps)
        assert tab.kind[k] == ("", "sin", "cos").index(t.trig)
        if t.trig:
            assert tab.comp[k] == t.trig_comp and tab.freq[k] == t.freq
    with pytest.raises(ValueError):
        _build.feat_table(tuple(lib.terms) * 2)
