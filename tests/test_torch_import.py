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

# The tensors here are small: one intra-op thread (six test workers with a
# thread pool each oversubscribe the cores).
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

PORT_MODULES = [
    "autompc_torch",
    "autompc_torch.benchmarks",
    "autompc_torch.benchmarks.data_generation",
    "autompc_torch.benchmarks.halfcheetah",
    "autompc_torch.benchmarks.pendulum",
    "autompc_torch.config",
    "autompc_torch.config.space",
    "autompc_torch.control",
    "autompc_torch.control.controller",
    "autompc_torch.control.ilqr",
    "autompc_torch.control.lqr",
    "autompc_torch.control.mppi",
    "autompc_torch.control.nmpc",
    "autompc_torch.control.receding",
    "autompc_torch.control.zero",
    "autompc_torch.costs",
    "autompc_torch.costs.cost_factory",
    "autompc_torch.costs.lane_costs",
    "autompc_torch.costs.quad_cost_factory",
    "autompc_torch.evaluation",
    "autompc_torch.evaluation.evaluator",
    "autompc_torch.evaluation.model_metrics",
    "autompc_torch.native",
    "autompc_torch.ops._build",
    "autompc_torch.ops.cuda_linesearch",
    "autompc_torch.ops.cuda_mlp_linesearch",
    "autompc_torch.ops.cuda_relin",
    "autompc_torch.ops.cuda_riccati",
    "autompc_torch.ops.cuda_riccati_general",
    "autompc_torch.ops.lstsq",
    "autompc_torch.ops.riccati",
    "autompc_torch.ops.trajqp",
    "autompc_torch.parallel",
    "autompc_torch.parallel.fanout",
    "autompc_torch.parallel.mesh",
    "autompc_torch.pipeline",
    "autompc_torch.sysid",
    "autompc_torch.sysid.arx",
    "autompc_torch.sysid.dummy",
    "autompc_torch.sysid.gp",
    "autompc_torch.sysid.koopman",
    "autompc_torch.sysid.mlp",
    "autompc_torch.sysid.sindy",
    "autompc_torch.sysid.stable_koopman",
    "autompc_torch.tuning",
    "autompc_torch.tuning.bo",
    "autompc_torch.tuning.bucketed",
    "autompc_torch.tuning.model_tuner",
    "autompc_torch.tuning.pipeline_tuner",
    "autompc_torch.utils",
    "autompc_torch.utils.checkpoint",
    "autompc_torch.utils.profiling",
    "autompc_torch.utils.simulation",
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


def test_ab_tool_imports_without_jax():
    """tools/ab_torch_kernels.py and the port modules it times import no
    JAX and nothing of the JAX package."""
    proc = _run(
        "import runpy, sys\n"
        "runpy.run_path('tools/ab_torch_kernels.py', run_name='ab')\n"
        "from autompc_torch.ops import cuda_mlp_linesearch, cuda_riccati, "
        "cuda_riccati_general\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('autompc_tpu') or m.startswith('jaxlib'))\n"
        "assert not bad, bad\n"
    )
    assert proc.returncode == 0, proc.stderr
    src = (ROOT / "tools" / "ab_torch_kernels.py").read_text()
    assert "import jax" not in src and "autompc_tpu" not in src


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
    assert {"relin.cu", "riccati_quad.cu", "linesearch_fused.cu", "features.cuh",
            "riccati_general.cu", "mlp_linesearch.cu", "riccati_quad_bm.cu",
            "sindy_linesearch.cu", "riccati_quad_step.cuh", "ls_obj_wide.cu",
            "ls_reroll_wide.cu", "ls_step.cuh", "jac_io.cuh", "linesearch_fused_mc.cu",
            "riccati_big.cuh"} <= names
    assert sum(n.endswith(".cu") for n in names) == 10
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


def test_every_port_module_is_in_the_import_check():
    """A module added to the port joins PORT_MODULES (packages count
    through their __init__)."""
    pkg = ROOT / "autompc_torch"
    found = {
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in pkg.rglob("*.py") if "_build" not in p.parts
    }
    found = {m[: -len(".__init__")] if m.endswith(".__init__") else m for m in found}
    code = (
        "import importlib, sys\n"
        f"for m in {sorted(found)!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('autompc_tpu') or m.startswith('jaxlib'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert set(PORT_MODULES) <= found


def test_kernel_shapes_and_mlp_struct_mirror_the_sources():
    """The built (ds, dc) pairs and the compile-time limits in _build
    are the ones the CUDA sources instantiate and define."""
    import ctypes
    import re

    from autompc_torch.ops import _build

    src = (_build.CSRC_DIR / "riccati_general.cu").read_text()
    pairs = {(int(a), int(b)) for a, b in
             re.findall(r"rg_launch<(\d+), (\d+), \d+>\(", src)}
    assert pairs == set(_build.KERNEL_SHAPES["riccati_general"]) == {(18, 6), (4, 1)}
    mlp = (_build.CSRC_DIR / "mlp_linesearch.cu").read_text()
    defs = dict(re.findall(r"#define AMPC_MLP_(\w+) (\d+)", mlp))
    assert int(defs["MAX_LAYERS"]) == _build.MLP_MAX_LAYERS
    assert int(defs["MAX_W"]) == _build.MLP_MAX_W
    assert int(defs["MAX_DC"]) == _build.MLP_MAX_DC
    assert int(defs["MAX_L"]) == _build.MAX_L
    assert int(defs["TILE"]) == _build.MLP_TILE
    assert int(defs["MAX_THREADS"]) == _build.MLP_MAX_THREADS
    ls = (_build.CSRC_DIR / "ls_step.cuh").read_text()
    assert int(re.search(r"#define AMPC_LS_MAX_THREADS (\d+)", ls)[1]) == \
        _build.LS_MAX_THREADS
    # n_layers, widths, then act, ds, dc, L and round0.
    n_int = 1 + (_build.MLP_MAX_LAYERS + 1) + 5
    n_float = _build.MAX_L + 2 * _build.MLP_MAX_DC
    assert ctypes.sizeof(_build.MlpLS) == 4 * (n_int + n_float)
    for name in ("ampc_riccati_general", "ampc_mlp_line_search"):
        assert f'extern "C" int {name}(' in src + mlp
        assert name in _build._SIGNATURES


def test_fanout_kernel_entries_mirror_the_sources():
    """Every C entry point has a ctypes signature with as many
    arguments as the source declares, the new kernels are __global__
    functions of their own, and the structs they share with Python have
    the same size on both sides."""
    import ctypes
    import re

    from autompc_torch.ops import _build

    text = "".join(p.read_text() for p in _build.sources())
    entries = re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text)
    assert {n for n, _ in entries} == set(_build._SIGNATURES)
    for name, args in entries:
        assert len(_build._SIGNATURES[name]) == args.count(",") + 1, name
    for kernel in ("backward_quad_bm_kernel", "backward_quad_bm_wide_kernel",
                   "sindy_ls_kernel"):
        assert re.search(r"__global__ void " + kernel + r"\(", text)
    assert ctypes.sizeof(_build.SindyLS) == 4 * (1 + _build.MAX_L + 2 * _build.MAX_D)
    assert ctypes.sizeof(_build.QuadDiag) == 4 * (2 + 3 * _build.MAX_OBS + 1)
    assert _build.KERNEL_SHAPES["sindy_linesearch"] == ((4, 1),)
    # K6: the ds = 4 kernel and the wide instance the entry dispatches
    # ds = 12 to.
    assert _build.KERNEL_SHAPES["riccati_quad_bm"] == ((4, 1), (12, 1))
    wide = {int(d) for d in re.findall(r"bqbm_wide_launch<(\d+), \d+>\(", text)}
    assert {(d, 1) for d in wide} | {(4, 1)} == set(_build.KERNEL_SHAPES["riccati_quad_bm"])


def _fanout(**kw):
    from autompc_torch.benchmarks import CartpoleSwingupBenchmark
    from autompc_torch.parallel import QuadCostFanout
    from autompc_torch.sysid import SINDy

    b = CartpoleSwingupBenchmark()
    m = SINDy(b.system, method="lstsq", trig_basis=True, device="cpu")
    m.set_parameters({"coeffs": 0.1 * torch.ones(4, m.library.n_features).numpy()})
    base = dict(horizon=4, n_steps=2, goal=torch.zeros(4).numpy(),
                feature_spec=(m.library, "coeffs"), device="cpu")
    base.update(kw)
    return QuadCostFanout(b.system, b.task, m, m, **base)


@pytest.mark.parametrize("kwargs, match", [
    (dict(impl="other"), "impl must be"),
    (dict(mesh=object()), "mesh"),
    (dict(impl="vmap", reg_matrix=[[1.0]]), "reg_matrix requires impl='batched'"),
    (dict(fuse_ls=True, lanes_last=True, backward="pallas", reg_matrix=torch.eye(4).numpy()),
     "lanes_last"),
    # Without a feature_spec the batch-major body relinearizes by jacfwd
    # (tests/test_torch_joint_sindy.py); the lanes-last body still needs one.
    (dict(feature_spec=None, lanes_last=True, fuse_ls=True, backward="pallas"), "jacfwd"),
])
def test_fanout_options_that_still_raise(kwargs, match):
    with pytest.raises(ValueError, match=match):
        _fanout(**kwargs)


def test_fanout_takes_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _fanout(device=None)
    assert _fanout().device == torch.device("cpu")


@pytest.mark.parametrize("which, match", [
    ("K6 ds", r"ds \+ dc <= MAX_D = 24"),
    ("K7 ds", r"ds \+ dc <= MAX_D = 24"),
    ("K7 dc", r"ds \+ dc <= MAX_D = 24"),
    ("K7 per-lane coeffs", "per-lane coefficients"),
])
def test_new_kernels_raise_at_unbuilt_shapes(which, match, monkeypatch):
    """Past the kernels' stated limits (ds + dc <= MAX_D) the wrapper of a
    tensor that is not on the CPU raises by name before any build or
    launch (device_kind is patched so that meta tensors stand in for the
    card's); within them a shape the main library lacks is built at first
    use (tests/test_torch_shapes.py)."""
    from autompc_torch.ops import _build, cuda_linesearch, cuda_riccati
    from autompc_torch.sysid.basis import FeatureLibrary

    monkeypatch.setattr(_build, "device_kind", lambda t: "cuda")
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device="meta")
    if which == "K6 ds":           # past the wide instance (ds + 1 > MAX_D) too
        ds = _build.BQBM_BIG_MAX_DS + 1
        with pytest.raises(ValueError, match=match):
            cuda_riccati.backward_quad(z(2, 3, ds, ds), z(2, 3, ds, 1), z(2, 4, ds),
                                       z(2, 3, 1), z(2, 5), z(2, 1), z(2, 5), (0.0,) * 5,
                                       0.05, 5)
        return
    ds, dc = {"K7 ds": (_build.MAX_D, 1), "K7 dc": (4, _build.MAX_D - 3),
              "K7 per-lane coeffs": (4, 1)}[which]
    terms = FeatureLibrary.from_config(ds + dc, trig_basis="coeffs" in which).terms
    coeffs = z(2, ds, len(terms)) if "coeffs" in which else z(ds, len(terms))
    with pytest.raises(ValueError, match=match):
        cuda_linesearch.sindy_line_search(
            terms, z(2, ds), z(2, 4, ds), z(2, 3, dc), z(2, 3, dc, ds), z(2, 3, dc),
            coeffs, (1.0, 0.2), -1.0, 1.0)


def test_timeit_distinct_runs_every_input_and_excludes_warmup():
    from autompc_torch.utils.profiling import timeit_distinct

    seen = []

    def fn(a, b):
        seen.append((a, b))
        return a + b

    mean, out = timeit_distinct(fn, [(1, 2), (3, 4), (5, 6)], silent=True)
    assert seen == [(1, 2), (3, 4), (5, 6)] and out == 11 and mean >= 0.0
    mean, out = timeit_distinct(fn, [(7, 8)], warmup=0, silent=True)
    assert out == 15


def _entry_points():
    from autompc_torch.benchmarks import CartpoleSwingupBenchmark, HalfcheetahBenchmark
    from autompc_torch.sysid import MLP, SINDy, SINDyFactory

    system = CartpoleSwingupBenchmark().system
    return {
        "cartpole data": lambda **kw: CartpoleSwingupBenchmark().gen_trajs_batch(
            seed=0, n_trajs=2, traj_len=3, **kw).obs.device,
        "halfcheetah data": lambda **kw: HalfcheetahBenchmark().gen_trajs_batch(
            seed=0, n_trajs=2, traj_len=3, **kw).obs.device,
        "SINDy": lambda **kw: SINDy(system, method="lstsq", **kw).device,
        "SINDyFactory": lambda **kw: SINDyFactory(system, **kw)(
            SINDyFactory(system).get_configuration_space().get_default_configuration(),
            None, skip_train_model=True).device,
        "MLP": lambda **kw: MLP(system, n_hidden_layers=1, hidden_size=4, **kw).net.Ws[0].device,
    }


@pytest.mark.parametrize("name", ["cartpole data", "halfcheetah data", "SINDy", "SINDyFactory",
                                  "MLP"])
def test_entry_points_take_the_card_unless_told(name, monkeypatch):
    """With no ``device`` an entry point asks for the card and raises
    when there is none; it runs on the CPU only when told to."""
    make = _entry_points()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    assert make(device="cpu") == torch.device("cpu")
