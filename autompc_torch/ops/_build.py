"""Build, load and call the hand-written CUDA kernels.

All sources under ``autompc_torch/csrc/`` compile with ``nvcc`` into one
shared library with a plain C interface (no PyTorch headers, so the
build takes seconds). Each source is compiled to an object by its own
``nvcc`` process, all started together, and one more call links them:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c -o _build/<name>_<hash>.o csrc/<name>.cu
    nvcc -shared -o _build/libautompc_kernels_<hash>.so _build/*_<hash>.o

The library is built at first use, into ``autompc_torch/_build/`` under
a name keyed by the hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads. It holds the shape-templated
kernels at the (ds, dc) of ``KERNEL_SHAPES``. A shape-templated kernel
asked for at another (ds, dc) within the stated limits (``check_shape``)
is compiled then from the same source, with the shape on the command
line, into a library of its own keyed by the same hash and the shape
(``shape_library``):

    nvcc <flags> -DAMPC_DS=<ds> -DAMPC_DC=<dc> -shared
         -o _build/lib<source>_<ds>x<dc>_<hash>.so csrc/<source>.cu

so the main library's build and bits do not change. No fast-math flag: the line
search's acceptance test is knife-edge (ROADMAP §C), so the kernels keep
IEEE division and the accurate ``sinf``/``cosf``. The compiler's
``-Xptxas -v`` report (registers, spills) lands beside the library in a
``.log`` file.

The ctypes mirrors of the C parameter structs and the checks every
wrapper applies to a CUDA tensor live here too.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# Compile-time limits of csrc/ (features.cuh, riccati_quad_step.cuh,
# ls_step.cuh, linesearch_fused.cu, sindy_linesearch.cu,
# mlp_linesearch.cu); the wrappers raise before a call would exceed them.
MAX_F = 64
# Inputs ds + dc of a feature model the kernels take (features.cuh:
# AMPC_MAX_D): the halfcheetah's (18, 6) fits.
MAX_D = 24
# Terms of the per-lane-coefficient instances' device-resident table
# (features.cuh: AMPC_MAX_F_BIG): the whole library, which no feature
# mask shrinks when every lane carries its own model.
MAX_F_LANE = 2048
MAX_OBS = 8
MAX_L = 10
MLP_MAX_LAYERS = 5
MLP_MAX_W = 128
MLP_MAX_DC = 32
# Threads of a block: K3's and K8's lanes x step sizes (ls_step.cuh) and
# K5's (mlp_linesearch.cu); the kernels cap registers so that two such
# blocks share an SM. K5's largest register tile is MLP_TILE rollouts x
# MLP_TILE units.
LS_MAX_THREADS = 256
MLP_MAX_THREADS = 320
MLP_TILE = 4
MAX_SMEM_BYTES = 227 * 1024
# K2's ring of time steps in shared memory and its smallest and largest
# blocks (riccati_quad.cu: AMPC_BQ_RING, AMPC_BQ_MAX_LANES).
BQ_RING = 8
BQ_MIN_LANES = 32
BQ_MAX_LANES = 128


def bq_ring_bytes(ds):
    """Shared memory K2's ring takes a lane at ds (riccati_quad.cu:
    bq_ring_bytes_per_lane): BQ_RING steps of the Jacobian rows, a 4-byte
    word an element in either storage type, the trajectory rows and the
    old gains."""
    return BQ_RING * (ds * (ds + 1) + 2 * (ds + 1)) * 4


# The largest ds whose smallest K2 block holds its ring: 13.
BQ_MAX_DS = max(ds for ds in range(1, MAX_D)
                if BQ_MIN_LANES * bq_ring_bytes(ds) <= MAX_SMEM_BYTES)
# K6's ring of time steps and its largest block in threads
# (riccati_quad_bm.cu: AMPC_BQBM_RING, AMPC_BQBM_MAX_THREADS).
BQBM_RING = 12
BQBM_MAX_THREADS = 128
# The backward pass past the per-shape instances (csrc/riccati_big.cuh):
# K6 and K4 at dc = 1 and a state wider than ds + 1 <= MAX_D takes, one
# lane a block of RB_G threads a row, the rows the state's width rounded
# up to a warp (at most RB_MAX_THREADS threads), a ring of RB_RING steps.
RB_RING = 2
RB_G = 4
RB_MAX_THREADS = 512


def big_threads(n):
    """Threads of the wide backward pass's block at state width n
    (riccati_big.cuh: rb_threads)."""
    return -(-n // 32) * 32 * RB_G


def _up4(n):
    return -(-n // 4) * 4


def big_smem(n, dense):
    """Bytes of shared memory of the wide backward pass's block at state
    width n (riccati_big.cuh: rb_floats): V and v, Jx'V (rows at the odd
    stride n | 1), three vectors, the ring of RB_RING slots (Jx, Ju, x_t or
    cx, 4 scalars; with K4's ``dense`` expansions Cxx too)."""
    ld = n | 1
    slot = _up4(n * n) + 2 * _up4(n) + 4 + (_up4(n * n) if dense else 0)
    return 4 * (2 * _up4(n * ld) + 4 * _up4(n) + RB_RING * slot)


# The widest states of the two wide instances: K6 (the inline expansions)
# and K4 at dc = 1 (dense expansions, twice the ring), the largest n whose
# block fits MAX_SMEM_BYTES within RB_MAX_THREADS threads: 119 and 97, the
# Koopman spaces' largest lift on the cartpole (96) within both.
BQBM_BIG_MAX_DS = max(n for n in range(MAX_D, RB_MAX_THREADS // RB_G + 1)
                      if big_smem(n, False) <= MAX_SMEM_BYTES)
RG_BIG_MAX_DS = max(n for n in range(MAX_D, RB_MAX_THREADS // RB_G + 1)
                    if big_smem(n, True) <= MAX_SMEM_BYTES)
# Streaming multiprocessors of an H100 SXM: the geometry helpers' default
# where no card is asked (the CPU tests).
H100_SMS = 132
# Lanes of one TPU wide tile, (8, 128): the TPU package's wide kernels
# (and their options here: the split line search, the reshape-IO
# backward) take a batch only when it is a multiple of WIDE_B.
WIDE_B = 1024


class Shapes(tuple):
    """The (ds, dc) pairs a source's shape-templated kernels are prebuilt
    for in the main library, and the other shapes it is built for at first
    use: ds <= ``max_ds`` with ds + dc <= MAX_D (``max_ds`` None: none),
    dc = 1 only where ``dc1`` (the diagonal-cost recursion and line
    search, whose QuadDiag / LSParams hold one R). A library built at
    first use holds the per-lane-coefficient instances too."""

    def __new__(cls, built, max_ds=None, dc1=False, mc=False):
        self = super().__new__(cls, built)
        self.max_ds, self.dc1, self.mc = max_ds, dc1, mc
        return self


# Each source's shapes; the MLP line search takes its widths at run time,
# up to the limits above. Every shape-templated source takes any ds up to
# MAX_D - 1 but K2, whose ring sets BQ_MAX_DS (its shared memory fits at
# every ds up to it: tests/test_torch_shapes.py); K3's, K6's, K8's and
# K9's blocks fit at every ds up to MAX_D - 1, and K4's largest block at
# every (ds, dc) with ds + dc <= MAX_D (tests/test_torch_dense_shapes.py;
# cuda_riccati_general.check_general_shape raises past it). K3's
# batch-major entry at dc > 1 (the cheetah's (18, 6)) is its own source,
# built at first use at any (ds, dc > 1) with ds + dc <= MAX_D. K6 and K4
# at dc = 1 past MAX_D take the main library's wide instance
# (BQBM_BIG_MAX_DS, RG_BIG_MAX_DS), not a shape's library.
KERNEL_SHAPES = {
    "relin": Shapes(((4, 1),), MAX_D - 1),
    "riccati_quad": Shapes(((4, 1),), BQ_MAX_DS, dc1=True),
    "riccati_quad_bm": Shapes(((4, 1), (12, 1)), MAX_D - 1, dc1=True),
    "linesearch_fused": Shapes(((4, 1),), MAX_D - 1, dc1=True),
    "ls_obj_wide": Shapes(((4, 1),), MAX_D - 1, dc1=True),
    "ls_reroll_wide": Shapes(((4, 1),), MAX_D - 1, dc1=True),
    "sindy_linesearch": Shapes(((4, 1),), MAX_D - 1),
    "riccati_general": Shapes(((18, 6), (4, 1)), MAX_D - 1),
    "linesearch_fused_mc": Shapes((), MAX_D - 1, mc=True),
}


class FeatTable(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int),
        ("d", ctypes.c_int),
        ("exps", (ctypes.c_int8 * MAX_D) * MAX_F),
        ("kind", ctypes.c_int8 * MAX_F),
        ("comp", ctypes.c_int8 * MAX_F),
        ("freq", ctypes.c_float * MAX_F),
        ("col_n", ctypes.c_int8 * MAX_D),
        ("col_terms", (ctypes.c_int8 * MAX_F) * MAX_D),
    ]


class FeatTableBig(ctypes.Structure):
    """``FeatTable`` for up to ``MAX_F_LANE`` terms with 16-bit column
    lists (features.cuh: FeatTableBig), copied to the device once."""

    _fields_ = [
        ("n", ctypes.c_int),
        ("d", ctypes.c_int),
        ("exps", (ctypes.c_int8 * MAX_D) * MAX_F_LANE),
        ("kind", ctypes.c_int8 * MAX_F_LANE),
        ("comp", ctypes.c_int8 * MAX_F_LANE),
        ("freq", ctypes.c_float * MAX_F_LANE),
        ("col_n", ctypes.c_int16 * MAX_D),
        ("col_terms", (ctypes.c_int16 * MAX_F_LANE) * MAX_D),
    ]


class QuadDiag(ctypes.Structure):
    _fields_ = [
        ("obsdim", ctypes.c_int),
        ("two_dt", ctypes.c_float),
        ("qd", ctypes.c_float * MAX_OBS),
        ("rd", ctypes.c_float),
        ("fd", ctypes.c_float * MAX_OBS),
        ("goal", ctypes.c_float * MAX_OBS),
    ]


class LSParams(ctypes.Structure):
    _fields_ = [
        ("L", ctypes.c_int),
        ("obsdim", ctypes.c_int),
        ("alphas", ctypes.c_float * MAX_L),
        ("umin", ctypes.c_float),
        ("umax", ctypes.c_float),
        ("qd", ctypes.c_float * MAX_OBS),
        ("rd", ctypes.c_float),
        ("fd", ctypes.c_float * MAX_OBS),
        ("goal", ctypes.c_float * MAX_OBS),
        ("dt", ctypes.c_float),
        ("thresh", ctypes.c_float),
    ]


class RegParams(ctypes.Structure):
    """The GaussReg constants (ls_step.cuh: RegParams): c S_ij (c = 1 on
    the diagonal, 2 off it; row stride MAX_OBS) and mu."""

    _fields_ = [
        ("cS", ctypes.c_float * (MAX_OBS * MAX_OBS)),
        ("mu", ctypes.c_float * MAX_OBS),
    ]


class LSParamsMC(ctypes.Structure):
    """K3's constants at dc > 1 (linesearch_fused_mc.cu: LSParamsMC): the
    step sizes, each control's bounds, the goal (up to MAX_D entries)."""

    _fields_ = [
        ("L", ctypes.c_int),
        ("obsdim", ctypes.c_int),
        ("alphas", ctypes.c_float * MAX_L),
        ("umin", ctypes.c_float * MAX_D),
        ("umax", ctypes.c_float * MAX_D),
        ("goal", ctypes.c_float * MAX_D),
        ("dt", ctypes.c_float),
        ("thresh", ctypes.c_float),
    ]


class SindyLS(ctypes.Structure):
    """K7's constants (sindy_linesearch.cu: SindyLS): the step sizes and
    the control bounds, one pair a control (up to MAX_D)."""

    _fields_ = [
        ("L", ctypes.c_int),
        ("alphas", ctypes.c_float * MAX_L),
        ("umin", ctypes.c_float * MAX_D),
        ("umax", ctypes.c_float * MAX_D),
    ]


class MlpLS(ctypes.Structure):
    _fields_ = [
        ("n_layers", ctypes.c_int),
        ("widths", ctypes.c_int * (MLP_MAX_LAYERS + 1)),
        ("act", ctypes.c_int),
        ("ds", ctypes.c_int),
        ("dc", ctypes.c_int),
        ("L", ctypes.c_int),
        ("round0", ctypes.c_int),
        ("alphas", ctypes.c_float * MAX_L),
        ("umin", ctypes.c_float * MLP_MAX_DC),
        ("umax", ctypes.c_float * MLP_MAX_DC),
    ]


_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ampc_relin_jacobians": (
        [ctypes.POINTER(FeatTable), _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    ),
    "ampc_relin_jacobians_bm": (
        [ctypes.POINTER(FeatTable), _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    ),
    "ampc_relin_jacobians_lane": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "ampc_relin_jacobians_bm_lane": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "ampc_backward_quad_ll": (
        [ctypes.POINTER(QuadDiag)] + [_P] * 14 + [_I] * 6 + [_P]
    ),
    "ampc_backward_quad_bm": (
        [ctypes.POINTER(QuadDiag)] + [_P] * 11 + [_I] * 5 + [_P]
    ),
    "ampc_fused_line_search": (
        [ctypes.POINTER(FeatTable), ctypes.POINTER(LSParams)]
        + [_P] * 23 + [_I] * 6 + [_P]
    ),
    "ampc_fused_line_search_lane": (
        [_P, _I, ctypes.POINTER(LSParams)] + [_P] * 23 + [_I] * 5 + [_P]
    ),
    "ampc_fused_line_search_occupancy": [_I] * 5 + [_P],
    "ampc_fused_line_search_bm": (
        [ctypes.POINTER(FeatTable), ctypes.POINTER(LSParams), ctypes.POINTER(RegParams)]
        + [_P] * 23 + [_I] * 5 + [_P]
    ),
    "ampc_fused_line_search_bm_lane": (
        [_P, _I, ctypes.POINTER(LSParams), ctypes.POINTER(RegParams)]
        + [_P] * 23 + [_I] * 5 + [_P]
    ),
    "ampc_fused_line_search_bm_dense": (
        [ctypes.POINTER(FeatTable), _P, _I, ctypes.POINTER(LSParams)]
        + [_P] * 21 + [_I] * 5 + [_P]
    ),
    "ampc_fused_line_search_bm_occupancy": [_I] * 4 + [_P],
    "ampc_ls_obj_wide": (
        [ctypes.POINTER(FeatTable), ctypes.POINTER(LSParams)]
        + [_P] * 12 + [_I] * 5 + [_P]
    ),
    "ampc_ls_obj_wide_occupancy": [_I] * 3 + [_P],
    "ampc_ls_reroll_wide": (
        [ctypes.POINTER(FeatTable)] + [_P] * 14 + [_I] * 6 + [_P]
    ),
    "ampc_sindy_line_search": (
        [ctypes.POINTER(FeatTable), ctypes.POINTER(SindyLS)]
        + [_P] * 8 + [_I] * 7 + [_P]
    ),
    "ampc_sindy_line_search_lane": (
        [_P, _I, ctypes.POINTER(SindyLS)] + [_P] * 8 + [_I] * 7 + [_P]
    ),
    "ampc_riccati_general": [_P] * 12 + [_I] * 7 + [_P],
    "ampc_riccati_general_big": [_P] * 12 + [_I] * 4 + [_P],
    "ampc_backward_quad_bm_big": (
        [ctypes.POINTER(QuadDiag)] + [_P] * 11 + [_I] * 4 + [_P]
    ),
    "ampc_fused_line_search_mc": (
        [ctypes.POINTER(FeatTable), _P, _I, ctypes.POINTER(LSParamsMC), _I]
        + [_P] * 25 + [_I] * 7 + [_P]
    ),
    "ampc_mlp_line_search": (
        [ctypes.POINTER(MlpLS)] + [_P] * 8 + [_I] * 6 + [_P]
    ),
    "ampc_mlp_line_search_occupancy": [ctypes.POINTER(MlpLS)] + [_I] * 4 + [_P],
}


def sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def main_sources():
    """The .cu sources compiled into the main library: every one but a
    source with no prebuilt shape (``KERNEL_SHAPES``: K3's multi-control
    source), which is built only at a shape."""
    return [p for p in sources() if p.suffix == ".cu"
            and KERNEL_SHAPES.get(p.stem, True)]


def source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libautompc_kernels_{source_digest()}.so"


def nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``$CUDA_HOME``
    (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "autompc_torch are built from source at first use on a machine "
        "with the CUDA toolkit"
    )


def build() -> Path:
    """Compile every source to an object (one ``nvcc`` process each, all
    started together), link them into the library (atomic rename into
    place) and return its path."""
    out = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cc, tag = nvcc(), source_digest()
    jobs = []
    for src in main_sources():
        obj = BUILD_DIR / f"{src.stem}_{tag}.o"
        cmd = [cc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        )))
    log, failed = [], []
    for cmd, obj, proc in jobs:
        stdout, stderr = proc.communicate()
        log.append(" ".join(cmd) + "\n" + stdout + stderr)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{stderr[-4000:]}")
    if not failed:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [cc, "-shared", "-o", tmp] + [str(obj) for _, obj, _ in jobs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"link ({proc.returncode}):\n{proc.stderr[-4000:]}")
    out.with_suffix(".log").write_text("\n".join(log))
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, out)
    return out


def build_log() -> str:
    p = library_path().with_suffix(".log")
    return p.read_text() if p.exists() else ""


def _bind(path) -> ctypes.CDLL:
    """Load the library at ``path`` and type the C entries of
    ``_SIGNATURES`` that it has."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        if not hasattr(lib, name):
            continue
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    path = library_path()
    if not path.exists():
        build()
    return _bind(path)


def check_shape(source, ds, dc):
    """Raise ``ValueError`` by name unless the kernels of ``source`` take
    (ds, dc) (``KERNEL_SHAPES[source]``): a prebuilt pair, or ds + dc <=
    MAX_D, ds <= its ``max_ds`` and, for the diagonal-cost kernels, dc =
    1 (for K3's multi-control source dc > 1). ``kernel_library`` calls it
    before any build or launch."""
    shapes = KERNEL_SHAPES[source]
    if (ds, dc) in shapes:
        return
    if shapes.max_ds is None:
        raise ValueError(f"{source}: the kernel is built for (ds, dc) in {tuple(shapes)}, "
                         f"got {(ds, dc)}")
    if ds < 1 or dc < 1 or ds + dc > MAX_D:
        raise ValueError(f"{source}: the kernels take ds + dc <= MAX_D = {MAX_D}, got "
                         f"(ds, dc) = {(ds, dc)}")
    if ds > shapes.max_ds:
        raise ValueError(f"{source}: the kernels take ds <= {shapes.max_ds}, got "
                         f"(ds, dc) = {(ds, dc)}")
    if shapes.dc1 and dc != 1:
        raise ValueError(f"{source}: the diagonal-cost kernels take dc = 1, got "
                         f"(ds, dc) = {(ds, dc)}")
    if shapes.mc and dc < 2:
        raise ValueError(f"{source}: the multi-control instances take dc > 1 (dc = 1 "
                         f"takes linesearch_fused), got (ds, dc) = {(ds, dc)}")


def check_obsdim(source, obsdim):
    """Raise ``ValueError`` by name past the MAX_OBS observations the
    diagonal-cost kernels' constants hold (QuadDiag, LSParams)."""
    if obsdim > MAX_OBS:
        raise ValueError(f"{source}: the diagonal-cost kernels take obsdim <= MAX_OBS = "
                         f"{MAX_OBS}, got {obsdim}")


def shape_library_path(source, ds, dc) -> Path:
    return BUILD_DIR / f"lib{source}_{ds}x{dc}_{source_digest()}.so"


def build_shapes(shapes, main=False):
    """Compile the libraries of ``shapes``, (source, ds, dc) triples, that
    are not built yet: one ``nvcc`` a shape, all started together, each
    its source alone with ``-DAMPC_DS``/``-DAMPC_DC``, compiled and
    linked in one call (atomic rename into place). ``main``: build (or
    load) the main library meanwhile, its ``nvcc`` processes running
    beside these. The ``-Xptxas -v`` report lands beside each library in
    a ``.log`` file."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cc, jobs = nvcc(), []
    for source, ds, dc in dict.fromkeys(shapes):
        check_shape(source, ds, dc)
        out = shape_library_path(source, ds, dc)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [cc, *NVCC_FLAGS, f"-DAMPC_DS={ds}", f"-DAMPC_DC={dc}", "-shared", "-o", tmp,
               str(CSRC_DIR / f"{source}.cu")]
        jobs.append((out, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    try:
        if main:
            library()
    finally:
        failed = []
        for out, tmp, cmd, proc in jobs:
            stdout, stderr = proc.communicate()
            out.with_suffix(".log").write_text(" ".join(cmd) + "\n" + stdout + stderr)
            if proc.returncode != 0:
                os.unlink(tmp)
                failed.append(f"{cmd[-1]} at {out.stem} ({proc.returncode}):\n{stderr[-4000:]}")
            else:
                os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))


@functools.lru_cache(maxsize=None)
def shape_library(source, ds, dc) -> ctypes.CDLL:
    """The library of ``source``'s kernels at (ds, dc), built first if
    its sources changed."""
    path = shape_library_path(source, ds, dc)
    if not path.exists():
        build_shapes([(source, ds, dc)])
    return _bind(path)


def shape_build_log(source, ds, dc) -> str:
    p = shape_library_path(source, ds, dc).with_suffix(".log")
    return p.read_text() if p.exists() else ""


def kernel_library(source, ds, dc) -> ctypes.CDLL:
    """The library that holds ``source``'s kernels at (ds, dc), its
    shared- and per-lane-coefficient instances alike: the main library at
    a prebuilt shape, else the shape's own, built at first use. Raises
    ``ValueError`` by name past the limits, before any launch."""
    check_shape(source, ds, dc)
    if (ds, dc) in KERNEL_SHAPES[source]:
        return library()
    return shape_library(source, ds, dc)


def _fill_table(tab, terms):
    tab.n, tab.d = len(terms), len(terms[0].exps)
    kinds = {"": 0, "sin": 1, "cos": 2}
    for k, t in enumerate(terms):
        for c, e in enumerate(t.exps):
            tab.exps[k][c] = int(e)
        tab.kind[k] = kinds[t.trig]
        tab.comp[k] = max(int(t.trig_comp), 0)
        tab.freq[k] = float(t.freq)
    for c, ks in enumerate(jacobian_columns(terms)):
        tab.col_n[c] = len(ks)
        for j, k in enumerate(ks):
            tab.col_terms[c][j] = k
    return tab


def check_table_size(n, lane):
    """Raise by name unless a kernel's table takes ``n`` terms: the
    per-lane-coefficient instances (``lane``) up to ``MAX_F_LANE``, the
    shared ones up to ``MAX_F``. The wrappers call it before they touch
    the card."""
    limit, what = ((MAX_F_LANE, "kernels with per-lane coefficients") if lane
                   else (MAX_F, "kernels with shared coefficients"))
    if not 1 <= n <= limit:
        raise ValueError(f"{what} take 1..{limit} terms, got {n}")


def _check_table(terms, lane):
    check_table_size(len(terms), lane)
    d = len(terms[0].exps)
    if d > MAX_D:
        raise ValueError(f"kernels take at most {MAX_D} inputs, got {d}")


@functools.lru_cache(maxsize=64)
def feat_table(terms) -> FeatTable:
    """The C table of the (active) term descriptors ``terms`` (a tuple
    of sysid.basis.TermDesc). Cached per tuple; treat as read-only."""
    _check_table(terms, lane=False)
    return _fill_table(FeatTable(), terms)


def feat_table_big(terms) -> FeatTableBig:
    """The per-lane instances' table of ``terms`` (up to ``MAX_F_LANE``
    terms, 16-bit column lists), on the host."""
    _check_table(terms, lane=True)
    return _fill_table(FeatTableBig(), terms)


@functools.lru_cache(maxsize=64)
def feat_table_dev(terms, device) -> torch.Tensor:
    """``feat_table_big(terms)`` copied to ``device`` once (a uint8
    tensor the per-lane kernels read the table from). Cached per tuple
    and device; treat as read-only."""
    raw = bytearray(feat_table_big(terms))
    return torch.frombuffer(raw, dtype=torch.uint8).to(device)


def jacobian_columns(terms):
    """Per input component c, the indices of the terms whose partial in
    z_c is not structurally zero, in term order: the lists the Jacobian
    columns walk (csrc/features.cuh: ampc_jac_col). A term's partial is
    structurally zero where it has no power of z_c and no trig factor of
    z_c (ampc_term_partial's test)."""
    d = len(terms[0].exps)
    return [[k for k, t in enumerate(terms)
             if int(t.exps[c]) != 0 or (t.trig != "" and max(int(t.trig_comp), 0) == c)]
            for c in range(d)]


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def occupancy(entry: str, *args) -> dict:
    """A kernel's registers and local (spill) bytes a thread and its
    resident blocks an SM, from the C entry ``entry`` (the
    ``*_occupancy`` query of its source) called with ``args`` and an
    output array."""
    out = (ctypes.c_int * 3)()
    check_rc(entry, getattr(library(), entry)(*args, out))
    return dict(registers=out[0], local_bytes=out[1], blocks_per_sm=out[2])


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda(name: str, t: torch.Tensor, shape, dtype, device):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape``
    on ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def lane_cost_planes(qd, rd, fd, obsdim, B):
    """Which of the two cost forms the dc=1 diagonal-cost wrappers were
    given: True for per-lane lanes-last planes qd/fd (obsdim, B) and rd
    (1, B) (tensors), False for one fixed cost as host sequences of
    length obsdim and 1. A mixture or a wrong shape raises. A wrapper
    decides this once per call and hands the answer on."""
    as_planes = [isinstance(v, torch.Tensor) and v.ndim == 2 for v in (qd, rd, fd)]
    if not any(as_planes):
        if len(qd) != obsdim or len(fd) != obsdim or len(rd) != 1:
            raise ValueError(
                f"cost diagonals must be qd/fd of length obsdim = {obsdim} "
                "and rd of length 1 (dc = 1)"
            )
        return False
    if not all(as_planes):
        raise ValueError(
            "qd, rd, fd must be all host sequences (one fixed cost) or all "
            "lanes-last tensors (obsdim, B), (1, B), (obsdim, B)"
        )
    for name, v, shape in (("qd", qd, (obsdim, B)), ("rd", rd, (1, B)),
                           ("fd", fd, (obsdim, B))):
        if tuple(v.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(v.shape)}, expected {shape}")
    return True


def cost_plane_ptrs(lane, qd, rd, fd, dtype, device):
    """The three plane pointers a kernel launch takes: the checked
    tensors' for per-lane planes (``lane``), nulls for a fixed cost."""
    if not lane:
        return [None, None, None]
    for name, v in (("qd", qd), ("rd", rd), ("fd", fd)):
        check_cuda(name, v, v.shape, dtype, device)
    return [ptr(v) for v in (qd, rd, fd)]


JAC_DTYPES = (torch.float32, torch.bfloat16)


def jac_bf16(name: str, jac: torch.Tensor) -> int:
    """1 for a bfloat16 Jacobian carry, 0 for float32; any other storage
    type raises."""
    if jac.dtype not in JAC_DTYPES:
        raise ValueError(f"{name}: dtype {jac.dtype}, the kernels store the "
                         "Jacobian carry as float32 or bfloat16")
    return int(jac.dtype == torch.bfloat16)


def check_rc(name: str, rc: int):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def device_kind(t: torch.Tensor) -> str:
    """"cpu" (plain PyTorch twin) or "cuda" (the kernel); anything else
    raises."""
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(
            f"tensors on {t.device}: the kernel wrappers take CPU tensors "
            "(plain PyTorch twin) or CUDA tensors (the CUDA kernel)"
        )
    return kind
