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
rebuilds and an unchanged one loads. No fast-math flag: the line
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
MAX_D = 8
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
# K2's ring of time steps in shared memory and its largest block
# (riccati_quad.cu: AMPC_BQ_RING, AMPC_BQ_MAX_LANES).
BQ_RING = 8
BQ_MAX_LANES = 128
# K6's ring of time steps and its largest block in threads
# (riccati_quad_bm.cu: AMPC_BQBM_RING, AMPC_BQBM_MAX_THREADS).
BQBM_RING = 12
BQBM_MAX_THREADS = 128
# Streaming multiprocessors of an H100 SXM: the geometry helpers' default
# where no card is asked (the CPU tests).
H100_SMS = 132
# Lanes of one TPU wide tile, (8, 128): the TPU package's wide kernels
# (and their options here: the split line search, the reshape-IO
# backward) take a batch only when it is a multiple of WIDE_B.
WIDE_B = 1024
# The (ds, dc) pairs each shape-templated kernel is instantiated for;
# the MLP line search takes its widths at run time, up to the limits
# above.
KERNEL_SHAPES = {
    "relin": ((4, 1),),
    "riccati_quad": ((4, 1),),
    "riccati_quad_bm": ((4, 1),),
    "linesearch_fused": ((4, 1),),
    "ls_obj_wide": ((4, 1),),
    "ls_reroll_wide": ((4, 1),),
    "sindy_linesearch": ((4, 1),),
    "riccati_general": ((18, 6), (4, 1)),
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


class SindyLS(ctypes.Structure):
    _fields_ = [
        ("L", ctypes.c_int),
        ("alphas", ctypes.c_float * MAX_L),
        ("umin", ctypes.c_float),
        ("umax", ctypes.c_float),
    ]


class MlpLS(ctypes.Structure):
    _fields_ = [
        ("n_layers", ctypes.c_int),
        ("widths", ctypes.c_int * (MLP_MAX_LAYERS + 1)),
        ("act", ctypes.c_int),
        ("ds", ctypes.c_int),
        ("dc", ctypes.c_int),
        ("L", ctypes.c_int),
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
        [ctypes.POINTER(FeatTable), _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    ),
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
    "ampc_fused_line_search_occupancy": [_I] * 4 + [_P],
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
        + [_P] * 8 + [_I] * 6 + [_P]
    ),
    "ampc_riccati_general": [_P] * 12 + [_I] * 7 + [_P],
    "ampc_mlp_line_search": (
        [ctypes.POINTER(MlpLS)] + [_P] * 8 + [_I] * 5 + [_P]
    ),
    "ampc_mlp_line_search_occupancy": [ctypes.POINTER(MlpLS)] + [_I] * 3 + [_P],
}


def sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


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
    for src in sources():
        if src.suffix != ".cu":
            continue
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


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    path = library_path()
    if not path.exists():
        build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=64)
def feat_table(terms) -> FeatTable:
    """The C table of the (active) term descriptors ``terms`` (a tuple
    of sysid.basis.TermDesc). Cached per tuple; treat as read-only."""
    if not 1 <= len(terms) <= MAX_F:
        raise ValueError(f"kernels take 1..{MAX_F} active terms, got {len(terms)}")
    d = len(terms[0].exps)
    if d > MAX_D:
        raise ValueError(f"kernels take at most {MAX_D} inputs, got {d}")
    tab = FeatTable()
    tab.n, tab.d = len(terms), d
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
