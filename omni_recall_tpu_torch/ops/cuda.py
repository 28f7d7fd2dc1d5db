"""Build, load and count the port's hand-written CUDA kernels.

Each source under ``omni_recall_tpu_torch/csrc/`` compiles with ``nvcc``
into a shared library with a plain C interface (no PyTorch headers, so a
build takes seconds, not minutes) and is loaded with ``ctypes``. Builds run
at first use, all sources at once (one ``nvcc`` process each), into the
git-ignored ``omni_recall_tpu_torch/_build/`` directory; a library is
rebuilt when its source is newer. Nothing here runs at import time: the CPU
tests import every module of the port on a machine without ``nvcc``.

Flags: ``sm_90a`` (Hopper) and ``-fmad=false`` — the kernels reproduce the
JAX graphs' f32 arithmetic bit for bit, so no multiply-add may contract.

``LAUNCHES`` counts, per kernel, the launches its wrapper made. A wrapper
adds one exactly where it launches its kernel and nowhere else, so a run
that zeroes the counts, drives the serving path and reads them back shows
which kernels that path went through.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# kernel library name -> source file
SOURCES = {"int8_coarse": "int8_coarse.cu", "int8_scan": "int8_scan.cu",
           "fp_scan": "fp_scan.cu", "dd_rows": "dd_rows.cu", "refine": "refine.cu"}

NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
]

# launches per kernel (see module docstring); keys are the kernel names
# chip_smoke.py reports
LAUNCHES: dict[str, int] = {
    "coarse_scan": 0,   # K1: coarse int8 scan, packed-key extraction (int8_coarse.cu)
    "coarse_pair": 0,   # K7a: the same scan in its value/index pair mode (int8_coarse.cu)
    "coarse_staged": 0,  # K1 / K7a in the first design, scores staged in shared memory
                         # (int8_scan.cu): the shapes int8_coarse.cu does not take
    "fused_scan": 0,    # K4: full fused int8 + keyword scan
    "kw_scan": 0,       # K5: keyword-only bloom scan
    "fp_scan": 0,       # K6: fused f32/bf16 scan
    "dd_rows": 0,       # K2: double-float cosine over gathered rows
    "refine": 0,        # K3: residual two-plane refine over candidate rows
    "recency": 0,       # K3's recency term alone, a check of its expf (no path)
    "profile_kernel": 0,  # T1: K6's body split three ways (tools/profile_kernel.py)
    "profile_bloomT": 0,  # T5: K4's body over row or transposed bloom (tools/)
    "probe_pipe": 0,      # T2: K1's first design, extraction a group behind (int8_pipe_kernel)
    "probe_keys_emit": 0,  # T4: K1's first design's tiles, three emit layouts (KeysArgs)
    "probe_serve": 0,     # T3: K3's body over pre-gathered slabs (tools/probe_serve.py)
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


_count_lock = threading.Lock()


def count_launch(name: str) -> None:
    """Add one to ``LAUNCHES[name]`` (under a lock: the pipelined executor
    launches from two threads)."""
    with _count_lock:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from omni_recall_tpu_torch/csrc at first use")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """The library is missing or older than its source or any shared header
    (csrc/*.cuh)."""
    lib = _lib_path(name)
    if not lib.is_file():
        return True
    inputs = [CSRC / SOURCES[name], *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in inputs)


def build_all(force: bool = False) -> float:
    """Compile every stale kernel library, all ``nvcc`` processes started
    together. Returns the wall seconds spent (0.0 when nothing was stale).
    Raises with the compiler's output when a build fails."""
    with _lock:
        names = [n for n in SOURCES if force or _stale(n)]
        if not names:
            return 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        t0 = time.perf_counter()
        procs = []
        for name in names:
            tmp = BUILD_DIR / f"lib{name}.tmp{os.getpid()}.so"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
            procs.append((name, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            )))
        errors = []
        for name, tmp, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{SOURCES[name]}:\n{out.decode(errors='replace')}")
            else:
                os.replace(tmp, _lib_path(name))
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        return time.perf_counter() - t0


_P = ctypes.c_void_p
_I = ctypes.c_int
# library -> {exported function: its argument types}
_ARGTYPES = {
    "int8_coarse": {
        "omni_int8_coarse": [
            _P, _P, _P, _P, _P, _P,               # emb8 q8 add scale qs qb
            _P, _P,                               # out vals, out idxs
            _I, _I, _I, _I, _I, _I,               # n d b sub t1 packed
            _P,                                   # stream
        ],
        "omni_int8_coarse_query_tile": [_I, _I, _I, _I],  # d sub t1 packed
    },
    "int8_scan": {
        "omni_int8_coarse_topt": [
            _P, _P, _P, _P, _P, _P,               # emb8 q8 add scale qs qb
            _P, _P,                               # out vals, out idxs
            _I, _I, _I, _I, _I, _I,               # n d b sub t1 packed
            _P,                                   # stream
        ],
        "omni_int8_fused_topt": [
            _P, _P, _P, _P, _P, _P, _P, _P, _P,   # emb8 bloom q8 kw8 kw_b add scale qs qb
            _P, _P,                               # out vals, out idxs
            _I, _I, _I, _I, _I, _I, _I,           # n d w b sub t1 packed
            _P,                                   # stream
        ],
        "omni_int8_scan_query_tile": [_I, _I, _I],  # sub d w
        "omni_int8_kw_topt": [
            _P, _P, _P, _P,                       # bloom kw8 kw_b add
            _P, _P,                               # out vals, out idxs
            _I, _I, _I, _I, _I, _I,               # n w b sub t1 packed
            _P,                                   # stream
        ],
        "omni_int8_kw_query_tile": [_I, _I],      # sub w
        "omni_int8_probe": [
            _P, _P, _P, _P, _P, _P,               # emb8 bloom q8 kw8 add out
            _I, _I, _I, _I, _I,                   # n d w b transposed
            _P,                                   # stream
        ],
        "omni_int8_pipe_topt": [
            _P, _P, _P, _P, _P, _P,               # emb8 q8 add scale qs qb
            _P, _P,                               # out vals, out idxs
            _I, _I, _I, _I, _I, _I, _I,           # n d b sub t1 packed groups
            _P,                                   # stream
        ],
        "omni_int8_pipe_tile": [_I, _I],          # sub d
        "omni_int8_keys_emit": [
            _P, _P, _P, _P,                       # emb8 q8 scale qs
            _P, _P,                               # out vals, out keys (or idxs)
            _I, _I, _I, _I, _I, _I, _I,           # n d b c sub t1 emit
            _P,                                   # stream
        ],
    },
    "fp_scan": {
        "omni_fp_scan_topt": [
            _P, _P, _P, _P, _P,                   # emb bloom qkw kw_b add
            _P, _P,                               # out vals, out idxs
            _I, _I, _I, _I, _I, _I, _I, _I, _I,   # n d w b bp sub t1 packed bf16
            _P,                                   # stream
        ],
        "omni_fp_scan_probe": [
            _P, _P, _P, _P, _P,                   # emb bloom qkw kw_b add
            _P,                                   # out
            _I, _I, _I, _I, _I, _I, _I,           # n d w b bp c variant
            _P,                                   # stream
        ],
        "omni_fp_scan_query_tile": [_I, _I, _I, _I],  # variant rows d w
    },
    "dd_rows": {
        "omni_dd_rows": [
            _P, _P, _P, _P, _P, _P,               # raw rows q hi lo sabs
            _I, _I, _I, _I,                       # n d b t
            _P,                                   # stream
        ],
        "omni_dd_rows_gathered": [
            _P, _P, _P, _P, _P,                   # c q hi lo sabs
            _I, _I, _I,                           # d b t
            _P,                                   # stream
        ],
    },
    "refine": {
        "omni_refine": [
            _P, _P, _P, _P, _P, _P, _P, _P,       # emb1 emb2 bloom scale1 scale2 err2 valid created
            _P, _P, _P,                           # q kw_w8 kw_b
            _P, _P,                               # rows vals (row-strided)
            _P,                                   # out
            ctypes.c_float,                       # now (days)
            _I, _I, _I, _I, _I, _I, _I,           # n d w b m rows_stride vals_stride
            _P,                                   # stream
        ],
        "omni_recency": [_P, _P, ctypes.c_float, _I, _I, _P],  # created out now n exp_only stream
        "omni_refine_slab": [
            _P, _P, _P, _P, _P, _P, _P, _P,       # q1 q2 t1 t2 eq2 qn kwb kw_w8
            _P, _P, _P, _P, _P, _P, _P,           # c1 c2 bloom s1 s2 ec2 add
            _P,                                   # out
            _I, _I, _I, _I, _I,                   # b d w m qg
            _P,                                   # stream
        ],
    },
}


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built first if stale)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all()
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn_name, argtypes in _ARGTYPES[name].items():
                fn = getattr(lib, fn_name)
                fn.restype = ctypes.c_int
                fn.argtypes = argtypes
            _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise for a launcher's non-zero return: a CUDA error code from
    ``cudaGetLastError`` right after the launch, or -1 for a shape the
    kernel does not take (the wrapper checks shapes first, so -1 means the
    two disagree)."""
    if rc == 0:
        return
    if rc == -1:
        raise ValueError(f"{what}: shape not supported by the CUDA kernel")
    fn = lib.omni_cuda_error_string
    fn.restype = ctypes.c_char_p
    fn.argtypes = [ctypes.c_int]
    raise RuntimeError(
        f"{what}: CUDA launch failed: {fn(rc).decode(errors='replace')} ({rc})"
    )


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
