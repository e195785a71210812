"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface — no PyTorch headers, so a build
takes seconds — under ``build/repro_torch_kernels/`` at the root of the
checkout. The library name carries a hash of the source and the flags,
so an edited source is rebuilt and a built one is reused. All sources
not yet built compile in parallel, one ``nvcc`` each. A failed build
raises; nothing falls back to the plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
#: library -> {C function: argtypes}; every pointer and the stream are
#: c_void_p, every size c_int (c_longlong for a flat lane count), every
#: constant of the arithmetic c_float, every return a CUDA error code
SIGNATURES = {
    "sack": {
        "sack_advance_launch": (_P, _P, _P, _P, _P, _I, _I, _P),
        "sack_fused_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
        "sack_advance_own_launch": (_P,) * 8 + (_I, _I, _P),
        "sack_fused_own_launch": (_P,) * 11 + (_I, _I, _P),
    },
    "nack_mark": {
        "nack_mark_launch": (_P, _P, _P, _P, _I, _I, _I, _P),
        "nack_mark_lanes_launch": (_P,) * 6 + (_I,) * 5 + (_P,),
        "set_own_bit_launch": (_P, _P, _P, _P, _I, _I, _P),
        "clear_own_bit_launch": (_P, _P, _P, _I, _I, _P),
    },
    "nscc_update": {
        "nscc_update_launch": (_P, _P, _P, _P, _P, _L) + (_F,) * 7 + (_P,),
        "nscc_ack_launch": (_P,) * 7 + (_L,) + (_F,) * 8 + (_P,),
        "nscc_epoch_launch": (_P,) * 8 + (_L, _I, _I) + (_F,) * 3 + (_P,),
    },
    "ecmp_hash": {
        "ecmp_select_launch": (_P, _P, _P, _P, _P, _L, _I, _P),
        "ecmp_inject_launch": (_P, _L) * 3 + (_P, _L) + (_P,) * 3
        + (_I,) * 3 + (_P,),
        "ecmp_route_launch": (_P, _L) + (_P,) * 4 + (_I, _L) + (_P,) * 8
        + (_I,) * 10 + (_P,),
    },
}

_LIBS: "dict[str, ctypes.CDLL]" = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand is not None and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:12]}.so"


def build_all() -> "tuple[float, dict[str, str]]":
    """Compile every kernel library not built yet, all ``nvcc`` processes
    started together. Returns (seconds, {library: nvcc output})."""
    t0 = time.perf_counter()
    todo = [n for n in SIGNATURES if not library_path(n).exists()]
    logs: "dict[str, str]" = {}
    if not todo:
        return time.perf_counter() - t0, logs
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, out))
    failed = []
    for name, proc, tmp, out in jobs:
        logs[name], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)   # atomic: a concurrent loader never
        else:                      # sees a half-written library
            failed.append(f"{name}.cu: nvcc exited {proc.returncode}\n"
                          f"{logs[name]}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0, logs


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built first if needed), with
    every C function's argtypes and restype declared."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if not library_path(name).exists():
                build_all()
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
    return lib
