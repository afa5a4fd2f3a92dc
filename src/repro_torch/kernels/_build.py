"""Build and load the CUDA kernels of ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under
``build/repro_torch/`` at the repository root; the libraries load through
``ctypes``. All sources compile in parallel on first use, one ``nvcc``
each. A library's file name carries the hash of its source, of the shared
headers (``csrc/*.cuh``) and of the flags, so a changed source or header
builds again and an unchanged one is loaded as it is.
What ``ptxas -v`` said of each (registers, spills) is kept beside it.

Nothing here runs at import: importing the package needs no ``nvcc`` and no
card.
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

__all__ = ["library", "build_all", "ptxas_log", "BUILD_DIR", "CSRC_DIR"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float

# source name -> (C entry point, argtypes); every entry returns cudaGetLastError()
_SIGNATURES = {
    "gather_combine": ("repro_gather_combine", (_P, _P, _P, _P, _I, _I, _I, _I64, _I, _P)),
    "attack": ("repro_attack", (_P, _P, _P, _I, _I, _I64, _I, _F, _I, _P)),
    "cwtm": ("repro_cwtm", (_P, _P, _I, _F, _P, _I, _I, _I64, _I, _F, _I, _I, _P)),
    "gram": ("repro_gram", (_P, _P, _P, _P, _I, _I, _I64, _I64, _I, _I, _I, _I, _I, _P)),
    "quantize": ("repro_quantize", (_P, _P, _P, _I64, _I64, _I64, _I, _I, _P)),
    "row_combine": ("repro_row_combine", (_P, _P, _P, _I, _I, _I64, _I, _I, _P)),
}

_lock = threading.Lock()
_entries: dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all() -> float:
    """Compile every kernel source whose library is missing, all at once.
    Returns the seconds spent (0.0 when everything was built already)."""
    missing = [name for name in _SIGNATURES if not _target(name).exists()]
    if not missing:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    start = time.perf_counter()
    procs = []
    for name in missing:
        out = _target(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name}.cu:\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return time.perf_counter() - start


def ptxas_log(name: str) -> str:
    """What ``ptxas -v`` said of the kernels of ``csrc/<name>.cu`` when its
    library was built (registers, shared memory, spills); builds first."""
    build_all()
    return _target(name).with_suffix(".log").read_text()


def library(name: str):
    """The C entry point of kernel ``name``, with its argtypes set; builds
    the kernels on first use."""
    with _lock:
        if name not in _entries:
            build_all()
            symbol, argtypes = _SIGNATURES[name]
            fn = getattr(ctypes.CDLL(str(_target(name))), symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _entries[name] = fn
        return _entries[name]
