r"""
Builds the package's CUDA kernels with ``nvcc`` and loads them with ctypes.

Every ``csrc/*.cu`` is compiled, at first use, into one shared library
with a plain C interface, for Hopper only
(``-gencode arch=compute_90a,code=sm_90a``). The library goes into
``build/kernels/`` beside the package, named by a hash of the sources and
the flags, so an edited source is rebuilt and an unchanged one is not.
Nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# restype, argtypes of every exported C function.
SIGNATURES = {
    "virtex_attention_fwd": (
        _I, [_P, _P, _P, _P, _P,            # q, k, v, mask, out
             _I, _I, _I, _I, _I, _I,        # B, Tq, Tk, N, D, is_bf16
             _LL, _LL, _LL, _LL, _LL, _LL,  # q and k strides (b, t, n)
             _LL, _LL, _LL,                 # v strides
             _LL, _LL, _LL, _LL,            # mask strides (b, h, q, k)
             ctypes.c_float, ctypes.c_float,    # scale, rate
             ctypes.c_uint32, ctypes.c_uint32,  # threshold, seed
             _P]),                              # stream
    "virtex_attention_fwd_smem_bytes": (ctypes.c_ulonglong, [_I, _I]),
    "virtex_cuda_error_string": (ctypes.c_char_p, [_I]),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build
build_log = ""                         # nvcc's stderr (ptxas register use)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the CUDA kernels")
    return found


def _sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libvirtex_kernels_{digest.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    global build_seconds, build_log
    out.parent.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in sorted(CSRC.glob("*.cu"))]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, *cu]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    build_seconds = time.perf_counter() - t0
    build_log = proc.stderr


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            for name, (restype, argtypes) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = library().virtex_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
