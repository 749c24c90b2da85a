r"""
Builds the package's CUDA kernels with ``nvcc`` and loads them with ctypes.

Every ``csrc/*.cu`` is compiled, at first use, for Hopper only
(``-gencode arch=compute_90a,code=sm_90a``): one ``nvcc`` per source, all
started together, then one link into a shared library with a plain C
interface. The library goes into ``build/kernels/`` beside the package,
named by a hash of the sources and the flags, so an edited source is
rebuilt and an unchanged one is not. Nothing here runs when the module is
imported.
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F, _U32 = ctypes.c_float, ctypes.c_uint32
_FWD = [_P, _P, _P, _P, _P,                # q, k, v, mask, out
        _I, _I, _I, _I, _I]                 # B, Tq, Tk, N, D
_FWD_REST = [_LL, _LL, _LL, _LL, _LL, _LL,  # q and k strides (b, t, n)
             _LL, _LL, _LL,                 # v strides
             _LL, _LL, _LL, _LL,            # mask strides (b, h, q, k)
             _F, _F, _U32,                  # scale, rate, threshold
             _P, _P]                        # seed (int64 on the card), stream
_BWD = [_P, _P, _P, _P, _P,                 # q, k, v, mask, g
        _P, _P, _P,                         # dq, dk, dv
        _I, _I, _I, _I, _I]                 # B, Tq, Tk, N, D
_BWD_REST = [_LL, _LL, _LL, _LL, _LL, _LL,  # q and k strides (b, t, n)
             _LL, _LL, _LL, _LL, _LL, _LL,  # v and g strides
             _LL, _LL, _LL, _LL,            # mask strides (b, h, q, k)
             _F, _F, _U32,                  # scale, rate, threshold
             _P, _P]                        # seed, stream
# restype, argtypes of every exported C function; the scalar variants take
# is_bf16 after D.
SIGNATURES = {
    "virtex_attention_fwd": (_I, _FWD + [_I] + _FWD_REST),
    "virtex_attention_fwd_mma": (_I, _FWD + _FWD_REST),
    "virtex_attention_fwd_smem_bytes": (ctypes.c_ulonglong, [_I, _I]),
    "virtex_attention_bwd": (_I, _BWD + [_I] + _BWD_REST),
    "virtex_attention_bwd_mma": (_I, _BWD + _BWD_REST),
    "virtex_attention_bwd_smem_bytes": (ctypes.c_ulonglong, [_I, _I, _I]),
    "virtex_attention_bwd_mma_smem_bytes": (ctypes.c_ulonglong,
                                            [_I, _I, _I]),
    "virtex_bn_backward_sums": (
        _I, [_P, _P, _P, _P,                # dy, x, mean, rstd
             _P, _P, _P,                    # partial (chunks, 2, C), tickets,
                                            # out
             _LL, _I, _I, _I,               # M, C, chunks, vec
             _I, _I,                        # dy_is_bf16, x_is_bf16
             _P]),                          # stream
    "virtex_bn_backward_dx": (
        _I, [_P, _P, _P, _P, _P, _P,        # dy, x, mean, rstd, weight, sums
             _P,                            # dx
             _LL, _I, _LL, _I, _I,          # M, C, m_total, chunks, vec
             _I, _I,                        # dy_is_bf16, x_is_bf16
             _P]),                          # stream
    "virtex_bn_forward_stats": (
        _I, [_P, _P, _P, _P,                # x, partial (chunks, 2, C),
                                            # tickets, out
             _P, _P, _P,                    # running mean, var, count
             _LL, _I, _I, _I,               # M, C, chunks, vec
             _F, _I,                        # eps, finalise
             _F, _F, _F,                    # momentum, 1 − momentum, bessel
             _I, _P]),                      # x_is_bf16, stream
    "virtex_bn_forward_apply": (
        _I, [_P, _P, _P, _P, _P, _P,        # x, mean, rstd, weight, bias, y
             _LL, _I, _I, _I,               # M, C, chunks, vec
             _I, _I,                        # x_is_bf16, y_is_bf16
             _P]),                          # stream
    "virtex_decode_attention": (
        _I, [_P, _P, _P, _P,                # q, k, v, out
             _I, _I, _I, _I, _I,            # kv rows, rows per kv, n valid,
                                            # N, D
             _LL, _LL,                      # q strides (row, head)
             _LL, _LL, _LL, _LL, _LL, _LL,  # k and v strides (row, t, head)
             _F, _P]),                      # sqrt(D), stream
    "virtex_decode_attention_smem_bytes": (ctypes.c_ulonglong, [_I, _I]),
    "virtex_beam_select": (
        _I, [_P, _P, _P,                    # log-probs, last, scores
             _P, _P, _P,                    # scores, last and src out
             _I, _I, _I,                    # images, rows an image, V
             _LL, _LL,                      # image and row strides
             _I, _I, _I,                    # kept a row, an image; EOS
             _F, _F, _P]),                  # penalty, after-end, stream
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


def _run_all(cmds: list) -> list:
    """Start every command at once; wait for all; raise on the first that
    failed. Returns their stderr texts."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, proc, (_, err) in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{err}")
    return [err for _, err in outs]


def _compile(out: Path) -> None:
    global build_seconds, build_log
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmpdir:
        objs, cmds = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(tmpdir, src.stem + ".o")
            objs.append(obj)
            cmds.append([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", obj,
                         str(src)])
        logs = _run_all(cmds)
        tmp = os.path.join(tmpdir, out.name)
        _run_all([[nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                   "-shared", "-o", tmp, *objs]])
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)


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
