r"""
The host data plane: JPEG decode, then crop, resize, flip, color jitter and
normalize in C++, bound with ctypes.

Counterpart of ``virtex_tpu/native``, with decoding split from the pixel
work so that the pixel work (``pixels.h``) is one code path whichever
decoder feeds it. There are two decoders, each a shared library of its own
with the same C interface:

- ``libjpeg`` (``dataplane_libjpeg.cpp``, linked with ``-ljpeg``): the
  JAX package's decoder, so equal bytes decode to equal pixels; the decoder
  wherever it is installed, on the CPU and beside a card alike;
- ``nvjpeg`` (``dataplane_nvjpeg.cpp``, the CUDA toolkit's nvJPEG): decodes
  on the card and copies the pixels back for the pixel work; the decoder of
  a CUDA run on a machine without libjpeg.

:func:`decoder_for` chooses once, by what the machine has. Nothing switches
decoders when the chosen one fails, and a missing decoder raises and names
what is missing.

A library is built at first use into ``build/native/`` beside the package,
named by a hash of its sources and flags, under an ``fcntl`` lock, written
to a temporary file and renamed into place, so processes that start
together build it once and never load a half-written file. Nothing here
runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import fcntl
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parents[1] / "build" / "native"
DECODERS = ("libjpeg", "nvjpeg")
_CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-fopenmp", "-std=c++17"]

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)
# (x/255 − 0) / (1/255): the pixel values themselves, as uint8 output takes
# them (the JAX package's emit_uint8 arguments).
RAW_MEAN = np.zeros(3, np.float32)
RAW_STD = np.full(3, 1 / 255.0, np.float32)

_P, _I, _SZ = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
_SIGNATURES = {
    "vdp_decoder_name": (ctypes.c_char_p, []),
    "vdp_last_error": (ctypes.c_char_p, []),
    "vdp_jpeg_dims": (_I, [_P, _SZ, _P, _P]),
    "vdp_decode": (_I, [_P, _SZ, _P, _SZ, _P, _P]),
    "vdp_batch_transform": (_I, [_P, _P, _P, _P, _P, _I, _I, _P, _P, _I, _P,
                                 _I]),
    "vdp_encode_jpeg": (_I, [_P, _I, _I, _I, _P, _SZ, _P]),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def decoder_for(device) -> str:
    """The decoder of a run on ``device``: libjpeg where it is installed,
    else nvJPEG for a CUDA device. Raises, naming what is missing, when
    neither is there."""
    kind = (device if isinstance(device, str) else device.type).split(":")[0]
    missing = _missing("libjpeg")
    if not missing:
        return "libjpeg"
    if kind == "cuda":
        nv_missing = _missing("nvjpeg")
        if not nv_missing:
            return "nvjpeg"
        missing += nv_missing
    raise RuntimeError(
        f"no JPEG decoder for a run on {kind}: libjpeg needs jpeglib.h and "
        "libjpeg.so (Debian/Ubuntu: libjpeg-dev)"
        + (", nvJPEG the CUDA toolkit's nvjpeg.h and libnvjpeg.so (set "
           "CUDA_HOME)" if kind == "cuda" else "")
        + f"; missing: {', '.join(missing)}")


def _cuda_home() -> Path:
    return Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda")


def _build_command(decoder: str, src: Path, out: str) -> list:
    cmd = ["g++", *_CXX_FLAGS, "-I", str(_HERE), str(src), "-o", out]
    if decoder == "libjpeg":
        return cmd + ["-ljpeg"]
    home = _cuda_home()
    lib = home / "lib64"
    return cmd + ["-I", str(home / "include"), "-L", str(lib),
                  f"-Wl,-rpath,{lib}", "-lnvjpeg", "-lcudart"]


def _missing(decoder: str) -> list:
    """What ``decoder`` needs and this machine lacks: header and library
    names, empty when it has both."""
    if decoder == "libjpeg":
        missing = [] if any(Path(d, "jpeglib.h").exists()
                            for d in ("/usr/include", "/usr/local/include")) \
            else ["jpeglib.h"]
        return missing + ([] if ctypes.util.find_library("jpeg")
                          else ["libjpeg.so"])
    home = _cuda_home()
    return [str(p) for p in (home / "include" / "nvjpeg.h",
                             home / "lib64" / "libnvjpeg.so")
            if not p.exists()]


def _require(decoder: str) -> None:
    """Raise, naming what is missing, when ``decoder``'s library or header
    is not on this machine."""
    missing = _missing(decoder)
    if not missing:
        return
    if decoder == "libjpeg":
        raise RuntimeError(
            "the libjpeg decoder needs libjpeg's header and library "
            "(jpeglib.h, libjpeg.so; Debian/Ubuntu: libjpeg-dev); missing: "
            f"{', '.join(missing)}")
    raise RuntimeError(
        "the nvjpeg decoder needs the CUDA toolkit's nvJPEG (set "
        f"CUDA_HOME); missing: {', '.join(missing)}")


def library_path(decoder: str) -> Path:
    src = _HERE / f"dataplane_{decoder}.cpp"
    digest = hashlib.sha256(" ".join(_CXX_FLAGS).encode())
    for path in (src, _HERE / "pixels.h"):
        digest.update(path.read_bytes())
    return BUILD_DIR / f"libvdp_{decoder}_{digest.hexdigest()[:16]}.so"


def _compile(decoder: str, out: Path) -> None:
    with tempfile.TemporaryDirectory(dir=out.parent) as tmpdir:
        tmp = os.path.join(tmpdir, out.name)
        proc = subprocess.run(
            _build_command(decoder, _HERE / f"dataplane_{decoder}.cpp", tmp),
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building the {decoder} data plane failed:\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)  # atomic: a loader sees all of it or nothing


def load(decoder: str) -> ctypes.CDLL:
    """``decoder``'s library, built at first use (see the module
    docstring)."""
    if decoder not in DECODERS:
        raise ValueError(f"unknown decoder {decoder!r}; known: {DECODERS}")
    with _lock:
        if decoder in _libs:
            return _libs[decoder]
        _require(decoder)
        path = library_path(decoder)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path.parent / ".lock", "w") as lock_file:
            fcntl.flock(lock_file, fcntl.LOCK_EX)  # released on close
            if not path.exists():
                _compile(decoder, path)
        lib = ctypes.CDLL(str(path))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _libs[decoder] = lib
        return lib


def jitter_params(order, brightness: float, contrast: float,
                  saturation: float, hue_shift: float) -> np.ndarray:
    """The 9 floats of one image's color jitter: enabled, the op order (a
    permutation of 0..3), the three factors and the hue shift (a fraction
    of the hue circle)."""
    return np.asarray([1.0, *[float(o) for o in order], brightness, contrast,
                       saturation, hue_shift], np.float32)


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


class DataPlane:
    """One decoder's library. ``threads`` is the OpenMP team of a batch
    call (0: one thread per core)."""

    def __init__(self, decoder: str, threads: int = 0):
        self.decoder = decoder
        self.threads = threads
        self._lib = load(decoder)

    def _error(self, what: str) -> str:
        detail = self._lib.vdp_last_error().decode()
        return f"{self.decoder}: {what}" + (f" ({detail})" if detail else "")

    def jpeg_dims(self, data: bytes) -> Tuple[int, int]:
        """(height, width) from a JPEG's header."""
        h, w = ctypes.c_int(), ctypes.c_int()
        rc = self._lib.vdp_jpeg_dims(data, len(data), ctypes.byref(h),
                                     ctypes.byref(w))
        if rc != 0:
            raise ValueError(self._error("not a decodable JPEG"))
        return h.value, w.value

    def decode(self, data: bytes) -> np.ndarray:
        """The whole image, RGB8 (H, W, 3)."""
        h, w = self.jpeg_dims(data)
        out = np.empty((h, w, 3), np.uint8)
        rc = self._lib.vdp_decode(data, len(data), _ptr(out), out.nbytes,
                                  ctypes.byref(ctypes.c_int()),
                                  ctypes.byref(ctypes.c_int()))
        if rc != 0:
            raise ValueError(self._error(f"decode failed (rc={rc})"))
        return out

    def batch_transform(self, blobs: Sequence[bytes], rects: np.ndarray,
                        flips: np.ndarray, out_size: int,
                        mean: np.ndarray = IMAGENET_MEAN,
                        std: np.ndarray = IMAGENET_STD,
                        jitters: Optional[np.ndarray] = None,
                        uint8: bool = False) -> np.ndarray:
        """Decode and transform a batch in one call: ``rects`` (N, 4) int
        (y, x, h, w; h or w ≤ 0 for the whole image), ``flips`` (N,),
        ``jitters`` (N, 9) from :func:`jitter_params` or None. Returns
        (N, out_size, out_size, 3) float32 (x/255 − mean)/std, or with
        ``uint8`` those values clipped to [0, 255] and truncated. Raises if
        any image fails."""
        n = len(blobs)
        bufs = (ctypes.c_char_p * n)(*blobs)
        lens = np.asarray([len(b) for b in blobs], np.uint64)
        rects = np.ascontiguousarray(rects, np.int32).reshape(n, 4)
        flips = np.ascontiguousarray(flips, np.int32).reshape(n)
        mean = np.ascontiguousarray(mean, np.float32)
        std = np.ascontiguousarray(std, np.float32)
        jit = (None if jitters is None
               else np.ascontiguousarray(jitters, np.float32).reshape(n, 9))
        out = np.empty((n, out_size, out_size, 3),
                       np.uint8 if uint8 else np.float32)
        failed = self._lib.vdp_batch_transform(
            ctypes.cast(bufs, ctypes.c_void_p), _ptr(lens), _ptr(rects),
            _ptr(flips), None if jit is None else _ptr(jit), n, out_size,
            _ptr(mean), _ptr(std), int(uint8), _ptr(out), self.threads)
        if failed:
            raise ValueError(self._error(
                f"decode/transform failed for {failed}/{n} images"))
        return out

    def encode_jpeg(self, rgb: np.ndarray, quality: int = 95) -> bytes:
        """An RGB8 (H, W, 3) image → JPEG bytes at ``quality``, 4:2:0."""
        rgb = np.ascontiguousarray(rgb, np.uint8)
        h, w, c = rgb.shape
        if c != 3:
            raise ValueError(f"expected (H, W, 3) RGB, got {rgb.shape}")
        cap = rgb.nbytes + (1 << 16)
        out = np.empty(cap, np.uint8)
        length = ctypes.c_size_t()
        rc = self._lib.vdp_encode_jpeg(_ptr(rgb), h, w, int(quality),
                                       _ptr(out), cap, ctypes.byref(length))
        if rc != 0:
            raise ValueError(self._error(f"encode failed (rc={rc})"))
        return out[:length.value].tobytes()
