"""The ctypes binding of the repository's C++ image loader
(`native/imloader/imloader.cpp`): its build, `decode_image` and
`native_available`. `imgproc` decodes JPEG through it, and the loader
class over it is `data/native_loader.NativeImageLoader`.

The library is a thread pool that decodes PNG or JPEG files (recognised by
their magic bytes), turns them gray (libjpeg's own `JCS_GRAYSCALE`
output, libpng's `rgb_to_gray`), shrinks them by truncating area bins
(`resize_to`: equal to OpenCV's INTER_AREA at integer factors only) and
fills a bounded prefetch queue that Python drains a batch at a time.

The source is compiled here, not by its Makefile: `g++ -O3 -fPIC -shared
-std=c++17 ... -ljpeg -lpng -lz -pthread` into `build/imloader/` at the
repository's root, the library named by a hash of the source and the
command, built on first use (never at import). A build needs g++ and the
`libjpeg` and `libpng` headers; when it fails, every call raises a
`RuntimeError` with the compiler's message, and `native_available()`
reports False. Nothing falls back to another decoder.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "native" / "imloader" / "imloader.cpp"
BUILD_DIR = ROOT / "build" / "imloader"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")
LIBS = ("-ljpeg", "-lpng", "-lz", "-pthread")

_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def library_path() -> Path:
    """Where the library of this source and these flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libimloader-{h.hexdigest()[:16]}.so"


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as err:
        raise RuntimeError(f"native imloader: cannot run g++: {err}") from err
    if proc.returncode != 0:
        raise RuntimeError(f"native imloader: {' '.join(cmd)} failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def load_library() -> ctypes.CDLL:
    """The library, built on first use; raises `RuntimeError` (the same
    message on every later call) when it cannot be built or loaded."""
    global _lib, _error
    if _lib is not None:
        return _lib
    if _error is not None:
        raise RuntimeError(_error)
    try:
        lib = ctypes.CDLL(str(_build()))
    except (RuntimeError, OSError) as err:
        _error = str(err)
        raise RuntimeError(_error) from err
    c_int, c_float_p = ctypes.c_int, ctypes.POINTER(ctypes.c_float)
    lib.iml_create.restype = ctypes.c_void_p
    lib.iml_create.argtypes = [ctypes.POINTER(ctypes.c_char_p)] + [c_int] * 6 + [ctypes.c_uint]
    lib.iml_next_batch.restype = c_int
    lib.iml_next_batch.argtypes = [ctypes.c_void_p, c_float_p, ctypes.POINTER(c_int), c_int]
    lib.iml_destroy.argtypes = [ctypes.c_void_p]
    lib.iml_decode_file.restype = c_int
    lib.iml_decode_file.argtypes = [ctypes.c_char_p, c_int, c_int, c_float_p]
    _lib = lib
    return lib


def native_available() -> bool:
    try:
        load_library()
        return True
    except RuntimeError:
        return False


def float_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def decode_image(path: str, out_h: int, out_w: int) -> np.ndarray:
    """One PNG or JPEG file -> (out_h, out_w, 1) float32 in [0, 1] through
    the library; raises `IOError` where it cannot decode the file."""
    out = np.empty((out_h, out_w), np.float32)
    if load_library().iml_decode_file(str(path).encode(), out_h, out_w, float_ptr(out)) != 0:
        raise IOError(f"native decode failed: {path}")
    return out[..., None]


__all__ = ["decode_image", "float_ptr", "load_library", "library_path", "native_available"]
