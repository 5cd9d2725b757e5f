"""ctypes binding to the repository's native image decoder (``native/io.cpp``,
built with ``make -C native`` into ``native/libfpio.so`` beside the packages).

Decode of PNG and JPEG (format sniffed from the magic bytes), center crop and
area resample in C++, a batch decoded on C++ threads outside the GIL with one
ctypes call.  Absent library or entry point: ``*_available()`` is False and
callers decode with PIL (``utils/image.py``), as the reference package does.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _lib_path() -> str:
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), "native", "libfpio.so")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if not os.path.exists(_lib_path()):
        return None
    try:
        lib = ctypes.CDLL(_lib_path())
    except OSError:
        return None
    # the decoders may be absent in a library built before they were added
    for one, batch in (("fpio_load_png_rgb", "fpio_load_png_rgb_batch"),
                       ("fpio_load_image_rgb", "fpio_load_image_rgb_batch")):
        if hasattr(lib, one):
            getattr(lib, one).argtypes = [ctypes.c_char_p, ctypes.c_int, _U8P]
            getattr(lib, one).restype = ctypes.c_int
            getattr(lib, batch).argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, _U8P, ctypes.c_int]
            getattr(lib, batch).restype = ctypes.c_int
    _LIB = lib
    return _LIB


def read_available() -> bool:
    """The library is built and has the PNG decoder."""
    lib = _load()
    return lib is not None and hasattr(lib, "fpio_load_png_rgb")


def image_read_available() -> bool:
    """The library is built and has the PNG + JPEG decoder."""
    lib = _load()
    return lib is not None and hasattr(lib, "fpio_load_image_rgb")


def _one(symbol: str, path: str, target: int) -> np.ndarray:
    lib = _load()
    if lib is None or not hasattr(lib, symbol):
        raise RuntimeError(f"native decoder {symbol} not built (make -C native)")
    out = np.empty((target, target, 3), dtype=np.uint8)
    rc = getattr(lib, symbol)(path.encode(), target, out.ctypes.data_as(_U8P))
    if rc != 0:
        raise IOError(f"{symbol} failed with code {rc} for {path}")
    return out


def _batch(symbol: str, paths: Sequence[str], target: int, n_threads: int) -> np.ndarray:
    lib = _load()
    if lib is None or not hasattr(lib, symbol):
        raise RuntimeError(f"native decoder {symbol} not built (make -C native)")
    paths = list(paths)
    out = np.empty((len(paths), target, target, 3), dtype=np.uint8)
    if not paths:
        return out
    buf = b"\0".join(p.encode() for p in paths) + b"\0"
    rc = getattr(lib, symbol)(buf, len(paths), target, out.ctypes.data_as(_U8P), int(n_threads))
    if rc != 0:
        raise IOError(f"{symbol} failed with code {rc}")
    return out


def load_png_rgb(path: str, target: int) -> np.ndarray:
    """A PNG -> [target, target, 3] uint8, center-cropped and area-resampled."""
    return _one("fpio_load_png_rgb", path, target)


def load_image_rgb(path: str, target: int) -> np.ndarray:
    """A PNG or JPEG -> [target, target, 3] uint8 (JPEG through libjpeg's
    default IDCT, as PIL decodes it)."""
    return _one("fpio_load_image_rgb", path, target)


def load_png_rgb_batch(paths: Sequence[str], target: int, n_threads: int = 0) -> np.ndarray:
    """PNGs -> [n, target, target, 3] uint8 on ``n_threads`` C++ threads (0: all cores)."""
    return _batch("fpio_load_png_rgb_batch", paths, target, n_threads)


def load_image_rgb_batch(paths: Sequence[str], target: int, n_threads: int = 0) -> np.ndarray:
    """PNGs and JPEGs -> [n, target, target, 3] uint8 on C++ threads."""
    return _batch("fpio_load_image_rgb_batch", paths, target, n_threads)
