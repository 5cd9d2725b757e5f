"""Build, load and launch the port's hand-written CUDA kernels.

All ``csrc/*.cu`` sources compile with ``nvcc`` for ``sm_90a`` (one ``nvcc``
per source, all started together) and link into ONE shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so the build
takes seconds).  The build happens on first
use, into ``<package>/_build/`` (git-ignored), under a name keyed by the
sources' hash, so an edited source is rebuilt and concurrent processes
never load a half-written file (each builds to a private name and renames).

Every C entry point takes raw device pointers, sizes and the CUDA stream,
launches on that stream, allocates nothing, and returns
``cudaGetLastError()``; :class:`Kernel` raises on a non-zero result and
counts successful launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_lib: Optional[ctypes.CDLL] = None


def _sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc); set CUDA_HOME")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfpkernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a build of these sources exists; return the .so."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in srcs]
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for obj, src in zip(objs, srcs)]
    logs = [p.communicate()[0] for p in procs]
    try:
        if any(p.returncode != 0 for p in procs):
            raise RuntimeError("nvcc failed:\n" + "\n".join(logs))
        link = subprocess.run([_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}\n{link.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    if any(logs):
        print("".join(logs), end="")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.fp_error_string.argtypes = [ctypes.c_int]
        lib.fp_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


PTR = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float


class Kernel:
    """One C entry point of the library, with a count of its launches.

    ``launches`` goes up by one each time the kernel is launched and only
    then, so a run can show that it went through the kernel.
    ``source`` and ``replaces`` name the CUDA file and the Pallas kernel
    of the reference it stands in for.
    """

    def __init__(self, name: str, symbol: str, argtypes: List, source: str, replaces: str):
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes) + [PTR]  # trailing cudaStream_t
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            msg = library().fp_error_string(err).decode()
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: {msg} ({err})")
        self.launches += 1


KERNELS: Dict[str, Kernel] = {}


def register(kernel: Kernel) -> Kernel:
    KERNELS[kernel.name] = kernel
    return kernel


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def check_cuda_f32(name: str, *tensors: torch.Tensor) -> None:
    """The kernels take contiguous float32 CUDA tensors and nothing else."""
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernel takes float32, got {t.dtype}")
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
