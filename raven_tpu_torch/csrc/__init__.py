"""CUDA kernel sources and their builder.

Each `<name>.cu` here is compiled by nvcc for sm_90a into a shared library
with a plain C interface (`build/cuda/lib<name>.so` at the root of the
checkout) and loaded with ctypes.  `load` builds a library at first use, and
again when its source is newer than it.  Any failure to find nvcc, compile
or load raises: there is no fallback to another implementation.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(os.path.dirname(_SRC_DIR))
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

_LIBS: dict[str, ctypes.CDLL] = {}
# seconds each library's nvcc build took in this process (absent when the
# library was already up to date)
BUILD_SECONDS: dict[str, float] = {}


def build_dir() -> str:
    return os.path.join(REPO_ROOT, "build", "cuda")


def source(name: str) -> str:
    return os.path.join(_SRC_DIR, f"{name}.cu")


def _lib_path(name: str) -> str:
    return os.path.join(build_dir(), f"lib{name}.so")


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def build(name: str) -> None:
    """Compile `<name>.cu` unless its library is newer than the source."""
    so, src = _lib_path(name), source(name)
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return
    os.makedirs(build_dir(), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
        capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {src} ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, so)
    BUILD_SECONDS[name] = time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `<name>.cu`, built first when needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build(name)
    lib = ctypes.CDLL(_lib_path(name))
    lib.raven_cuda_error_string.restype = ctypes.c_char_p
    lib.raven_cuda_error_string.argtypes = [ctypes.c_int]
    _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error."""
    if code != 0:
        msg = lib.raven_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
