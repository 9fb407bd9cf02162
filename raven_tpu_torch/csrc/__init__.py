"""CUDA kernel sources and their builder.

Each `<name>.cu` here is compiled by nvcc for sm_90a into a shared library
with a plain C interface (`build/cuda/lib<name>.so` at the root of the
checkout) and loaded with ctypes.  `load` builds a library at first use, and
again when its source is newer than it; `build_all` starts one nvcc per
source at once and waits for them all.  Any failure to find nvcc, compile
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
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

# the shared memory an H100 block may have, static and dynamic: each
# wrapper's launch_plan sizes its routes by it
SMEM_BYTES = 227 * 1024
_LIBS: dict[str, ctypes.CDLL] = {}
# seconds from the start of a build_all call to each library's finish in
# this process (absent when the library was already up to date), and what
# ptxas said of each kernel's registers, shared memory and spills
BUILD_SECONDS: dict[str, float] = {}
BUILD_LOG: dict[str, str] = {}


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


def _stale(name: str) -> bool:
    so, src = _lib_path(name), source(name)
    return not (os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src))


def build_all(names) -> None:
    """Compile every `<name>.cu` whose library is older than its source,
    one nvcc process per source, all started together."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return
    os.makedirs(build_dir(), exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = f"{_lib_path(name)}.{os.getpid()}.tmp"
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, source(name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    try:
        for name, (tmp, proc) in procs.items():
            out, _ = proc.communicate(timeout=600)
            BUILD_LOG[name] = out
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {source(name)} ({proc.returncode}):\n{out}")
                continue
            os.replace(tmp, _lib_path(name))
            BUILD_SECONDS[name] = time.perf_counter() - t0
    finally:
        for tmp, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `<name>.cu`, built first when needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all([name])
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
