"""Optional C++ accelerators, loaded via ctypes.

The reference offloads its hot host-side loops to external C++ libraries
(bioparser's zlib parsing, edlib's Myers bit-vector edit distance).  Here
the equivalents are small first-party C++ files compiled lazily with g++
into a shared object; everything has a numpy fallback so the package works
without a toolchain.  This package carries the sources its modules call:
the FASTA/FASTQ parser, Myers edit distance, anchor chaining and the
segment packer of the device index.

The library is built into the checkout's `build/native/` directory under a
name of its own (libraven_torch_native.so), so this package and raven_tpu
never overwrite each other's build.  Concurrent first uses (test workers)
each compile to a private file and publish it with an atomic rename.
"""

from __future__ import annotations

import os
import subprocess
import sys
from ctypes import CDLL

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(os.path.dirname(_SRC_DIR))
_LIB = None
_LIB_TRIED = False
LIB_NAME = "libraven_torch_native.so"


def build_dir() -> str:
    return os.path.join(REPO_ROOT, "build", "native")


def _sources() -> list[str]:
    return [
        os.path.join(_SRC_DIR, f)
        for f in sorted(os.listdir(_SRC_DIR))
        if f.endswith(".cc")
    ]


def build() -> str:
    """Compile the library if it is missing or older than its sources;
    returns its path.  Raises on a compile error."""
    srcs = _sources()
    os.makedirs(build_dir(), exist_ok=True)
    so_path = os.path.join(build_dir(), LIB_NAME)
    newest_src = max(os.path.getmtime(s) for s in srcs)
    if os.path.exists(so_path) and os.path.getmtime(so_path) >= newest_src:
        return so_path
    tmp = f"{so_path}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        "-pthread", *srcs, "-o", tmp, "-lz",
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so_path


def get_lib() -> CDLL | None:
    """Compile (once) and load the native library; None if unavailable."""
    global _LIB, _LIB_TRIED
    if _LIB is not None or _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    try:
        so_path = build()
    except (OSError, subprocess.SubprocessError) as e:
        print(f"[raven_tpu_torch::native] build skipped: {e}", file=sys.stderr)
        return None
    try:
        _LIB = CDLL(so_path)
    except OSError:
        _LIB = None
    return _LIB
