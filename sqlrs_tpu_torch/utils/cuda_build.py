"""Build-at-first-use for the hand-written CUDA kernels in `csrc/`.

Each kernel source is a `.cu` file with a plain C entry point. It is
compiled with nvcc for Hopper (`sm_90a`) into a shared library under
`build/kernels/` at the repository root and loaded with ctypes. The
library's file name carries a hash of the source and the flags, so an edited
source never loads a stale build, and the build writes to a temporary name
first and renames, so two processes that build at once do not collide.

Nothing here runs when the package is imported: a kernel is built by the
first call that launches it on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: dict[str, ctypes.CDLL] = {}
# per kernel source: {"seconds": build time (0.0 when loaded from an earlier
# build), "log": nvcc's output, including -Xptxas -v register/smem counts}
BUILD_INFO: dict[str, dict] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def load_kernel_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of `csrc/<name>.cu`, built first if needed. A name
    may hold a subdirectory of csrc/ (`baseline/mxu_agg_v1`)."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = os.path.join(BUILD_DIR, f"lib{name.replace('/', '_')}_{digest[:12]}.so")
    info = {"seconds": 0.0, "log": ""}
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
            capture_output=True,
            text=True,
        )
        info["seconds"] = time.perf_counter() - t0
        info["log"] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{info['log']}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(out)
    _LOADED[name] = lib
    BUILD_INFO[name] = info
    return lib
