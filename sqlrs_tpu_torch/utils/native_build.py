"""Build-at-first-use for the host-side C++ helpers in `native/`.

Each helper (`native/csv_loader.cpp`, `native/interner.cpp`) is compiled
from the repository's source with `g++ -O2 -fPIC -std=c++17 -shared` into
`build/native/` at the repository root and loaded with ctypes. The file name
carries a hash of the source and the flags, so an edited source never loads
a stale build. The build runs under a lock (a thread lock and a lock file,
so two threads or two processes build once) and writes a temporary name
first and renames it. The libraries committed under `native/` are the JAX
package's and are never rebuilt here (`make -C native` would rewrite them).

Nothing here runs when the package is imported, and nothing needs g++ until
a helper is first used.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import threading

REPO_DIR = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
NATIVE_DIR = os.path.join(REPO_DIR, "native")
BUILD_DIR = os.path.join(REPO_DIR, "build", "native")
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")

_lock = threading.Lock()


def library_path(source: str, stem: str) -> str:
    """Where the build of `source` (a path) under the current flags lives:
    build/native/<stem>_<sha1 of source + flags>[:12].so."""
    with open(source, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"{stem}_{digest[:12]}.so")


def build(source: str, stem: str) -> str:
    """The path of `source`'s shared library, compiled first if needed.
    Raises when there is no g++ or the compile fails."""
    out = library_path(source, stem)
    if os.path.exists(out):
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no g++ on PATH")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with _lock, open(os.path.join(BUILD_DIR, f".{stem}.lock"), "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        if not os.path.exists(out):  # another process may have built it
            tmp = f"{out}.{os.getpid()}.tmp"
            subprocess.run(
                [cxx, *CXX_FLAGS, "-o", tmp, source],
                check=True,
                capture_output=True,
                timeout=120,
            )
            os.replace(tmp, out)
    return out
