"""Build a shared library from the checkout's sources at first use.

The library lands in the package's gitignored ``_build/`` directory,
named by a hash of its sources and flags, so a changed source builds
anew and a stale library is never loaded. Each build goes to a
temporary name and is renamed into place, so processes that build at
the same time (pytest workers) never load a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

from . import tracing

BUILD_DIR = Path(__file__).resolve().parent / "_build"
REPO_ROOT = Path(__file__).resolve().parent.parent


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on the PATH, else under ``CUDA_HOME``
    (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def library_path(name: str, compiler: str, sources: list[Path],
                 flags: list[str]) -> Path:
    """Where ``build_shared`` puts this library:
    ``_build/lib<name>-<hash of the sources and flags>.so``."""
    h = hashlib.sha256()
    for src in sources:
        h.update(Path(src).read_bytes())
    h.update(" ".join([compiler, *flags]).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_shared(name: str, compiler: str, sources: list[Path],
                 flags: list[str], timeout: float = 600.0) -> Path:
    """Compile ``sources`` with ``compiler`` into ``library_path(...)``
    unless that file exists; returns its path. Raises if the compiler is
    missing or fails."""
    exe = shutil.which(compiler)
    if exe is None:
        raise RuntimeError(f"{compiler} not found: cannot build lib{name}")
    out = library_path(name, compiler, sources, flags)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [exe, *flags, "-o", tmp, *(str(s) for s in sources)],
            capture_output=True, text=True, timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building lib{name} failed ({proc.returncode}):\n"
                f"{proc.stderr[-4000:]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load_library(name: str, compiler: str, sources: list[Path],
                 flags: list[str]) -> ctypes.CDLL:
    """``build_shared``, then load the library; recorded as a
    ``kernel_load`` span (tracing.py), ``built`` 1 where it compiled and
    0 where it loaded from ``_build/``."""
    built = int(not library_path(name, compiler, sources, flags).exists())
    with tracing.span("kernel_load", built=built):
        return ctypes.CDLL(str(build_shared(name, compiler, sources,
                                            flags)))


def lazy_cuda_library(name: str, sources: list[Path], flags: list[str],
                      bind):
    """A function that returns the ctypes library built from ``sources``
    with nvcc (``build_shared``) and set up by ``bind(lib)`` (argument
    and result types), building and loading it at its first call, once
    a process and thread-safe. Raises if the build fails."""
    lib = None
    lock = threading.Lock()

    def load():
        nonlocal lib
        if lib is None:
            with lock:
                if lib is None:
                    loaded = load_library(name, nvcc_path(), sources,
                                          flags)
                    bind(loaded)
                    lib = loaded
        return lib

    return load
