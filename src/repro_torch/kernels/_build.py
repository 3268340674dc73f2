"""Build the port's CUDA sources on first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, ``_build/lib<name>-<digest>.so`` inside
the package (the directory is git-ignored).  The digest covers the sources
and the flags, so an edited source builds anew and a stale library is never
loaded.  Nothing is compiled at import: the first kernel call builds, or a
caller builds every source up front with :func:`build_all`, which starts
one ``nvcc`` per source at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
SOURCES = ("flash_attention_fwd", "ssd_fwd", "rglru_fwd", "kronecker_gen")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: compiler output of the builds this process ran (ptxas register and
#: shared-memory usage per kernel), keyed by source name
build_log: Dict[str, str] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on the PATH,
    or the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names: Iterable[str] = SOURCES) -> float:
    """Compile every listed source that has no up-to-date library, all
    ``nvcc`` processes at once; returns the seconds taken.  Raises
    RuntimeError with the compiler's output if a build fails."""
    t0 = time.monotonic()
    with _lock:
        todo = [n for n in names if not library_path(n).exists()]
        if not todo:
            return 0.0
        BUILD.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        procs = {}
        for n in todo:
            tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for n, (tmp, p) in procs.items():
            out, _ = p.communicate()
            build_log[n] = out
            if p.returncode != 0:
                failed.append(f"{n}.cu (exit {p.returncode}):\n{out}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, library_path(n))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.monotonic() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib: Optional[ctypes.CDLL] = _libs.get(name)
    if lib is None:
        build_all([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
    return lib
