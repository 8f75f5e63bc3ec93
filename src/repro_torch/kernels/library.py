"""Build, load and count the port's hand-written CUDA kernels.

Each kernel is one CUDA C++ source under ``csrc/`` with a plain C
interface.  `build` compiles a source with ``nvcc`` for ``sm_90a`` at
first use into ``build/`` beside this file (git-ignored), as a shared
library whose name carries a hash of the source; `load` opens it with
``ctypes``.  Nothing here runs when the module is imported.

The launch counts of every kernel wrapper live here too: a wrapper adds
one to its names (`count`) where it launches its kernel, and nowhere
else.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Tuple

__all__ = ["CSRC", "build", "load", "check_launch", "register", "count",
           "launch_counts", "reset_launch_counts"]

CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = CSRC.parent / "build"

#: launches per counter name since the last reset
_launches: Dict[str, int] = {}


def register(names: Iterable[str]) -> None:
    """Add launch counters (at 0) for a kernel module's names."""
    for name in names:
        _launches.setdefault(name, 0)


def count(*names: str) -> None:
    """One launch under each of ``names``."""
    for name in names:
        _launches[name] += 1


def launch_counts() -> Dict[str, int]:
    """Kernel launches made through the wrappers since the last reset."""
    return dict(_launches)


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for name in _launches:
        _launches[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH); the CUDA "
                           "toolkit is needed to build the kernels")
    return found


def build(source: Path) -> Tuple[Path, str]:
    """Compile ``source`` unless a build of this exact source exists.

    Returns ``(library path, ptxas report)``; the report is empty when
    the library was already built.  The name hashes the source and the
    shared headers (``csrc/*.cuh``).  The library is written under a
    temporary name and renamed, so concurrent processes never load a
    half-written or stale library.
    """
    source = Path(source)
    digest = hashlib.sha1(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    tag = digest.hexdigest()[:12]
    out = _BUILD_DIR / f"lib{source.stem}_{tag}.so"
    if out.exists():
        return out, ""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stderr


@functools.lru_cache(maxsize=None)
def load(source: Path) -> ctypes.CDLL:
    """The built library of ``source``, opened once per process.  Every
    source exports ``cuda_error_string(int)``."""
    path, _ = build(source)
    lib = ctypes.CDLL(str(path))
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(lib: ctypes.CDLL, rc: int, name: str) -> None:
    """Raise when a C entry returned a cudaError_t other than 0."""
    if rc != 0:
        msg = lib.cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {rc})")
