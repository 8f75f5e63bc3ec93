"""Build, load and count the port's hand-written CUDA kernels.

Each kernel is one CUDA C++ source under ``csrc/`` with a plain C
interface.  `build` compiles a source with ``nvcc`` for ``sm_90a`` at
first use into ``build/`` beside this file (git-ignored), as a shared
library whose name carries a hash of the source; `load` opens it with
``ctypes``.  Nothing here runs when the module is imported.

The launch counts of every kernel wrapper live here too: a wrapper adds
one to its names (`count`) where it launches its kernel, and nowhere
else; so do the word a launch writes its grid into (`GridWord`) and the
occupancy query of a source's ``<entry>_config``.  A wrapper makes its
operands' card current (`on_device`), so a call on any card launches
there, and checks that card right before the C entry
(`require_current`).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

__all__ = ["CSRC", "build", "load", "check_launch", "register", "count",
           "launch_counts", "reset_launch_counts", "on_device",
           "require_current",
           "occupancy", "GridWord"]

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


def on_device(device: torch.device):
    """A context in which ``device`` is the current CUDA device (no switch
    where it already is)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def require_current(device: torch.device) -> None:
    """Raise unless ``device`` is the current CUDA device.

    A C entry reads the SM count and shared-memory limit of the current
    device (``cudaGetDevice``) and launches on its stream, so a launch
    whose operands lie on another card would run there with the wrong
    geometry.  Each wrapper calls this inside its `on_device` context,
    right before the C entry.
    """
    current = torch.cuda.current_device()
    if device.index is not None and device.index != current:
        raise ValueError(f"kernel operands are on {device} but the current "
                         f"device is cuda:{current}; launch under "
                         f"torch.cuda.device({device})")


def occupancy(lib: ctypes.CDLL, entry: str, device: torch.device,
              *args: int) -> Tuple[int, int]:
    """``(SMs, CTAs per SM)`` from ``lib.<entry>(*args, &sms, &per_sm)`` on
    ``device``; raises where not one CTA fits."""
    sms, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = getattr(lib, entry)(*args, ctypes.byref(sms),
                                 ctypes.byref(per_sm))
    check_launch(lib, rc, entry)
    if per_sm.value < 1:
        raise RuntimeError(f"{entry}{args}: no CTA fits on an SM")
    return sms.value, per_sm.value


class GridWord:
    """One int32 word per device that a launch writes its own
    ``gridDim.x`` into, made zeroed at first use and kept for the
    process."""

    def __init__(self) -> None:
        self._words: Dict[torch.device, torch.Tensor] = {}

    def on(self, device: torch.device) -> torch.Tensor:
        word = self._words.get(device)
        if word is None:
            word = torch.zeros((1,), dtype=torch.int32, device=device)
            self._words[device] = word
        return word

    def read(self, device) -> int:
        """The CTA count of the last launch on ``device`` as the kernel
        read it from its own ``gridDim.x`` (0 when none launched since the
        last read), then cleared.  Waits for the card."""
        dev = torch.device(device)
        if dev.index is None:
            dev = torch.device(dev.type, torch.cuda.current_device())
        word = self.on(dev)
        n = int(word.item())
        word.zero_()
        return n
