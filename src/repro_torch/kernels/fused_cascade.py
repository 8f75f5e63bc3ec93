"""The fused BoundedME cascade kernel (fp32 tier): build, binding, wrapper.

The kernel is hand-written CUDA C++ in ``csrc/fused_cascade.cu``; its
source note says what it replaces (``fused_cascade_batched_pallas`` of
the JAX package), what bounds it and what its design does.  It is
compiled by ``nvcc`` for ``sm_90a`` at first use into ``build/`` beside
this file (git-ignored), as a shared library with a plain C interface,
and bound with ``ctypes``.  Nothing here imports or builds anything when
the module is imported.

`fused_cascade_batched_cuda` launches the kernel on CUDA tensors and
raises on anything else; `repro_torch.kernels.ops.fused_cascade_batched`
chooses between it and the plain PyTorch version by the tensors' device.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

__all__ = ["build", "fused_cascade_batched_cuda", "launch_counts",
           "reset_launch_counts", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_cascade.cu"
_BUILD_DIR = SOURCE.parent.parent / "build"

#: launches per kernel wrapper; each wrapper adds one where it launches
_launches: Dict[str, int] = {"fused_cascade_batched": 0}


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
                           "toolkit is needed to build the kernel")
    return found


def build() -> Tuple[Path, str]:
    """Compile the kernel unless a build of this exact source exists.

    Returns ``(library path, ptxas report)``; the report is empty when
    the library was already built.  The library's name carries a hash of
    the source, and it is written under a temporary name and renamed, so
    concurrent processes never load a half-written or stale library.
    """
    src = SOURCE.read_bytes()
    tag = hashlib.sha1(src).hexdigest()[:12]
    out = _BUILD_DIR / f"libfused_cascade_{tag}.so"
    if out.exists():
        return out, ""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stderr


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_cascade_batched_f32.argtypes = (
        [p] * 11 + [i] * 10 + [ctypes.c_longlong, i, i, p])
    lib.fused_cascade_batched_f32.restype = i
    lib.fused_cascade_error_string.argtypes = [i]
    lib.fused_cascade_error_string.restype = ctypes.c_char_p
    return lib


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, V4 on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fused_cascade_batched_cuda(V4: torch.Tensor, Qb: torch.Tensor,
                               slotcode: torch.Tensor,
                               rounds_meta: torch.Tensor,
                               cols: torch.Tensor, *, n_arms: int, K: int,
                               t_final: int, n_final: int,
                               k_out: Optional[int] = None,
                               n_valid: Optional[int] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the fused cascade on CUDA tensors (one launch per batch).

    Operands as in `repro_torch.kernels.ops.fused_cascade_batched`:
    ``V4 (n_tiles, n_blocks, R, C)`` and ``Qb (B, n_blocks, C)`` float32,
    ``slotcode (S,)``, ``rounds_meta (n_rounds + 1, 3)`` and ``cols (B,
    S)`` int32 (`repro_torch.core.schedule.FlatSchedule.packed`), all
    contiguous on one CUDA device.  Returns ``(ids (B, k_out) int32,
    vals (B, k_out) float32)``, vals being unscaled block means.
    """
    if not V4.is_cuda:
        raise ValueError(f"the CUDA kernel needs CUDA tensors, V4 is on "
                         f"{V4.device}")
    dev = V4.device
    _check("V4", V4, torch.float32, 4, dev)
    _check("Qb", Qb, torch.float32, 3, dev)
    _check("slotcode", slotcode, torch.int32, 1, dev)
    _check("rounds_meta", rounds_meta, torch.int32, 2, dev)
    _check("cols", cols, torch.int32, 2, dev)
    n_tiles, n_blocks, R, C = V4.shape
    B, S = cols.shape
    if Qb.shape != (B, n_blocks, C):
        raise ValueError(f"Qb shape {tuple(Qb.shape)} != {(B, n_blocks, C)}")
    if slotcode.shape[0] != S:
        raise ValueError(f"slotcode has {slotcode.shape[0]} steps, cols {S}")
    if rounds_meta.shape[1] != 3 or rounds_meta.shape[0] < 1:
        raise ValueError(f"rounds_meta must be (n_rounds + 1, 3), got "
                         f"{tuple(rounds_meta.shape)}")
    if not 1 <= R <= 32:
        raise ValueError(f"tile rows R={R} outside [1, 32]")
    if not 1 <= n_final <= n_tiles:
        raise ValueError(f"n_final={n_final} outside [1, n_tiles={n_tiles}]")
    k_out = K if k_out is None else int(k_out)
    if not 1 <= k_out <= n_final * R:
        raise ValueError(f"k_out={k_out} outside [1, n_final*R="
                         f"{n_final * R}]")
    n_valid = n_arms if n_valid is None else int(n_valid)
    P = _next_pow2(max(n_tiles, n_final * R, 1))
    vec = int(R == 8 and C in (128, 256, 512)
              and V4.data_ptr() % 16 == 0 and Qb.data_ptr() % 16 == 0)
    ids = torch.empty((B, k_out), dtype=torch.int32, device=dev)
    vals = torch.empty((B, k_out), dtype=torch.float32, device=dev)
    acc = torch.empty((B, n_tiles, R), dtype=torch.float32, device=dev)
    surv = torch.empty((B, n_tiles), dtype=torch.int32, device=dev)
    tmp = torch.empty((B, n_tiles), dtype=torch.int32, device=dev)
    keys = torch.empty((B, P), dtype=torch.int64, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_cascade_batched_f32(
            V4.data_ptr(), Qb.data_ptr(), slotcode.data_ptr(),
            rounds_meta.data_ptr(), cols.data_ptr(), ids.data_ptr(),
            vals.data_ptr(), acc.data_ptr(), surv.data_ptr(), tmp.data_ptr(),
            keys.data_ptr(), B, n_tiles, n_blocks, R, C, S,
            rounds_meta.shape[0] - 1, int(t_final), int(n_final), k_out,
            n_valid, P, vec, stream)
    if rc != 0:
        msg = lib.fused_cascade_error_string(rc).decode()
        raise RuntimeError(f"fused_cascade_batched launch failed: {msg} "
                           f"(cudaError {rc})")
    _launches["fused_cascade_batched"] += 1
    return ids, vals
