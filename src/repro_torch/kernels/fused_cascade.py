"""The fused BoundedME cascade kernel: build, binding, wrapper.

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

__all__ = ["build", "fused_cascade_batched_cuda", "resolve_tier", "TIERS",
           "launch_counts", "reset_launch_counts", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_cascade.cu"
_BUILD_DIR = SOURCE.parent.parent / "build"

#: pull tiers, in the CUDA entry point's tier-code order
TIERS = ("fp32", "int8", "int4", "pq")

#: launches per kernel wrapper, and of this kernel per tier (``"int8"``, or
#: ``"int8+adaptive"`` with early exit); each wrapper adds one where it
#: launches its kernel
_launches: Dict[str, int] = dict.fromkeys(
    ["fused_cascade_batched"]
    + [f"fused_cascade_batched[{t}{a}]" for t in TIERS
       for a in ("", "+adaptive")], 0)


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
    lib.fused_cascade_batched.argtypes = (
        [i] * 3 + [p] * 18 + [i] * 15 + [ctypes.c_longlong, p])
    lib.fused_cascade_batched.restype = i
    lib.fused_cascade_error_string.argtypes = [i]
    lib.fused_cascade_error_string.restype = ctypes.c_char_p
    return lib


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, V4 on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if isinstance(shape, int):
        if t.dim() != shape:
            raise ValueError(f"{name} must have {shape} dims, got "
                             f"{tuple(t.shape)}")
    elif tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def resolve_tier(Cs: int, vscale, qscale, codebook, packed_int4: bool
                 ) -> Tuple[str, int]:
    """The pull tier of a cascade call and its true block width ``C``.

    ``Cs`` is the stored table's last dim; ``C`` (the denominators'
    width) is ``2 * Cs`` for nibble-packed int4, ``S * w`` from the
    codebook's shape for pq, ``Cs`` otherwise — as
    ``_resolve_qkind`` of the JAX package decides.
    """
    if codebook is not None:
        if vscale is not None or qscale is not None or packed_int4:
            raise ValueError("codebook (pq) excludes vscale/qscale/"
                             "packed_int4")
        return "pq", codebook.shape[1] * codebook.shape[3]
    if (vscale is not None) != (qscale is not None):
        raise ValueError("vscale and qscale must be passed together")
    if packed_int4:
        if vscale is None:
            raise ValueError("packed_int4 needs vscale/qscale (W4A8)")
        return "int4", 2 * Cs
    return ("int8" if vscale is not None else "fp32"), Cs


def fused_cascade_batched_cuda(V4: torch.Tensor, Qb: torch.Tensor,
                               slotcode: torch.Tensor,
                               rounds_meta: torch.Tensor,
                               cols: torch.Tensor, *, n_arms: int, K: int,
                               t_final: int, n_final: int,
                               k_out: Optional[int] = None,
                               n_valid: Optional[int] = None,
                               vscale: Optional[torch.Tensor] = None,
                               qscale: Optional[torch.Tensor] = None,
                               codebook: Optional[torch.Tensor] = None,
                               packed_int4: bool = False,
                               cert: Optional[torch.Tensor] = None,
                               k_cert: int = 1, track_var: bool = False):
    """Launch the fused cascade on CUDA tensors (one launch per batch).

    Operands as in `repro_torch.kernels.ops.fused_cascade_batched`, all
    contiguous on one CUDA device; the tier follows from them
    (`resolve_tier`).  Returns ``(ids (B, k_out) int32, vals (B, k_out)
    float32)``, vals being unscaled block means, and with ``cert`` also
    ``rounds_used (B,) int32``.
    """
    if not V4.is_cuda:
        raise ValueError(f"the CUDA kernel needs CUDA tensors, V4 is on "
                         f"{V4.device}")
    dev = V4.device
    tier, C = resolve_tier(V4.shape[-1], vscale, qscale, codebook,
                           packed_int4)
    _check("V4", V4, {"fp32": torch.float32, "pq": torch.uint8}.get(
        tier, torch.int8), 4, dev)
    n_tiles, n_blocks, R, Cs = V4.shape
    B, S = cols.shape
    _check("Qb", Qb, torch.int8 if tier in ("int8", "int4")
           else torch.float32, (B, n_blocks, C), dev)
    _check("slotcode", slotcode, torch.int32, (S,), dev)
    _check("rounds_meta", rounds_meta, torch.int32, 2, dev)
    _check("cols", cols, torch.int32, 2, dev)
    if rounds_meta.shape[1] != 3 or rounds_meta.shape[0] < 1:
        raise ValueError(f"rounds_meta must be (n_rounds + 1, 3), got "
                         f"{tuple(rounds_meta.shape)}")
    n_rounds = rounds_meta.shape[0] - 1
    n_codes = 0
    if tier in ("int8", "int4"):
        _check("vscale", vscale, torch.float32, (n_tiles, n_blocks), dev)
        _check("qscale", qscale, torch.float32, (B, n_blocks), dev)
    elif tier == "pq":
        n_codes = codebook.shape[2]
        _check("codebook", codebook, torch.float32,
               (n_blocks, Cs, n_codes, C // Cs), dev)
        if not 1 <= n_codes <= 256:
            raise ValueError(f"pq codebook has {n_codes} codes, not in "
                             f"[1, 256]")
    if cert is not None:
        _check("cert", cert, torch.float32, (n_rounds + 1, 2), dev)
        if k_cert < 1:
            raise ValueError(f"k_cert must be >= 1, got {k_cert}")
    elif track_var:
        raise ValueError("track_var needs cert (adaptive mode)")
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
    aligned = V4.data_ptr() % 16 == 0 and Qb.data_ptr() % 16 == 0
    vec = int(aligned and {"fp32": R == 8 and C in (128, 256, 512),
                           "int8": C % 16 == 0, "int4": Cs % 16 == 0,
                           "pq": False}[tier])
    ids = torch.empty((B, k_out), dtype=torch.int32, device=dev)
    vals = torch.empty((B, k_out), dtype=torch.float32, device=dev)
    rused = torch.empty((B,), dtype=torch.int32, device=dev)
    acc = torch.empty((B, n_tiles, R), dtype=torch.float32, device=dev)
    acc2 = torch.empty_like(acc) if track_var else None
    surv = torch.empty((B, n_tiles), dtype=torch.int32, device=dev)
    tmp = torch.empty((B, n_tiles), dtype=torch.int32, device=dev)
    keys = torch.empty((B, P), dtype=torch.int64, device=dev)
    lut = (torch.empty((B, n_blocks * Cs * n_codes), dtype=torch.float32,
                       device=dev) if tier == "pq" else None)

    def ptr(t):
        return None if t is None else t.data_ptr()
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_cascade_batched(
            TIERS.index(tier), int(cert is not None), int(track_var),
            V4.data_ptr(), Qb.data_ptr(), ptr(vscale), ptr(qscale),
            ptr(codebook), ptr(cert), slotcode.data_ptr(),
            rounds_meta.data_ptr(), cols.data_ptr(), ids.data_ptr(),
            vals.data_ptr(), rused.data_ptr(), acc.data_ptr(), ptr(acc2),
            surv.data_ptr(), tmp.data_ptr(), keys.data_ptr(), ptr(lut),
            B, n_tiles, n_blocks, R, C, Cs, S, n_rounds, int(t_final),
            int(n_final), k_out, n_codes, int(k_cert), P, vec, n_valid,
            stream)
    if rc != 0:
        msg = lib.fused_cascade_error_string(rc).decode()
        raise RuntimeError(f"fused_cascade_batched launch failed: {msg} "
                           f"(cudaError {rc})")
    _launches["fused_cascade_batched"] += 1
    adaptive = "+adaptive" if cert is not None else ""
    _launches[f"fused_cascade_batched[{tier}{adaptive}]"] += 1
    return (ids, vals, rused) if cert is not None else (ids, vals)
