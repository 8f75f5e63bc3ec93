"""The fused BoundedME cascade kernel: binding and wrappers.

The kernel is hand-written CUDA C++ in ``csrc/fused_cascade.cu``; its
source note says what it replaces (``fused_cascade_batched_pallas`` and
``fused_cascade_pallas`` of the JAX package), what bounds it and what its
design does.  `repro_torch.kernels.library` builds it for ``sm_90a`` at
first use and binds it with ``ctypes``; nothing here imports or builds
anything when the module is imported.

Two entries share one templated body, as the two TPU kernels share
``_make_kernel``: `fused_cascade_batched_cuda` (a (B, N) batch) and
`fused_cascade_cuda` (one query).  Each is one cooperative launch of one
CTA per SM (`launch_grid`; `launched_grid` reads back the grid a launch
ran with); each launches on CUDA tensors, on their card, and raises on
anything else, and on a schedule not laid out as ``flatten_schedule``
lays it out (`check_layout`).  `repro_torch.kernels.ops` chooses
between them and the plain PyTorch versions by the tensors' device.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.schedule import END_BIT, PULL_BIT, SLOT_MASK
from repro_torch.kernels import library
from repro_torch.kernels.library import launch_counts, reset_launch_counts

__all__ = ["build", "fused_cascade_batched_cuda", "fused_cascade_cuda",
           "launch_grid", "launched_grid", "check_layout", "resolve_tier",
           "TIERS", "launch_counts", "reset_launch_counts", "SOURCE"]

SOURCE = library.CSRC / "fused_cascade.cu"

#: pull tiers, in the CUDA entry points' tier-code order; "bf16" is the
#: fp32 tier on a bfloat16 table (f32 queries and accumulators)
TIERS = ("fp32", "int8", "int4", "pq", "bf16")

# launches of each entry in all and per tier (``"fused_cascade[int8]"``,
# or ``"fused_cascade_batched[int8+adaptive]"`` with early exit)
library.register(f"{entry}{tag}" for entry in ("fused_cascade_batched",
                                               "fused_cascade")
                 for tag in [""] + [f"[{t}{a}]" for t in TIERS
                                    for a in ("", "+adaptive")])


def build():
    """Compile the kernel unless this source is built: ``(library path,
    ptxas report)`` (`repro_torch.kernels.library.build`)."""
    return library.build(SOURCE)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = library.load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    tail = [i] * 14 + [ctypes.c_longlong, p]
    lib.fused_cascade_batched.argtypes = [i] * 4 + [p] * 20 + [i] + tail
    lib.fused_cascade.argtypes = [i] * 3 + [p] * 20 + tail
    lib.fused_cascade_config.argtypes = [ctypes.POINTER(i)] * 2
    lib.fused_cascade_batched.restype = lib.fused_cascade.restype = i
    lib.fused_cascade_config.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def launch_grid(device: torch.device) -> Tuple[int, int]:
    """``(CTAs, key capacity)`` of a launch on ``device``: one CTA per SM,
    and how many 64-bit round-end keys fit in a CTA's shared memory."""
    lib = _lib()
    sms, cap = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = lib.fused_cascade_config(ctypes.byref(sms), ctypes.byref(cap))
    library.check_launch(lib, rc, "fused_cascade_config")
    return sms.value, cap.value


_GRID = library.GridWord()


def launched_grid(device) -> int:
    """The CTA count the last launch of either entry on ``device`` ran
    with, as the kernel read it from its own ``gridDim.x``; 0 when none
    launched since the last call.  Waits for the card, and clears it."""
    return _GRID.read(device)


# id(slotcode) -> (its weakref, rounds_meta's weakref, versions, n_final)
# of every schedule `check_layout` has passed
_LAYOUTS: dict = {}


def _layout(meta: np.ndarray, S: int, n_final: int):
    """``(slot | END_BIT per step, whether the step may pull)`` of an
    ``S``-step schedule with rounds ``meta`` laid out as
    ``flatten_schedule`` lays it out, or None when the rounds do not fit:
    round r pulls ``P = t_cum - t_prev`` columns of its ``T = n_surv``
    slots (step ``p * T + s`` is slot s of column p) and ends on its last
    step, or is one step that pulls nothing when ``P = 0``; the steps
    after the rounds walk ``n_final`` slots column by column."""
    codes = np.zeros(S, np.int64)
    may_pull = np.ones(S, bool)
    pos = t_prev = 0
    for t_cum, T, _ in meta[:-1].tolist():
        P = t_cum - t_prev
        n = P * T if P > 0 else 1
        if P < 0 or T < 1 or pos + n > S:
            return None
        if P > 0:
            codes[pos:pos + n] = np.arange(n) % T
        else:
            may_pull[pos] = False
        codes[pos + n - 1] |= END_BIT
        pos, t_prev = pos + n, t_cum
    codes[pos:] = np.arange(S - pos) % max(n_final, 1)
    return codes, may_pull


def check_layout(slotcode: torch.Tensor, rounds_meta: torch.Tensor,
                 n_final: int) -> None:
    """Raise ValueError unless ``slotcode`` is laid out as
    ``flatten_schedule`` (`FlatSchedule.packed`) lays out the rounds of
    ``rounds_meta``: the kernel walks that layout without reading the
    steps' slots and round ends.  A schedule that passed (the same
    tensors, unmodified) is not read again; the first check of one
    copies it to the host."""
    key = (slotcode._version, rounds_meta._version, int(n_final))
    seen = _LAYOUTS.get(id(slotcode))
    if (seen is not None and seen[0]() is slotcode
            and seen[1]() is rounds_meta and seen[2:] == key):
        return
    code = slotcode.cpu().numpy().astype(np.int64)
    want = _layout(rounds_meta.cpu().numpy(), code.size, int(n_final))
    if want is None or not (
            np.array_equal(code & (SLOT_MASK | END_BIT), want[0])
            and (want[1] | (code & PULL_BIT == 0)).all()):
        raise ValueError("slotcode is not laid out as flatten_schedule "
                         "lays out the rounds of rounds_meta; the kernel "
                         "walks that layout only")
    for k in [k for k, v in _LAYOUTS.items() if v[0]() is None]:
        del _LAYOUTS[k]
    _LAYOUTS[id(slotcode)] = (weakref.ref(slotcode),
                              weakref.ref(rounds_meta), *key)


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


def _launch(single: bool, V4: torch.Tensor, Qb: torch.Tensor,
            slotcode: torch.Tensor, rounds_meta: torch.Tensor,
            cols: torch.Tensor, *, n_arms: int, K: int, t_final: int,
            n_final: int, k_out: Optional[int], n_valid: Optional[int],
            vscale: Optional[torch.Tensor], qscale: Optional[torch.Tensor],
            codebook: Optional[torch.Tensor], packed_int4: bool,
            cert: Optional[torch.Tensor], k_cert: int, track_var: bool):
    """Check the batched operand layout and launch one of the two entries
    (``single``: a B = 1 batch through the single-query entry)."""
    if not V4.is_cuda:
        raise ValueError(f"the CUDA kernel needs CUDA tensors, V4 is on "
                         f"{V4.device}")
    dev = V4.device
    tier, C = resolve_tier(V4.shape[-1], vscale, qscale, codebook,
                           packed_int4)
    if tier == "fp32" and V4.dtype == torch.bfloat16:
        tier = "bf16"
    _check("V4", V4, {"fp32": torch.float32, "bf16": torch.bfloat16,
                      "pq": torch.uint8}.get(tier, torch.int8), 4, dev)
    n_tiles, n_blocks, R, Cs = V4.shape
    # one cols row expanded over the batch (stride 0): every query pulls
    # the same columns, and round 1 is read once for the batch
    shared = cols.dim() == 2 and (cols.shape[0] == 1 or cols.stride(0) == 0)
    _check("cols", cols[:1] if shared else cols, torch.int32, 2, dev)
    B, S = cols.shape
    _check("Qb", Qb, torch.int8 if tier in ("int8", "int4")
           else torch.float32, (B, n_blocks, C), dev)
    _check("slotcode", slotcode, torch.int32, (S,), dev)
    _check("rounds_meta", rounds_meta, torch.int32, 2, dev)
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
    check_layout(slotcode, rounds_meta, n_final)
    P = max(n_tiles, n_final * R)
    grid, capacity = launch_grid(dev)
    aligned = V4.data_ptr() % 16 == 0 and Qb.data_ptr() % 16 == 0
    f32_vec = R == 8 and C in (128, 256, 512)
    vec = int(aligned and {"fp32": f32_vec, "bf16": f32_vec,
                           "int8": C % 16 == 0, "int4": Cs % 16 == 0,
                           "pq": False}[tier])
    ids = torch.empty((B, k_out), dtype=torch.int32, device=dev)
    vals = torch.empty((B, k_out), dtype=torch.float32, device=dev)
    rused = torch.empty((B,), dtype=torch.int32, device=dev)
    # the kernel's workspace, one allocation: accumulators, M2 (bernstein),
    # survivors and their copy, per query active / t_stop, the pq tables,
    # and the round-end keys when a CTA's shared memory cannot hold them;
    # 4-byte words, each part 256-byte aligned
    rows = B * n_tiles * R
    parts = {"acc": rows, "acc2": rows if track_var else 0,
             "surv": B * n_tiles, "tmp": B * n_tiles,
             "state": 2 * B,
             "lut": B * n_blocks * Cs * n_codes if tier == "pq" else 0,
             "keys": 2 * grid * P if P > capacity else 0}
    offsets, words = {}, 0
    for name, n in parts.items():
        offsets[name] = words if n else None
        words += -(-n // 64) * 64
    work = torch.empty((words,), dtype=torch.int32, device=dev)

    def ptr(name):
        off = offsets[name]
        return None if off is None else work.data_ptr() + 4 * off
    lib = _lib()
    entry = "fused_cascade" if single else "fused_cascade_batched"
    with library.on_device(dev):
        # the entry reads the current card's SM count and shared memory
        # and launches on its stream
        library.require_current(dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, entry)(
            TIERS.index(tier), int(cert is not None), int(track_var),
            *(() if single else (int(shared),)), V4.data_ptr(),
            Qb.data_ptr(), *(None if t is None else t.data_ptr()
                             for t in (vscale, qscale, codebook, cert)),
            slotcode.data_ptr(),
            rounds_meta.data_ptr(), cols.data_ptr(), ids.data_ptr(),
            vals.data_ptr(), rused.data_ptr(), ptr("acc"), ptr("acc2"),
            ptr("surv"), ptr("tmp"), ptr("state"), _GRID.on(dev).data_ptr(),
            ptr("keys"), ptr("lut"),
            *(() if single else (B,)), n_tiles, n_blocks, R, C, Cs, S,
            n_rounds, int(t_final), int(n_final), k_out, n_codes,
            int(k_cert), P, vec, n_valid, stream)
    library.check_launch(lib, rc, entry)
    adaptive = "+adaptive" if cert is not None else ""
    library.count(entry, f"{entry}[{tier}{adaptive}]")
    return (ids, vals, rused) if cert is not None else (ids, vals)


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

    Operands as in `repro_torch.kernels.ops.fused_cascade_batched` (a
    bfloat16 ``V4`` with float32 ``Qb`` runs the fp32 tier on the table's
    2-byte cells, counted as ``[bf16]``), all contiguous on one CUDA
    device except ``cols``, which may also be one
    ``(S,)`` row expanded over the batch (stride 0): round 1 then reads
    each pulled cell once for the whole batch, with results bitwise those
    of a contiguous copy.  The tier follows from the operands
    (`resolve_tier`).  Returns ``(ids (B, k_out) int32, vals (B, k_out)
    float32)``, vals being unscaled block means, and with ``cert`` also
    ``rounds_used (B,) int32``.
    """
    return _launch(False, V4, Qb, slotcode, rounds_meta, cols,
                   n_arms=n_arms, K=K, t_final=t_final, n_final=n_final,
                   k_out=k_out, n_valid=n_valid, vscale=vscale,
                   qscale=qscale, codebook=codebook,
                   packed_int4=packed_int4, cert=cert, k_cert=k_cert,
                   track_var=track_var)


def fused_cascade_cuda(V4: torch.Tensor, qb: torch.Tensor,
                       slotcode: torch.Tensor, rounds_meta: torch.Tensor,
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
    """Launch the single-query fused cascade on CUDA tensors.

    Operands as in `repro_torch.kernels.ops.fused_cascade`: ``qb
    (n_blocks, C)``, ``cols (S,)`` and ``qscale (n_blocks,)``.  Returns
    ``(ids (k_out,) int32, vals (k_out,) float32)`` and with ``cert``
    also a scalar ``rounds_used`` int32 tensor.
    """
    if qb.dim() != 2:
        raise ValueError(f"qb must be (n_blocks, C), got {tuple(qb.shape)}")
    if cols.dim() != 1:
        raise ValueError(f"cols must be (S,), got {tuple(cols.shape)}")
    if qscale is not None and qscale.dim() != 1:
        raise ValueError(f"qscale must be (n_blocks,), got "
                         f"{tuple(qscale.shape)}")
    out = _launch(True, V4, qb[None], slotcode, rounds_meta, cols[None],
                  n_arms=n_arms, K=K, t_final=t_final, n_final=n_final,
                  k_out=k_out, n_valid=n_valid, vscale=vscale,
                  qscale=None if qscale is None else qscale[None],
                  codebook=codebook, packed_int4=packed_int4, cert=cert,
                  k_cert=k_cert, track_var=track_var)
    return tuple(t[0] for t in out)
