"""Collective traffic and local FLOPs of a traced step (the counterpart
of ``repro.launch.hlo_analysis``).

The JAX package reads the collectives out of the compiled, post-SPMD
HLO text.  The port runs its steps eagerly on DTensors, so it records
them as they are issued: `TraceCounter` is a dispatch mode that sees
every functional collective DTensor issues (``_c10d_functional``
all-gather, all-reduce, reduce-scatter, all-to-all), under real ranks,
under ``LocalTensorMode`` and under the dry run's ``fake`` group and
``FakeTensorMode`` alike, and counts each local op's FLOPs by the
formulas of ``torch.utils.flop_counter`` (FlopCounterMode's), at the
shapes of the shards one rank computes.  `collective_bytes` sums the
records into the JAX package's keys.
"""

from __future__ import annotations

import re
import sys
from typing import Dict, Iterable, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["collective_bytes", "DTYPE_BYTES", "shape_bytes", "shape_str",
           "TraceCounter"]

DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}

#: torch dtypes under the HLO names of `DTYPE_BYTES`
_HLO_NAMES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.bfloat16: "bf16", torch.float16: "f16",
    torch.int32: "s32", torch.float32: "f32", torch.int64: "s64",
    torch.float64: "f64", torch.complex64: "c64", torch.complex128: "c128",
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

#: functional collective op -> its kind (the JAX package's names)
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
#: bookkeeping ops of the functional collectives: no traffic of their own
_NO_TRAFFIC = {"wait_tensor", "_wrap_tensor_autograd"}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def shape_str(t: torch.Tensor) -> str:
    """``t``'s type and shape as HLO writes them, e.g. ``bf16[256,4096]``."""
    return f"{_HLO_NAMES[t.dtype]}[{','.join(str(d) for d in t.shape)}]"


def shape_bytes(shape_str: str) -> int:
    """Total bytes of e.g. 'bf16[256,4096]' or a tuple '(f32[8], f32[8])'."""
    total = 0
    for dt, dims in _SHAPE_RE.findall(shape_str):
        if dt not in DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                if d:
                    n *= int(d)
        total += n * DTYPE_BYTES[dt]
    return total


def collective_bytes(records: Iterable[Tuple[str, str]]) -> Dict[str, int]:
    """Bytes moved per collective kind (output-shape accounting, as the
    JAX package counts its HLO ops): ``{kind}_bytes``, ``{kind}_count``
    for all-gather, all-reduce, reduce-scatter, all-to-all and
    collective-permute, and ``total_bytes``.  ``records`` are ``(kind,
    output shape string)`` pairs (`TraceCounter.collectives`)."""
    out = {k: 0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}
    for kind, shape in records:
        if kind not in out:
            raise ValueError(f"unknown collective kind {kind!r}")
        out[kind] += shape_bytes(shape)
        counts[kind] += 1
    res = {f"{k}_bytes": v for k, v in out.items()}
    res.update({f"{k}_count": c for k, c in counts.items()})
    res["total_bytes"] = sum(out.values())
    return res


def _in_sharding_propagation() -> bool:
    """Whether the current op runs inside DTensor's sharding propagation,
    which runs each op once more at the global shapes (under the dry
    run's fake mode) only to read the output's metadata."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name == "_propagate_tensor_meta_non_cached":
            return True
        f = f.f_back
    return False


class TraceCounter(TorchDispatchMode):
    """Records the collectives a step issues and the FLOPs of the ops one
    rank runs.

    ``collectives`` is a list of ``(kind, output shape string)``;
    ``flops`` the sum of ``torch.utils.flop_counter``'s formulas over the
    local ops (a DTensor op defers to DTensor, whose local ops then come
    back here at their shard shapes; the metadata runs of DTensor's
    sharding propagation are not counted).  Under ``LocalTensorMode``
    the shapes are one rank's; the counts are of one rank's program."""

    def __init__(self):
        super().__init__()
        self.collectives: List[Tuple[str, str]] = []
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name.split("::")[-1]
        if func.namespace == "_c10d_functional" and name not in _NO_TRAFFIC:
            if name not in _KINDS:
                raise ValueError(f"uncounted collective {func}")
            outs = out if isinstance(out, (list, tuple)) else [out]
            for o in outs:
                self.collectives.append((_KINDS[name], shape_str(o)))
        packet = func._overloadpacket
        if packet in flop_registry and not _in_sharding_propagation():
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        return out
