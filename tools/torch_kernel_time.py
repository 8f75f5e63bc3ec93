#!/usr/bin/env python3
"""Time kernels 3 and 4 and the chain sum of a checkout of the port, back
to back.

    python3 tools/torch_kernel_time.py [SRC]     # SRC: a tree's src/ dir

Imports ``repro_torch`` from ``SRC`` (default: this checkout's ``src``),
so two commits can be compared in one call on one card (parent, change,
change, parent).  At the qwen1.5-0.5b table's geometry (N(0, 0.02),
torch seed 0) it times ``gather_block_dot`` (row (19200, 2, 8, 512) and
coord (19200, 8, 8, 128)) and ``blocked_matvec`` ((153600, 1024)) in f32
and bf16, and ``torch.matmul`` on the matvec's operands; where the
checkout has it, the chain sum (``ops.chain_sum``, bf16 N(0, 1)) at the
bias step's cotangent (8, 128, 1024) and at mamba2-130m's ``D``
cotangent (8, 128, 64, 24), and ``torch.sum`` over the same rows; all
with ``chip_smoke.py``'s timer: 20 calls back to back between two CUDA
events, median of 5.  Prints one JSON line.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import time_back_to_back as back_to_back  # noqa: E402


def main() -> int:
    src = Path(sys.argv[1] if len(sys.argv) > 1 else ROOT / "src").resolve()
    sys.path.insert(0, str(src))
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import ops
    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev).manual_seed(0)
    table = 0.02 * torch.randn(153600, 1024, generator=g, device=dev)
    q = torch.randn(1024, generator=g, device=dev)
    out = {"src": str(src), "card": torch.cuda.get_device_name(0)}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype)[6:]
        W, qd = table.to(dtype), q.to(dtype)
        out[f"blocked_matvec {tag}"] = back_to_back(
            lambda: ops.blocked_matvec(W, qd))
        out[f"torch.matmul {tag}"] = back_to_back(lambda: torch.matmul(W, qd))
        for mode, C in (("row", 512), ("coord", 128)):
            V4 = W.view(19200, 8, 1024 // C, C).transpose(1, 2).contiguous()
            idx = torch.arange(19200, dtype=torch.int32, device=dev)
            cols = torch.arange(1024 // C, dtype=torch.int32, device=dev)
            qsel = qd.view(-1, C).contiguous()
            out[f"gather_block_dot {mode} {tag}"] = back_to_back(
                lambda: ops.gather_block_dot(V4, idx, cols, qsel))
            del V4
    if hasattr(ops, "chain_sum"):
        for lead, W in (((8, 128), 1024), ((8, 128, 64), 24)):
            x = torch.randn(*lead, W, generator=g, device=dev).to(
                torch.bfloat16)
            dims = tuple(range(len(lead)))
            name = "x".join(map(str, (*lead, W)))
            out[f"chain_sum {name}"] = back_to_back(lambda: ops.chain_sum(x))
            out[f"torch.sum {name}"] = back_to_back(
                lambda: torch.sum(x, dims))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
