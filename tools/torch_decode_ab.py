#!/usr/bin/env python3
"""Decode ms per token of another checkout's port against this one's, in
one process on the card.

    python3 tools/torch_decode_ab.py OTHER_SRC [--arch A] [--pairs N]
        [--mips exact|boundedme]

``OTHER_SRC`` is the ``src/`` directory of another checkout (unpack the
parent with ``git archive`` into ``build/``).  Its ``repro_torch`` is
copied into a temporary directory as ``repro_torch_other`` (every
``repro_torch`` name in it renamed), so both packages load side by side.
Both run the decode demo (`run_decode_demo`, 4 prompts of 16 tokens, 32
greedy tokens) at full width and depth in bf16 on the same weights (this
checkout's seeded model, its state copied into the other's), after a
2-token warm-up each; then ``--pairs`` pairs of runs, the order swapped
each pair.  One process removes the host's variation between processes;
the host clock still varies between runs.  Prints one JSON line: each
side's ms per token per run, the medians, the pairs this checkout won,
whether the two sides' tokens are equal, and the peak card memory each
side's run added.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import statistics
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def renamed_copy(src: Path, dest: Path) -> None:
    """``src/repro_torch`` as ``dest/repro_torch_other``, renamed inside."""
    pkg = dest / "repro_torch_other"
    shutil.copytree(src / "repro_torch", pkg,
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    for f in pkg.rglob("*.py"):
        f.write_text(re.sub(r"\brepro_torch\b", "repro_torch_other",
                            f.read_text()))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other_src", type=Path)
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--mips", default="exact")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        renamed_copy(a.other_src, Path(tmp))
        sys.path.insert(0, tmp)
        from repro_torch.launch import serve as ours
        from repro_torch_other.launch import serve as theirs
        from repro_torch_other.models.model import build_model

        def args(mod, tokens):
            return mod.parse_args(["--arch", a.arch, "--mips", a.mips,
                                   "--batch", "4", "--prompt-len", "16",
                                   "--tokens", str(tokens)])

        mine = ours.run_decode_demo(args(ours, 2))["model"]
        other = build_model(theirs.decode_config(args(theirs, 2)),
                            device="meta")
        other.load_state_dict(dict(mine.state_dict()), assign=True)
        theirs.run_decode_demo(args(theirs, 2), model=other)
        sides = {"other": (theirs, other), "this": (ours, mine)}
        ms = {k: [] for k in sides}
        peak = {k: 0.0 for k in sides}
        tokens = {}
        for i in range(a.pairs):
            for name in ("other", "this")[:: 1 - 2 * (i % 2)]:
                mod, model = sides[name]
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                r = mod.run_decode_demo(args(mod, 32), model=model)
                peak[name] = max(peak[name], (torch.cuda.max_memory_allocated()
                                              - base) / 1e9)
                ms[name].append(r["ms_per_token"])
                tokens[name] = r["tokens"]
    print(json.dumps({
        "arch": a.arch, "mips": a.mips, "other_src": str(a.other_src),
        "device": torch.cuda.get_device_name(0),
        "ms_per_token": ms,
        "median": {k: statistics.median(v) for k, v in ms.items()},
        "pairs_this_faster": sum(t < o for o, t in zip(ms["other"],
                                                       ms["this"])),
        "tokens_equal": bool((tokens["other"] == tokens["this"]).all()),
        "peak_added_gb": peak}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
