#!/usr/bin/env python3
"""Every 16-bit accumulation in the JAX package's bf16 train steps.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/torch_bf16_reductions.py
    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/torch_bf16_reductions.py \\
        qwen1.5-0.5b whisper-medium --json

For each arch (default: all of the JAX package's), its smoke config in
bf16: the jitted ``train_step`` (the gradient and the AdamW update) of a
batch of ``--batch`` rows of ``--seq`` tokens, vlm with
``patch_embeds`` and encdec with ``enc_frames``, is lowered, not
compiled, from abstract shapes (a few seconds an arch).  The HLO that
JAX hands XLA is then searched for every ``reduce`` and ``scatter``
whose result is bf16 or f16 and whose combiner adds: the sums the
program itself asks to accumulate in 16 bits, one rounding per add
(XLA's CPU build adds in f32 and converts back at each step).  A
combiner of max or min rounds nothing and is left out.

Each entry is printed with its site: the innermost frame of the
traceback that lies in the JAX package (file:line and function), and
the operand and result shapes.  A reduce over dimensions of size 1 only
(the transpose of a broadcast's added unit axes) adds one value to the
zero init and is exact; it is marked so.  ``--json`` prints one JSON
object per arch instead.  Like the port's tests, this script imports
the JAX package; the port itself imports no JAX.
"""

import argparse
import dataclasses
import json
import re
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY, get_config  # noqa: E402
from repro.models.model import init_params  # noqa: E402
from repro.models.steps import train_step  # noqa: E402
from repro.optim.adamw import AdamWConfig, init_opt  # noqa: E402

_16_BIT = ("bf16", "f16")
_INSTR = re.compile(r"^\s*(?:ROOT )?(\S+) = (\w+)\[([^\]]*)\]\S* "
                    r"(reduce|scatter)\((.*)$")


def _lower(arch: str, batch: int, seq: int) -> str:
    """The HLO text (with its stack-frame tables) of ``arch``'s bf16
    smoke train step."""
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="bfloat16")
    params = jax.eval_shape(lambda k: init_params(cfg, k),
                            jax.random.PRNGKey(0))
    opt = jax.eval_shape(init_opt, params)
    ints = jax.ShapeDtypeStruct((batch, seq), jnp.int32)
    b = {"tokens": ints, "labels": ints}
    if cfg.family == "vlm":
        b["patch_embeds"] = jax.ShapeDtypeStruct(
            (batch, cfg.n_patches, cfg.d_model), jnp.float32)
    if cfg.family == "encdec":
        b["enc_frames"] = jax.ShapeDtypeStruct(
            (batch, cfg.encoder_seq, cfg.d_model), jnp.float32)
    step = jax.jit(lambda p, o, bb: train_step(p, o, bb, cfg, AdamWConfig()))
    return step.lower(params, opt, b).as_text(dialect="hlo", debug_info=True)


def _tables(hlo: str):
    """The module's ``FileNames``, ``FunctionNames``, ``FileLocations``
    and ``StackFrames`` tables, each ``{id: fields}``."""
    out, name = {}, None
    for line in hlo.splitlines():
        if line in ("FileNames", "FunctionNames", "FileLocations",
                    "StackFrames"):
            name = line
            out[name] = {}
            continue
        m = re.match(r"^(\d+) (.*)$", line)
        if name and m:
            out[name][int(m.group(1))] = m.group(2)
        elif not line.strip():
            name = None
    return out


def _frames(tables, frame_id: int):
    """The traceback of ``frame_id``, innermost first: ``(file, line,
    function)``."""
    files = {k: v.strip('"') for k, v in tables["FileNames"].items()}
    funcs = {k: v.strip('"') for k, v in tables["FunctionNames"].items()}
    out, seen = [], set()
    while frame_id and frame_id not in seen:
        seen.add(frame_id)
        f = tables["StackFrames"][frame_id]
        loc = tables["FileLocations"][int(
            re.search(r"file_location_id=(\d+)", f).group(1))]
        fields = dict(re.findall(r"(\w+)=(\d+)", loc))
        out.append((files[int(fields["file_name_id"])],
                    int(fields["line"]),
                    funcs[int(fields["function_name_id"])]))
        parent = int(re.search(r"parent_frame_id=(\d+)", f).group(1))
        frame_id = parent if parent != frame_id else 0
    return out


def _combiners(hlo: str):
    """``{computation name: the opcode of its ROOT}``."""
    out, comp = {}, None
    for line in hlo.splitlines():
        m = re.match(r"^(?:ENTRY )?%?(\S+) [({]", line)
        if m and not line.startswith(" "):
            comp = m.group(1)
        m = re.match(r"^\s*ROOT \S+ = \S+ (\w[\w-]*)\(", line)
        if m and comp:
            out[comp] = m.group(1)
    return out


def _rel(path: str) -> str:
    try:
        return str(Path(path).resolve().relative_to(ROOT))
    except ValueError:
        return path


def audit(arch: str, batch: int = 2, seq: int = 16) -> dict:
    """The 16-bit accumulations of ``arch``'s bf16 smoke train step."""
    t0 = time.perf_counter()
    hlo = _lower(arch, batch, seq)
    tables, combiner = _tables(hlo), _combiners(hlo)
    shapes = {}
    entries = []
    for line in hlo.splitlines():
        m = re.match(r"^\s*(?:ROOT )?(\S+) = (\w+\[[^\]]*\])", line)
        if m:
            shapes[m.group(1)] = m.group(2)
        m = _INSTR.match(line)
        if not m or m.group(2) not in _16_BIT:
            continue
        name, dtype, dims, op, rest = m.groups()
        fn = re.search(r"to_apply=%?([\w.\-]+)", rest).group(1)
        if combiner.get(fn) != "add":
            continue
        operand = re.match(r"%?([\w.\-]+)", rest).group(1)
        sid = re.search(r"stack_frame_id=(\d+)", rest)
        stack = _frames(tables, int(sid.group(1))) if sid else []
        here = [f for f in stack if "/src/repro/" in f[0]]
        site = (f"{_rel(here[0][0])}:{here[0][1]} {here[0][2]}" if here
                else "?")
        rdims = re.search(r"dimensions=\{([\d,]*)\}", rest)
        op_shape = shapes.get(operand, "?")
        entry = {"op": op, "result": f"{dtype}[{dims}]",
                 "operand": op_shape, "site": site,
                 "callers": [f"{_rel(f)}:{ln} {fn_}"
                             for f, ln, fn_ in here[1:4]],
                 "op_name": (re.search(r'op_name="([^"]*)"', rest)
                             or [None, ""])[1]}
        if op == "reduce" and rdims and op_shape != "?":
            sizes = [int(s) for s in re.findall(r"\d+", op_shape.split(
                "[", 1)[1])]
            axes = [int(a) for a in rdims.group(1).split(",") if a]
            entry["dims"] = axes
            entry["exact"] = all(sizes[a] == 1 for a in axes)
        else:
            entry["exact"] = False
        entries.append(entry)
    return {"arch": arch, "dtype": "bfloat16", "batch": batch, "seq": seq,
            "entries": entries, "seconds": time.perf_counter() - t0}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("archs", nargs="*", help="default: every arch")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    results = []
    for arch in args.archs or sorted(REGISTRY):
        res = audit(arch, args.batch, args.seq)
        results.append(res)
        if args.json:
            print(json.dumps(res), flush=True)
            continue
        rounding = [e for e in res["entries"] if not e["exact"]]
        print(f"{arch}: {len(res['entries'])} 16-bit accumulations, "
              f"{len(rounding)} that round ({res['seconds']:.1f} s)")
        tally = Counter((e["op"], e["operand"], e["result"], e["site"],
                         e["exact"]) for e in res["entries"])
        for (op, operand, result, site, exact), n in sorted(tally.items()):
            note = "  exact (unit dims)" if exact else ""
            print(f"  {n:3d} x {op:7s} {operand} -> {result}  at {site}"
                  f"{note}")
    return results


if __name__ == "__main__":
    main()
