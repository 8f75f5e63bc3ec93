"""Multi-pod dry run: trace every (arch x shape) cell on the production
meshes without a card, and record each device's FLOPs, bytes and
collectives (the counterpart of ``repro.launch.dryrun``).

The JAX package lowers and compiles each cell for 512 forced host
devices and reads XLA's cost and memory analyses.  The port runs the
cell's step itself, once, as rank 0 of a ``fake`` process group of 256
(single pod, (16, 16)) or 512 (multi pod, (2, 16, 16)) ranks, on
DTensors whose local shards are ``FakeTensorMode`` tensors: shapes,
types and placements propagate, collectives are issued to the fake
group, and nothing is allocated.  The parameters are placed by
`param_pspecs` from ``build_model(device="meta")`` shapes, the batch by
`batch_pspecs`, the caches by `cache_pspecs`, with the cell's logical
rules (`rules_for`), FSDP above `_FSDP_ABOVE` bytes of bf16 weights on
train cells and bf16 moments above `_BF16_MOMENTS_ABOVE` parameters, as
in the JAX package.  A failure is a bug in the system, recorded with
its traceback; records are cached as JSON under
``results/dryrun_torch/``, failures never.

Each record keeps the JAX record's keys: ``flops`` are the FLOPs of the
ops rank 0 runs (`TraceCounter`, ``torch.utils.flop_counter``'s
formulas), ``argument_size_in_bytes`` / ``output_size_in_bytes`` the
bytes of its shards of the step's inputs and outputs, ``collectives``
`collective_bytes` of what it issued; ``lower_s`` is the trace's time and
``compile_s`` 0.0 (nothing is compiled), and what only XLA reports
(``hlo_bytes_accessed``, ``temp_size_in_bytes``,
``generated_code_size_in_bytes``) is -1, not measured.  It adds each
device's ``param_bytes``, ``moment_bytes``, ``batch_bytes`` and
``cache_bytes``, and ``reductions_16_bit``, the count of all-reduces and
reduce-scatters of a bf16 or f16 shape (0: the port reduces every 16-bit
partial sum in f32, `sharding.redistribute`).  The port's layers are a Python loop, not a scan, so
``--unroll`` changes nothing (every layer is traced and counted either
way); the flag and the record's ``unrolled`` are kept for the JAX CLI's
sake.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import cells
from repro_torch.configs.base import ArchConfig, RunShape
from repro_torch.distributed.sharding import axis_sizes, logical_mesh
from repro_torch.distributed.specs import (batch_axes, batch_pspecs,
                                           cache_pspecs, local_bytes,
                                           param_pspecs, place_params,
                                           place_tree)
from repro_torch.launch.comm_analysis import TraceCounter, collective_bytes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import build_model
from repro_torch.models.steps import decode_step, prefill_step, train_step
from repro_torch.optim.adamw import AdamWConfig, init_opt

__all__ = ["batch_sds", "rules_for", "trace_cell", "run_cell", "main",
           "RESULTS_DIR"]

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

# models whose f32 optimizer moments would blow past a device's memory
_BF16_MOMENTS_ABOVE = 50e9
_FSDP_ABOVE = 8e9

#: keys of the JAX record that only XLA's analyses give
_NOT_MEASURED = ("hlo_bytes_accessed", "temp_size_in_bytes",
                 "generated_code_size_in_bytes")


def batch_sds(cfg: ArchConfig, shape: RunShape) -> Dict[str, torch.Tensor]:
    """The cell's batch as shapes and types only (``meta`` tensors, the
    JAX package's ``ShapeDtypeStruct``s)."""
    B, S = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)

    def sds(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")
    b = {"tokens": sds((B, S), torch.int32),
         "labels": sds((B, S), torch.int32)}
    if cfg.family == "vlm":
        b["patch_embeds"] = sds((B, cfg.n_patches, cfg.d_model), dt)
    if cfg.family == "encdec":
        b["enc_frames"] = sds((B, cfg.encoder_seq, cfg.d_model), dt)
    return b


def rules_for(cfg: ArchConfig, shape: RunShape, mesh) -> Dict[str, Any]:
    """Per-cell logical-axis overrides (DESIGN.md §6)."""
    sizes = axis_sizes(mesh)
    rules: Dict[str, Any] = {"batch": batch_axes(mesh, shape.global_batch)}
    if shape.name == "long_500k":
        # batch=1: parallelize over the sequence instead
        rules["kvseq"] = tuple(a for a in ("data", "model") if a in sizes)
        rules["seq"] = "data" if "data" in sizes else None
    if cfg.ssm_heads and (cfg.ssm_heads % sizes["model"]
                          or cfg.d_inner % sizes["model"]):
        rules["dinner"] = None
    if cfg.n_experts and cfg.n_experts % sizes["model"]:
        rules["experts"] = None  # TP-inside-experts instead (param specs)
    return rules


#: the kind of device the fake tensors and the mesh claim: the CPU's (an
#: autograd step on fake CUDA tensors needs a card), so where DTensor
#: would issue an all-to-all on the card it issues an all-gather
_DEVICE = "cpu"


def _device_mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_DEVICE, tuple(shape), mesh_dim_names=names)


def _fake(t: torch.Tensor) -> torch.Tensor:
    """A tensor of ``t``'s shape and type under the active fake mode."""
    return torch.empty(t.shape, dtype=t.dtype, device=_DEVICE)


def _meta_caches(model, cfg: ArchConfig, shape: RunShape):
    """The structure of the caches of a ``shape.seq_len`` context, from a
    one-token prefill of the meta model (the caches' shapes do not
    depend on the prompt's length)."""
    B, S = shape.global_batch, shape.seq_len
    kw = {}
    if cfg.family == "encdec":
        kw["enc_frames"] = torch.empty((B, cfg.encoder_seq, cfg.d_model),
                                       dtype=getattr(torch, cfg.dtype),
                                       device="meta")
    _, caches = model(torch.zeros((B, 1), dtype=torch.int32,
                                  device="meta"), cache_len=S, **kw)
    return caches


def trace_cell(cfg: ArchConfig, shape: RunShape, mesh,
               mips_mode: Optional[str] = None, unroll: bool = False
               ) -> Dict[str, Any]:
    """Run one (arch x shape x mesh) cell's step once as rank 0 of the
    mesh's fake group under ``FakeTensorMode``; returns its measurements
    and meta (``fsdp``, ``rules``).  ``unroll`` changes nothing (the
    layers are not scanned)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    if mips_mode is not None:
        cfg = dataclasses.replace(cfg, mips_mode=mips_mode)
    model = build_model(cfg, device="meta")
    named = dict(model.named_parameters())
    fsdp = cfg.n_params() * 2 > _FSDP_ABOVE and shape.kind == "train"
    pspecs = param_pspecs(cfg, named, mesh, fsdp=fsdp)
    rules = rules_for(cfg, shape, mesh)
    B, S = shape.global_batch, shape.seq_len
    caches = _meta_caches(model, cfg, shape) if shape.kind == "decode" \
        else None
    out: Dict[str, Any] = {"fsdp": fsdp,
                           "rules": {k: str(v) for k, v in rules.items()}}
    t0 = time.time()
    with FakeTensorMode(), logical_mesh(mesh, rules):
        for mod_name, mod in model.named_modules():
            for n, p in list(mod.named_parameters(recurse=False)):
                setattr(mod, n, torch.nn.Parameter(_fake(p),
                                                   requires_grad=False))
        place_params(model, pspecs, mesh)
        params = dict(model.named_parameters())
        b = {k: _fake(v) for k, v in batch_sds(cfg, shape).items()}
        b = place_tree(b, batch_pspecs(mesh, B, b), mesh)
        out["param_bytes"] = local_bytes(params.values())
        out["moment_bytes"] = out["cache_bytes"] = 0
        if shape.kind == "train":
            moments = (torch.bfloat16 if cfg.n_params() > _BF16_MOMENTS_ABOVE
                       else torch.float32)
            opt = init_opt(params, moments_dtype=moments, with_err=False)
            out["moment_bytes"] = local_bytes([*opt.mu.values(),
                                               *opt.nu.values()])
            out["batch_bytes"] = local_bytes(b.values())
            args = out["param_bytes"] + out["moment_bytes"] \
                + out["batch_bytes"]
            with TraceCounter() as tc:
                _, opt, m = train_step(model, opt, b, cfg, AdamWConfig())
            outs = out["param_bytes"] + out["moment_bytes"] \
                + local_bytes(m.values())
            alias = out["param_bytes"] + out["moment_bytes"]
        elif shape.kind == "prefill":
            extra = {k: v for k, v in b.items()
                     if k not in ("tokens", "labels")}
            out["batch_bytes"] = local_bytes([b["tokens"],
                                              *extra.values()])
            args = out["param_bytes"] + out["batch_bytes"]
            with TraceCounter() as tc:
                last, new = prefill_step(model, b["tokens"], S, **extra)
            out["cache_bytes"] = local_bytes(
                t for c in new for t in c.values())
            outs = out["cache_bytes"] + local_bytes([last])
            alias = 0
        else:  # decode
            seq_axes = rules.get("kvseq", "model")
            cspecs = cache_pspecs(mesh, B, caches, seq_axes=seq_axes)
            caches = [place_tree({k: _fake(v) for k, v in c.items()}, s,
                                 mesh) for c, s in zip(caches, cspecs)]
            tok = place_tree({"tok": _fake(torch.empty(
                (B, 1), dtype=torch.int32, device="meta"))},
                {"tok": batch_pspecs(mesh, B, {"tokens": b["tokens"]})[
                    "tokens"]}, mesh)["tok"]
            out["batch_bytes"] = local_bytes([tok])
            out["cache_bytes"] = local_bytes(
                t for c in caches for t in c.values())
            args = out["param_bytes"] + out["cache_bytes"] \
                + out["batch_bytes"]
            with TraceCounter() as tc:
                nxt, new = decode_step(model, cfg, caches, tok, S - 1)
            outs = local_bytes(t for c in new for t in c.values()) \
                + local_bytes([nxt])
            alias = 0
    out["lower_s"] = round(time.time() - t0, 1)
    out["compile_s"] = 0.0
    out["flops"] = float(tc.flops)
    out["argument_size_in_bytes"] = int(args)
    out["output_size_in_bytes"] = int(outs)
    out["alias_size_in_bytes"] = int(alias)
    for k in _NOT_MEASURED:
        out[k] = -1
    out["collectives"] = collective_bytes(tc.collectives)
    out["reductions_16_bit"] = sum(
        1 for kind, sh in tc.collectives
        if kind in ("all-reduce", "reduce-scatter")
        and sh.startswith(("bf16[", "f16[")))
    return out


@contextlib.contextmanager
def _fake_group(n: int):
    """A ``fake`` default process group of ``n`` ranks, this process rank
    0, for the duration."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run needs its own process group; one "
                           "is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_cell(cfg: ArchConfig, shape: RunShape, mesh_name: str,
             mips_mode: Optional[str] = None, unroll: bool = False,
             save: bool = True, mesh_shape=None) -> Dict[str, Any]:
    """Trace one cell on the production mesh (``mesh_shape`` ``(shape,
    axis names)`` replaces it, as the tests' small meshes do) and return
    its record, cached under `RESULTS_DIR` when it succeeded."""
    tag = f"{cfg.name}_{shape.name}_{mesh_name}" + (
        f"_{mips_mode}" if mips_mode else "") + ("_unrolled" if unroll
                                                 else "")
    out_path = os.path.join(RESULTS_DIR, tag + ".json")
    if save and os.path.exists(out_path):
        with open(out_path) as f:
            prev = json.load(f)
        if prev.get("ok"):          # never cache failures
            return prev
    if mesh_shape is None:
        dims = (2, 16, 16) if mesh_name == "multi" else (16, 16)
    else:
        dims = mesh_shape[0]
    n = 1
    for d in dims:
        n *= d
    rec: Dict[str, Any] = {
        "arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
        "kind": shape.kind, "mips_mode": mips_mode or cfg.mips_mode,
        "n_devices": n, "unrolled": unroll}
    t0 = time.time()
    with _fake_group(n):
        try:
            if mesh_shape is None:
                mesh = make_production_mesh(multi_pod=mesh_name == "multi",
                                            device=_DEVICE)
            else:
                mesh = _device_mesh(tuple(mesh_shape[0]),
                                    tuple(mesh_shape[1]))
            rec.update(trace_cell(cfg, shape, mesh, mips_mode=mips_mode,
                                  unroll=unroll))
            rec["ok"] = True
        except Exception as e:  # a failure here is a bug in the system
            rec["ok"] = False
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.time() - t0, 1)
    if save and rec["ok"]:
        os.makedirs(RESULTS_DIR, exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mips-mode", default=None,
                    choices=[None, "exact", "boundedme"])
    ap.add_argument("--unroll", action="store_true",
                    help="kept for the JAX CLI: the port's layers are not "
                         "scanned, so every layer is counted anyway")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    todo = []
    for cfg, shp, skip in cells():
        if args.arch and cfg.name != args.arch:
            continue
        if args.shape and shp.name != args.shape:
            continue
        if not args.all and not (args.arch or args.shape):
            continue
        todo.append((cfg, shp, skip))
    if not todo:
        ap.error("nothing selected: pass --all or --arch/--shape")

    n_ok = n_fail = n_skip = 0
    for cfg, shp, skip in todo:
        for mesh_name in meshes:
            tag = f"{cfg.name} x {shp.name} x {mesh_name}"
            if skip:
                print(f"[skip] {tag}: {skip}", flush=True)
                n_skip += 1
                continue
            rec = run_cell(cfg, shp, mesh_name, mips_mode=args.mips_mode,
                           unroll=args.unroll)
            if rec["ok"]:
                n_ok += 1
                print(f"[ok]   {tag}: flops={rec['flops']:.3e} "
                      f"coll={rec['collectives']['total_bytes']:.3e}B "
                      f"params={rec['param_bytes'] / 1e9:.3f}GB "
                      f"red16={rec.get('reductions_16_bit')} "
                      f"trace={rec.get('lower_s')}s", flush=True)
            else:
                n_fail += 1
                print(f"[FAIL] {tag}: {rec['error']}", flush=True)
    print(f"done: ok={n_ok} fail={n_fail} skip={n_skip}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
