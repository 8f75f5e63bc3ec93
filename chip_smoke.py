#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py            # from the repository root, one card

Phases, one line each (any failure exits non-zero before the result):

1. device — the card's name and power limit (nvidia-smi); TF32 is turned
   off for matmuls and cuDNN so every fp32 product here is full fp32;
2. build — compiles every CUDA kernel of the port from ``src/`` (nvcc,
   ``sm_90a``), one nvcc per source, all started together;
3. kernel — at the full qwen1.5-0.5b vocab table ((153600, 1024) fp32,
   n_valid 151936, B = 4, K = 4, eps = delta = 0.1) the fused-cascade
   kernel is held against its plain PyTorch version on the same operands,
   in 'row' and 'coord' pull mode, for every tier the serve path runs:
   fp32 (at k_out = K and 2K, with final coverage), int8, int4, pq (a
   quant_err measured on the table) and int8 with adaptive early exit
   under the 'bernstein' radii; plus a small case with fewer live rows
   than k_out.  Each is timed: the kernel (median of 10 launches after 2
   warm-ups, CUDA events), the plain version, exact ``torch.matmul`` +
   ``torch.topk`` on the fp32 table as a yardstick, and the bound;
4. serve — the ``repro_torch.launch.serve --arch qwen1.5-0.5b --loop`` path
   in process, 64 requests, batch 4, row mode, through MIPSServeEngine,
   once per configuration: fp32, ``--precision int8``, ``--precision
   int4``, ``--precision pq`` and ``--precision int8 --adaptive --bound
   bernstein``.  The launch counts are set to 0 just before each run and
   read just after it: the run's tier must have been launched once per
   dispatch.  Every flush is then held against the plain version on the
   same permutation, and the served scores must be the exact inner
   products of the served ids;
5. a ``kernels`` JSON line, one entry per tier, and last the ``ok`` JSON
   line.

Agreement rule, kernel vs plain version: ids equal per query, or — a
near-tie, counted and printed — every differing candidate's exact float64
score within 1e-5 relative of the candidate it replaced (fp32 sums taken
in another order may swap two rows whose scores tie to ~1e-7).  Scores
agree to rtol 1e-5 for the same reason; the int8 and int4 accumulators
(and so their unscaled scores) must be bitwise equal, and adaptive
``rounds_used`` equal.  Served scores agree with float64 exact scores to
rtol 1e-4: one fp32 sum over 1024 products of mixed sign carries ~1e-5
relative error on values of the top-K's size.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
INT8_OPS_PER_S = 1979e12       # H100 SXM int8, dense
TPU_KERNEL = "src/repro/kernels/fused_cascade.py:563"
SOURCE = "src/repro_torch/kernels/csrc/fused_cascade.cu"
B, K, EPS, DELTA = 4, 4, 0.1, 0.1
SCORE_RTOL = 1e-5
EXACT_RTOL = 1e-4
#: (label, precision, adaptive, bound) of every tier the serve path runs
TIERS = [("fp32", "fp32", False, "hoeffding"),
         ("int8", "int8", False, "hoeffding"),
         ("int4", "int4", False, "hoeffding"),
         ("pq", "pq", False, "hoeffding"),
         ("int8+adaptive", "int8", True, "bernstein")]


class SmokeFailure(Exception):
    """A check of this script failed."""


def say(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def time_cuda(fn, n: int, warmup: int) -> float:
    """Median milliseconds of ``fn`` over ``n`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(table, Q, got, ref, *, what: str, bitwise: bool = False) -> dict:
    """Hold kernel (ids, vals[, rounds_used]) against the plain version's,
    per query."""
    ids_k, vals_k = (t.cpu() for t in got[:2])
    ids_p, vals_p = (t.cpu() for t in ref[:2])
    check(ids_k.shape == ids_p.shape and vals_k.shape == vals_p.shape,
          f"{what}: shapes {tuple(ids_k.shape)} vs {tuple(ids_p.shape)}")
    if len(got) > 2:
        check(torch.equal(got[2].cpu(), ref[2].cpu()),
              f"{what}: rounds_used {got[2].tolist()} vs plain "
              f"{ref[2].tolist()}")
    near_ties = 0
    for b in range(ids_k.shape[0]):
        diff = (ids_k[b] != ids_p[b]).nonzero().flatten()
        if diff.numel() == 0:
            continue
        check(not bitwise, f"{what}: query {b} ids {ids_k[b].tolist()} vs "
              f"plain {ids_p[b].tolist()} on a bitwise tier")
        q = Q[b].double()
        for j in diff.tolist():
            a, c = int(ids_k[b, j]), int(ids_p[b, j])
            sa = float(table[a].double() @ q)
            sc = float(table[c].double() @ q)
            check(abs(sa - sc) <= 1e-5 * abs(sc),
                  f"{what}: query {b} position {j}: kernel id {a} "
                  f"(exact {sa:.9g}) vs plain id {c} (exact {sc:.9g})")
        near_ties += 1
    fin_k, fin_p = torch.isfinite(vals_k), torch.isfinite(vals_p)
    check(bool((fin_k == fin_p).all()),
          f"{what}: -inf entries differ between kernel and plain version")
    check(bool((vals_k[~fin_k] == vals_p[~fin_p]).all()),
          f"{what}: non-finite scores differ")
    err = float((vals_k[fin_k] - vals_p[fin_p]).abs().max()) if bool(
        fin_k.any()) else 0.0
    if bitwise:
        check(err == 0.0, f"{what}: scores differ (max abs {err:.3g}) on a "
              f"bitwise tier")
    check(torch.allclose(vals_k[fin_k], vals_p[fin_p], rtol=SCORE_RTOL,
                         atol=0.0),
          f"{what}: scores differ beyond rtol {SCORE_RTOL} "
          f"(max abs {err:.3g})")
    return {"near_tie_queries": near_ties, "max_abs_err": err}


def phase_device() -> None:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(line, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"device: {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()}, torch {torch.__version__} cuda "
        f"{torch.version.cuda}; TF32 off for matmul and cuDNN")


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import fused_cascade
    builds = {"fused_cascade_batched": fused_cascade.build}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        futures = {name: pool.submit(fn) for name, fn in builds.items()}
        results = {name: f.result() for name, f in futures.items()}
    for name, (path, log) in results.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        say(f"build: {name} -> {path.name} {' '.join(regs)}")
    say(f"build: {len(builds)} kernel(s) in "
        f"{time.perf_counter() - t0:.2f} s")


def cascade_operands(plan, V4, Q, perm, *, adaptive=False, quantized=None):
    """The fused cascade's operands and keywords for one batch, built as
    `decode_tiled` builds them."""
    from repro_torch.core.boundedme_torch import decode_operands
    from repro_torch.core.quantize import quantize_blocks
    slotcode, rmeta, bpos, t_final, n_final, cert = decode_operands(
        plan, final_exact=True, adaptive=adaptive, device=V4.device)
    Qb = Q.reshape(Q.shape[0], plan.n_blocks, plan.block).contiguous()
    cols = perm.to(V4.device)[bpos].to(torch.int32).expand(
        Q.shape[0], -1).contiguous()
    kw = dict(n_arms=plan.n, K=plan.K, t_final=t_final, n_final=n_final)
    table = V4
    if plan.precision == "pq":
        table, kw["codebook"] = quantized
    elif plan.precision != "fp32":
        table, kw["vscale"] = quantized
        Qb, kw["qscale"] = quantize_blocks(Qb)
        kw["packed_int4"] = plan.precision == "int4"
    if adaptive:
        kw.update(cert=cert, k_cert=plan.K,
                  track_var=plan.schedule.bound == "bernstein")
    return (table, Qb, slotcode, rmeta, cols), kw


def tier_plan(table, n_valid, precision, bound, mode):
    from repro_torch.core.boundedme_torch import make_measured_plan, make_plan
    from repro_torch.core.mips import table_abs_max
    n, N = table.shape
    kw = dict(K=K, eps=EPS, delta=DELTA,
              value_range=2.0 * table_abs_max(table), precision=precision,
              bound=bound, pull_mode=mode)
    if precision == "pq":
        return make_measured_plan(table, **kw)
    return make_plan(n, N, **kw)


def kernel_bound(plan, ops, kw, cells, n_pulls) -> dict:
    """Least time for the work of one launch: each input read once (the
    union of pulled table cells at the tier's stored bytes, their scales
    or the codebook, the queries and schedule operands), each output
    written once; and the pull operations at the card's peak rate for
    their type."""
    R, C = plan.tile, plan.block
    table, Qb, slotcode, rmeta, cols = ops
    nbytes = (cells * R * table.shape[3] * table.element_size()
              + sum(t.numel() * t.element_size()
                    for t in (Qb, slotcode, rmeta, cols))
              + B * K * 8)
    if plan.precision in ("int8", "int4"):
        nbytes += cells * 4 + kw["qscale"].numel() * 4
        t_ops = 2 * n_pulls * R * C / INT8_OPS_PER_S
    elif plan.precision == "pq":
        cb = kw["codebook"]
        nbytes += cb.numel() * 4
        lut_flops = 2 * B * cb.numel()
        t_ops = (lut_flops + n_pulls * R * table.shape[3]) / FP32_FLOPS_PER_S
    else:
        t_ops = 2 * n_pulls * R * C / FP32_FLOPS_PER_S
    if "cert" in kw:
        nbytes += kw["cert"].numel() * 4 + B * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {"bytes": nbytes, "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_kernel(table, n_valid) -> dict:
    from repro_torch.core.boundedme_torch import quantize_table, tile_table
    from repro_torch.core.schedule import PULL_BIT, pulls_through_round
    from repro_torch.kernels.fused_cascade import fused_cascade_batched_cuda
    from repro_torch.kernels.ref import fused_cascade_batched_ref
    from repro_torch.launch.engine import seeded_perm

    n, N = table.shape
    Q = torch.from_numpy(np.random.default_rng(1234).normal(
        size=(B, N)).astype(np.float32)).cuda()
    mask = torch.arange(n, device=table.device)[:, None] >= n_valid

    def library():
        s = (table @ Q.T).masked_fill_(mask, -torch.inf)
        return torch.topk(s, K, dim=0)
    library_ms = time_cuda(library, 10, 2)
    out = {}
    for mode in ("row", "coord"):
        V4 = None
        for label, precision, adaptive, bound in TIERS:
            plan = tier_plan(table, n_valid, precision, bound, mode)
            if V4 is None:
                V4 = tile_table(table, plan)
            quant = (quantize_table(V4, plan) if precision != "fp32"
                     else None)
            perm = seeded_perm(0, 0, plan.n_blocks)
            ops, kw = cascade_operands(plan, V4, Q, perm, adaptive=adaptive,
                                       quantized=quant)
            bitwise = precision in ("int8", "int4")
            errs, ties = [], 0
            for k_out in ((K, 2 * K) if label == "fp32" else (K,)):
                pulled = torch.zeros((plan.n_tiles, plan.n_blocks),
                                     dtype=torch.bool, device=V4.device)
                got = fused_cascade_batched_cuda(*ops, k_out=k_out,
                                                 n_valid=n_valid, **kw)
                ref = fused_cascade_batched_ref(*ops, k_out=k_out,
                                                n_valid=n_valid,
                                                pulled=pulled, **kw)
                torch.cuda.synchronize()
                r = compare(table, Q, got, ref, bitwise=bitwise,
                            what=f"{label} {mode} k_out={k_out}")
                errs.append(r["max_abs_err"])
                ties += r["near_tie_queries"]
                if k_out == K:
                    cells = int(pulled.sum())
                    rounds = got[2].tolist() if adaptive else None
            steps = int(((ops[2].cpu() & PULL_BIT) != 0).sum())
            if adaptive:   # the pulls this run's queries made
                through = pulls_through_round(plan.schedule)
                n_pulls = int(sum(through[r] for r in rounds))
            else:
                n_pulls = steps * B
            bound_info = kernel_bound(plan, ops, kw, cells, n_pulls)
            kernel_ms = time_cuda(lambda: fused_cascade_batched_cuda(
                *ops, n_valid=n_valid, **kw), 10, 2)
            plain_ms = time_cuda(lambda: fused_cascade_batched_ref(
                *ops, n_valid=n_valid, **kw), 3, 1)
            res = {
                "S": ops[2].numel(), "rounds": len(plan.schedule.rounds),
                "quant_err": plan.quant_err,
                "eps_effective": plan.eps_effective,
                "speedup": plan.schedule.speedup, "pulls": n_pulls,
                "union_cells": cells, **bound_info,
                "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "max_abs_err": max(errs),
                "near_tie_queries": ties}
            if adaptive:
                res["rounds_used"] = rounds
            out[(label, mode)] = res
            say(f"kernel {label} {mode}: " + json.dumps(res))
            del ops, pulled, quant
        del V4
        torch.cuda.empty_cache()

    # fewer live rows than k_out: filler ids carry -inf and never repeat
    from repro_torch.core.boundedme_torch import make_plan
    rng = np.random.default_rng(5)
    small = torch.from_numpy(rng.normal(size=(96, 512)).astype(
        np.float32)).cuda()
    Qs = torch.from_numpy(rng.normal(size=(2, 512)).astype(
        np.float32)).cuda()
    for precision in ("fp32", "int8"):
        plan = make_plan(96, 512, K=5, eps=0.7, delta=0.1, value_range=8.0,
                         block=64, precision=precision)
        V4s = tile_table(small, plan)
        ops, kw = cascade_operands(
            plan, V4s, Qs, seeded_perm(0, 1, plan.n_blocks),
            quantized=(quantize_table(V4s, plan) if precision != "fp32"
                       else None))
        got = fused_cascade_batched_cuda(*ops, k_out=7, n_valid=3, **kw)
        ref = fused_cascade_batched_ref(*ops, k_out=7, n_valid=3, **kw)
        compare(small, Qs, got, ref, bitwise=precision == "int8",
                what=f"small {precision} n_valid=3 k_out=7")
        for b in range(2):
            ids, vals = got[0][b].cpu(), got[1][b].cpu()
            check(sorted(ids[torch.isfinite(vals)].tolist()) == [0, 1, 2]
                  and len(set(ids.tolist())) == 7,
                  f"small {precision} case: live ids {ids.tolist()} / "
                  f"scores {vals.tolist()}")
    say("kernel small: fewer live rows than k_out ok (fp32, int8)")
    return out


@contextlib.contextmanager
def plain_route():
    """Send CUDA tensors to the plain PyTorch version (for the reference
    answers only: no launch is counted inside)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ref import fused_cascade_batched_ref
    kernel = kops.fused_cascade_batched_cuda
    kops.fused_cascade_batched_cuda = fused_cascade_batched_ref
    try:
        yield
    finally:
        kops.fused_cascade_batched_cuda = kernel


def serve_run(label, precision, adaptive, bound) -> dict:
    from repro_torch.core.boundedme_torch import decode_tiled
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import serve

    argv = ["--arch", "qwen1.5-0.5b", "--loop", "--requests", "64",
            "--batch", "4", "--pull-mode", "row", "--precision", precision,
            "--bound", bound] + (["--adaptive"] if adaptive else [])
    args = serve.parse_args(argv)
    engine, qs = serve.build_loop(args)
    ex = engine.executor
    flushes = []
    dispatch = ex.dispatch

    def recording_dispatch(Qbuf, perm):
        out = dispatch(Qbuf, perm)
        flushes.append((Qbuf.copy(), perm, out))
        return out
    ex.dispatch = recording_dispatch
    plan = engine.plan
    say(f"serve {label}: table=({engine.n},{engine.N}) n_valid={ex.n_valid} "
        f"rounds={len(plan.schedule.rounds)} precision={plan.precision} "
        f"quant_err={plan.quant_err:.6g} eps_eff={plan.eps_effective:.4f} "
        f"adaptive={adaptive} bound={bound} pull_mode={plan.pull_mode} "
        f"block={plan.block}")
    name = f"fused_cascade_batched[{label}]"
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    stats = serve.simulate_stream(engine, qs,
                                  interarrival_ms=args.interarrival_ms,
                                  pattern=args.pattern,
                                  seed=args.stream_seed)
    wall = time.perf_counter() - t0
    counts = kops.launch_counts()
    launches = counts[name]
    check(ex.n_dispatches > 0 and launches == ex.n_dispatches
          and counts["fused_cascade_batched"] == ex.n_dispatches,
          f"serve {label}: {launches} {name} launches "
          f"({counts['fused_cascade_batched']} in all) for "
          f"{ex.n_dispatches} dispatches")
    check(stats["completed"] == args.requests,
          f"serve {label}: {stats['completed']} of {args.requests} "
          f"completed")

    table = ex.tiled_table.permute(0, 2, 1, 3).reshape(
        -1, ex.tiled_table.shape[1] * plan.block)[:engine.n, :engine.N]
    errs, ties = [], 0
    for Qbuf, perm, out in flushes:
        Q = torch.from_numpy(Qbuf).cuda()
        with plain_route():
            ref = decode_tiled(ex.tiled_table, Q, perm, plan=plan,
                               final_exact=True, n_valid=ex.n_valid,
                               quantized=ex.quantized, adaptive=adaptive)
        got = [torch.from_numpy(out[0]), torch.from_numpy(out[1])]
        if adaptive:
            got.append(torch.from_numpy(out[2]))
        r = compare(table, Q, got, ref, what=f"serve {label} flush")
        errs.append(r["max_abs_err"])
        ties += r["near_tie_queries"]
    for rid in range(args.requests):
        res = engine.result(rid)
        check(res is not None, f"serve {label}: request {rid} has no result")
        ids, scores = res
        check(len(set(ids.tolist())) == K and int(ids.max()) < ex.n_valid,
              f"serve {label}: request {rid} ids {ids.tolist()}")
        exact = (table[torch.from_numpy(ids.astype(np.int64)).cuda()].double()
                 @ torch.from_numpy(qs[rid]).cuda().double()) / engine.N
        check(np.allclose(scores, exact.cpu().numpy(), rtol=EXACT_RTOL,
                          atol=0.0),
              f"serve {label}: request {rid} scores {scores.tolist()} vs "
              f"exact {exact.tolist()}")
    lat = stats["latency_ms"]
    res = {"launches": launches, "dispatches": ex.n_dispatches,
           "max_abs_err": max(errs), "near_tie_queries": ties,
           "p50_ms": lat["p50"], "p95_ms": lat["p95"],
           "throughput_rps": stats["throughput_rps"], "wall_s": wall,
           "cache_hits": stats["cache"]["hits"],
           "recall": stats["recall"]["mean"],
           "recall_samples": stats["recall"]["samples"]}
    if adaptive:
        res["adaptive"] = stats["adaptive"]
    say(f"serve {label}: " + json.dumps(res))
    return res


def main() -> int:
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run this "
              f"script from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    try:
        t0 = time.perf_counter()
        phase_device()
        phase_build()
        from repro_torch.configs import get_config
        from repro_torch.convert import make_serving_table
        table, n_valid = make_serving_table(get_config("qwen1.5-0.5b"), 0,
                                            "cuda")
        kern = phase_kernel(table, n_valid)
        del table
        torch.cuda.empty_cache()
        served = {}
        for tier in TIERS:
            served[tier[0]] = serve_run(*tier)
            torch.cuda.empty_cache()
        say(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    entries = []
    for label, precision, adaptive, bound in TIERS:
        row, coord, srv = kern[(label, "row")], kern[(label, "coord")], \
            served[label]
        entries.append({
            "name": ("fused_cascade_batched" if label == "fp32"
                     else f"fused_cascade_batched[{label}]"),
            "route": "cuda", "source": SOURCE, "replaces": TPU_KERNEL,
            "launches": srv["launches"],
            "max_abs_err": max(row["max_abs_err"], coord["max_abs_err"],
                               srv["max_abs_err"]),
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "coord_ms": coord["kernel_ms"],
            "coord_plain_ms": coord["plain_ms"],
            "coord_bound_ms": coord["bound_ms"],
            "precision": precision, "adaptive": adaptive, "bound": bound,
            "held_against_plain": True})
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
