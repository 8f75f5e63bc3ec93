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
   kernel is held against its plain PyTorch version on the same operands
   in 'row' and 'coord' pull mode, at k_out = K and 2K, plus a small case
   with fewer live rows than k_out; each mode is timed: the kernel (median
   of 10 launches after 2 warm-ups, CUDA events), the plain version, exact
   ``torch.matmul`` + ``torch.topk`` as a yardstick, and the bound;
4. serve — the ``repro_torch.launch.serve --arch qwen1.5-0.5b --loop`` path
   in process: 64 requests, batch 4, row mode, through MIPSServeEngine;
   every flush is held against the plain version on the same permutation,
   the launch count must equal the dispatch count, and the served scores
   must be the exact inner products of the served ids;
5. a ``kernels`` JSON line, and last the ``ok`` JSON line.

Agreement rule, kernel vs plain version: ids equal per query, or — a
near-tie, counted and printed — every differing candidate's exact float64
score within 1e-5 relative of the candidate it replaced (fp32 sums taken
in another order may swap two rows whose scores tie to ~1e-7).  Scores
agree to rtol 1e-5 for the same reason.  Served scores agree with float64
exact scores to rtol 1e-4: one fp32 sum over 1024 products of mixed sign
carries ~1e-5 relative error on values of the top-K's size.
"""

from __future__ import annotations

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
TPU_KERNEL = "src/repro/kernels/fused_cascade.py:563"
B, K, EPS, DELTA = 4, 4, 0.1, 0.1
SCORE_RTOL = 1e-5
EXACT_RTOL = 1e-4


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


def compare(table, Q, got, ref, *, what: str) -> dict:
    """Hold kernel (ids, vals) against the plain version's, per query."""
    ids_k, vals_k = (t.cpu() for t in got)
    ids_p, vals_p = (t.cpu() for t in ref)
    check(ids_k.shape == ids_p.shape and vals_k.shape == vals_p.shape,
          f"{what}: shapes {tuple(ids_k.shape)} vs {tuple(ids_p.shape)}")
    near_ties = 0
    for b in range(ids_k.shape[0]):
        diff = (ids_k[b] != ids_p[b]).nonzero().flatten()
        if diff.numel() == 0:
            continue
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


def cascade_operands(plan, V4, Q, perm):
    from repro_torch.core.boundedme_torch import schedule_operands
    slotcode, rmeta, bpos, t_final, n_final = schedule_operands(
        plan.schedule, True, V4.device)
    Qb = Q.reshape(Q.shape[0], plan.n_blocks, plan.block).contiguous()
    cols = perm.to(V4.device)[bpos].to(torch.int32).expand(
        Q.shape[0], -1).contiguous()
    kw = dict(n_arms=plan.n, K=plan.K, t_final=t_final, n_final=n_final)
    return (V4, Qb, slotcode, rmeta, cols), kw


def phase_kernel(table, n_valid) -> dict:
    from repro_torch.core.boundedme_torch import make_plan, tile_table
    from repro_torch.core.mips import table_abs_max
    from repro_torch.kernels.fused_cascade import fused_cascade_batched_cuda
    from repro_torch.kernels.ref import fused_cascade_batched_ref
    from repro_torch.launch.engine import seeded_perm

    n, N = table.shape
    Q = torch.from_numpy(np.random.default_rng(1234).normal(
        size=(B, N)).astype(np.float32)).cuda()
    value_range = 2.0 * table_abs_max(table)
    out = {}
    for mode in ("row", "coord"):
        plan = make_plan(n, N, K=K, eps=EPS, delta=DELTA,
                         value_range=value_range, pull_mode=mode)
        V4 = tile_table(table, plan)
        perm = seeded_perm(0, 0, plan.n_blocks)
        ops, kw = cascade_operands(plan, V4, Q, perm)
        errs, ties = [], 0
        for k_out in (K, 2 * K):
            pulled = torch.zeros((plan.n_tiles, plan.n_blocks),
                                 dtype=torch.bool, device=V4.device)
            got = fused_cascade_batched_cuda(*ops, k_out=k_out,
                                             n_valid=n_valid, **kw)
            ref = fused_cascade_batched_ref(*ops, k_out=k_out,
                                            n_valid=n_valid, pulled=pulled,
                                            **kw)
            torch.cuda.synchronize()
            r = compare(table, Q, got, ref,
                        what=f"{mode} k_out={k_out}")
            errs.append(r["max_abs_err"])
            ties += r["near_tie_queries"]
            if k_out == K:
                cells = int(pulled.sum())
        S = ops[2].numel()
        n_pulls = int(((ops[2].cpu() & (1 << 30)) != 0).sum()) * B
        R, C = plan.tile, plan.block
        bytes_moved = (cells * R * C * 4 + ops[1].numel() * 4
                       + ops[2].numel() * 4 + ops[3].numel() * 4
                       + ops[4].numel() * 4 + B * K * 8)
        flops = 2 * n_pulls * R * C
        t_bytes = bytes_moved / HBM_BYTES_PER_S
        t_ops = flops / FP32_FLOPS_PER_S
        kernel_ms = time_cuda(lambda: fused_cascade_batched_cuda(
            *ops, n_valid=n_valid, **kw), 10, 2)
        plain_ms = time_cuda(lambda: fused_cascade_batched_ref(
            *ops, n_valid=n_valid, **kw), 3, 1)
        mask = torch.arange(n, device=table.device)[:, None] >= n_valid

        def library():
            s = (table @ Q.T).masked_fill_(mask, -torch.inf)
            return torch.topk(s, K, dim=0)
        library_ms = time_cuda(library, 10, 2)
        out[mode] = {
            "S": S, "rounds": len(plan.schedule.rounds),
            "n_tiles": plan.n_tiles, "n_blocks": plan.n_blocks,
            "speedup": plan.schedule.speedup, "pulls": n_pulls,
            "pulled_bytes": n_pulls * R * C * 4,
            "pulled_bound_ms": 1e3 * n_pulls * R * C * 4 / HBM_BYTES_PER_S,
            "union_bytes": cells * R * C * 4, "bytes": bytes_moved,
            "flops": flops, "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "max_abs_err": max(errs),
            "near_tie_queries": ties}
        say(f"kernel {mode}: " + json.dumps(out[mode]))
        del V4, ops, pulled
        torch.cuda.empty_cache()

    # fewer live rows than k_out: filler ids carry -inf and never repeat
    rng = np.random.default_rng(5)
    small = torch.from_numpy(rng.normal(size=(96, 512)).astype(
        np.float32)).cuda()
    Qs = torch.from_numpy(rng.normal(size=(2, 512)).astype(
        np.float32)).cuda()
    plan = make_plan(96, 512, K=5, eps=0.7, delta=0.1, value_range=8.0,
                     block=64)
    ops, kw = cascade_operands(plan, tile_table(small, plan), Qs,
                               seeded_perm(0, 1, plan.n_blocks))
    got = fused_cascade_batched_cuda(*ops, k_out=7, n_valid=3, **kw)
    ref = fused_cascade_batched_ref(*ops, k_out=7, n_valid=3, **kw)
    compare(small, Qs, got, ref, what="small n_valid=3 k_out=7")
    for b in range(2):
        ids, vals = got[0][b].cpu(), got[1][b].cpu()
        check(sorted(ids[torch.isfinite(vals)].tolist()) == [0, 1, 2]
              and len(set(ids.tolist())) == 7,
              f"small case: live ids {ids.tolist()} / scores "
              f"{vals.tolist()}")
    say("kernel small: fewer live rows than k_out ok")
    return out


def phase_serve() -> dict:
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ref import fused_cascade_batched_ref
    from repro_torch.launch import serve

    args = serve.parse_args(["--arch", "qwen1.5-0.5b", "--loop",
                             "--requests", "64", "--batch", "4",
                             "--pull-mode", "row"])
    engine, qs = serve.build_loop(args)
    ex = engine.executor
    flushes = []
    dispatch = ex.dispatch

    def recording_dispatch(Qbuf, perm):
        out = dispatch(Qbuf, perm)
        flushes.append((Qbuf.copy(), perm, out[0], out[1]))
        return out
    ex.dispatch = recording_dispatch
    say(f"serve: table=({engine.n},{engine.N}) n_valid={ex.n_valid} "
        f"rounds={len(engine.plan.schedule.rounds)} "
        f"pull_mode={engine.plan.pull_mode} block={engine.plan.block}")
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    stats = serve.simulate_stream(engine, qs,
                                  interarrival_ms=args.interarrival_ms,
                                  pattern=args.pattern,
                                  seed=args.stream_seed)
    wall = time.perf_counter() - t0
    launches = kops.launch_counts()["fused_cascade_batched"]
    check(ex.n_dispatches > 0 and launches == ex.n_dispatches,
          f"serve: {launches} kernel launches for {ex.n_dispatches} "
          f"dispatches")
    check(stats["completed"] == args.requests,
          f"serve: {stats['completed']} of {args.requests} completed")

    table = ex.tiled_table.permute(0, 2, 1, 3).reshape(engine.n, engine.N)
    plan = engine.plan
    scale = (plan.n_blocks * plan.block) / plan.N
    errs, ties = [], 0
    for Qbuf, perm, ids, scores in flushes:
        Q = torch.from_numpy(Qbuf).cuda()
        ops, kw = cascade_operands(plan, ex.tiled_table, Q, perm)
        rid, rval = fused_cascade_batched_ref(*ops, n_valid=ex.n_valid, **kw)
        r = compare(table, Q,
                    (torch.from_numpy(ids), torch.from_numpy(scores)),
                    (rid, rval * scale), what="serve flush")
        errs.append(r["max_abs_err"])
        ties += r["near_tie_queries"]
    for rid in range(args.requests):
        res = engine.result(rid)
        check(res is not None, f"serve: request {rid} has no result")
        ids, scores = res
        check(len(set(ids.tolist())) == K and int(ids.max()) < ex.n_valid,
              f"serve: request {rid} ids {ids.tolist()}")
        exact = (table[torch.from_numpy(ids.astype(np.int64)).cuda()].double()
                 @ torch.from_numpy(qs[rid]).cuda().double()) / engine.N
        check(np.allclose(scores, exact.cpu().numpy(), rtol=EXACT_RTOL,
                          atol=0.0),
              f"serve: request {rid} scores {scores.tolist()} vs exact "
              f"{exact.tolist()}")
    lat = stats["latency_ms"]
    say(f"serve: {args.requests} requests, {ex.n_dispatches} dispatches, "
        f"{launches} launches, {stats['cache']['hits']} cache hits, "
        f"{ties} near-tie queries; throughput "
        f"{stats['throughput_rps']:.2f} req/s (virtual clock), wall "
        f"{wall:.2f} s; latency p50 {lat['p50']:.3f} ms p95 "
        f"{lat['p95']:.3f} ms; recall@{K} {stats['recall']['mean']:.3f} "
        f"over {stats['recall']['samples']} sampled requests")
    return {"launches": launches, "dispatches": ex.n_dispatches,
            "max_abs_err": max(errs)}


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
        phase_device()
        phase_build()
        from repro_torch.configs import get_config
        from repro_torch.convert import make_serving_table
        table, n_valid = make_serving_table(get_config("qwen1.5-0.5b"), 0,
                                            "cuda")
        kern = phase_kernel(table, n_valid)
        del table
        torch.cuda.empty_cache()
        serve = phase_serve()
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    row = kern["row"]
    print(json.dumps({"kernels": [{
        "name": "fused_cascade_batched", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_cascade.cu",
        "replaces": TPU_KERNEL, "launches": serve["launches"],
        "max_abs_err": max(row["max_abs_err"], serve["max_abs_err"]),
        "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
        "held_against_plain": True}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
