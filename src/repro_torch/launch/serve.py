"""Serving CLI of the port: the micro-batching request loop.

The PyTorch counterpart of ``repro.launch.serve --loop``: a seeded query
stream is served against the vocab table of an architecture (its tied
embedding, ``(padded_vocab, d_model)`` with the padding rows masked) by
`MIPSServeEngine`, one fused-cascade launch per micro-batch::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b --loop

It runs on the CUDA card unless ``--device cpu`` is given.  The table is
drawn N(0, 0.02) from seed 0 (`repro_torch.convert`).  ``--precision
int8|int4|pq`` serves through the kernel's quantized tiers (pq with a
quant_err calibrated on the table, ``--pq-subdims`` wide subspaces) and
``--adaptive [--bound hoeffding|bernstein]`` through its early-exit
lanes::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --loop --precision pq --adaptive --bound bernstein

Modes and options of later slices — the decode demo, ``--runtime``,
``--dynamic``, ``--tenants``, ``--shards`` > 1 — are refused with a
message naming their ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Tuple

import numpy as np

from repro_torch.configs import get_config
from repro_torch.convert import make_serving_table
from repro_torch.core.boundedme_torch import resolve_device
from repro_torch.launch.engine import MIPSServeEngine

__all__ = ["arrival_trace", "simulate_stream", "build_loop", "main"]

#: namespace tag so trace streams never alias other default_rng users
_TRACE_ROOT = 0x7AC3


def arrival_trace(n: int, *, interarrival_ms: float = 0.1,
                  pattern: str = "uniform", seed: int = 0,
                  burst_factor: float = 8.0, burst_len: int = 16,
                  tail: float = 1.5) -> np.ndarray:
    """Reproducible (n,) arrival times in seconds for a query stream.

    Patterns (all with mean spacing ``interarrival_ms`` except bursty's
    heavy tail): ``uniform`` — exactly ``i * interarrival_ms``;
    ``poisson`` — i.i.d. exponential gaps; ``bursty`` — geometric-length
    bursts spaced ``interarrival_ms / burst_factor`` apart, separated by
    Pareto(``tail``) heavy-tailed quiet gaps.  The trace is a pure
    function of ``(seed, pattern, parameters)`` and equals the JAX
    package's.
    """
    d = float(interarrival_ms) * 1e-3
    if n <= 0:
        return np.zeros(0, np.float64)
    if pattern == "uniform":
        return np.arange(n, dtype=np.float64) * d
    rng = np.random.default_rng(
        np.random.SeedSequence([_TRACE_ROOT, int(seed)]))
    if pattern == "poisson":
        gaps = rng.exponential(d, size=n)
        gaps[0] = 0.0
        return np.cumsum(gaps)
    if pattern == "bursty":
        gaps = np.empty(n, np.float64)
        i = 0
        while i < n:
            blen = min(n - i, max(1, int(rng.geometric(1.0 / burst_len))))
            gaps[i] = (0.0 if i == 0
                       else d * burst_len * (0.5 + rng.pareto(tail)))
            gaps[i + 1:i + blen] = d / burst_factor
            i += blen
        return np.cumsum(gaps)
    raise ValueError(f"unknown arrival pattern {pattern!r}; "
                     f"use uniform | poisson | bursty")


def simulate_stream(engine, queries, *, interarrival_ms: float = 0.1,
                    pattern: str = "uniform", seed: int = 0,
                    metrics_out=None) -> dict:
    """Drive a query stream through an engine on a virtual clock.

    Arrivals follow a reproducible `arrival_trace` on a simulated clock
    that only advances by arrival spacing and by the *measured* compute
    time of each dispatch, so batching and deadline dynamics run as in
    wall-clock serving without sleeps.  One submit per poll, as the JAX
    package's closed-ish loop.
    ``metrics_out`` (optional path) receives the metrics registry
    snapshot after the drain.  Returns the engine stats plus
    ``virtual_s``, ``throughput_rps`` and the ``trace`` metadata.
    """
    n = len(queries)
    trace = arrival_trace(n, interarrival_ms=interarrival_ms,
                          pattern=pattern, seed=seed)
    now = 0.0
    for i in range(n):
        now = max(now, float(trace[i]))
        engine.submit(queries[i], now=now)
        _, busy = engine.poll(now=now)
        now += busy
        # batch-wait timer: flush a partial batch after the deadline even
        # with no new arrival to wake the loop
        t_next = float(trace[i + 1]) if i + 1 < n else np.inf
        while engine.pending_count and now + engine.deadline_s < t_next:
            now += engine.deadline_s
            _, busy = engine.poll(now=now)
            now += busy
    while engine.pending_count:
        now += engine.deadline_s
        _, busy = engine.poll(now=now)
        now += busy
    span = float(trace[-1]) if n else 0.0
    artifacts = {}
    if metrics_out is not None:
        engine.metrics.write(metrics_out)
        artifacts["metrics"] = str(metrics_out)
    return {"virtual_s": now,
            "throughput_rps": max(1, n) / max(now, 1e-9),
            "trace": {"pattern": pattern, "seed": int(seed),
                      "interarrival_ms": float(interarrival_ms),
                      "span_s": span,
                      "offered_rps": n / max(span, 1e-9) if n else 0.0},
            **({"artifacts": artifacts} if artifacts else {}),
            **engine.stats()}


def build_loop(args) -> Tuple[MIPSServeEngine, np.ndarray]:
    """The ``--loop`` engine over the arch's vocab table, and its queries.

    Queries are N(0, 1) from ``default_rng(0)`` with the last
    ``--repeat-rate`` of them repeating earlier ones, as in the JAX
    package's loop.
    """
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    dev = resolve_device(args.device)
    table, n_valid = make_serving_table(cfg, 0, dev)
    engine = MIPSServeEngine(
        table, K=args.topk, eps=args.eps, delta=args.delta,
        block=min(512, cfg.d_model), n_valid=n_valid,
        batch_size=args.batch, deadline_ms=args.deadline_ms,
        recall_sample_rate=args.recall_rate,
        cache_entries=args.cache_entries, precision=args.precision,
        adaptive=args.adaptive, bound=args.bound, pull_mode=args.pull_mode,
        pq_subdims=args.pq_subdims, seed=args.stream_seed, device=dev)
    rng = np.random.default_rng(0)
    qs = rng.normal(size=(args.requests, engine.N)).astype(np.float32)
    if args.repeat_rate > 0:                  # cacheable duplicate queries
        n_dup = int(args.requests * args.repeat_rate)
        idx = rng.integers(0, max(1, args.requests - n_dup), n_dup)
        qs[args.requests - n_dup:] = qs[idx]
    return engine, qs


def run_loop(args) -> dict:
    """``--loop``: serve the stream and print the stats as JSON."""
    engine, qs = build_loop(args)
    plan = engine.plan
    print(f"[serve] loop: table=({engine.n},{engine.N}) device={args.device} "
          f"K={args.topk} eps={args.eps} batch={args.batch} "
          f"deadline={args.deadline_ms}ms rounds={len(plan.schedule.rounds)} "
          f"precision={plan.precision} quant_err={plan.quant_err:.6g} "
          f"eps_eff={plan.eps_effective:.4f} adaptive={args.adaptive} "
          f"bound={args.bound} pull_mode={plan.pull_mode} "
          f"block={plan.block} "
          f"pull_speedup={plan.schedule.speedup:.2f}x", flush=True)
    stats = simulate_stream(engine, qs, interarrival_ms=args.interarrival_ms,
                            pattern=args.pattern, seed=args.stream_seed,
                            metrics_out=args.metrics_out)
    print(json.dumps(stats, indent=2))
    return stats


#: options of later slices: (flag, is-set test, ROADMAP.md item)
_LATER = (
    ("--runtime", lambda a: a.runtime,
     "queue 1 item 8 (ServeRuntime, admission, faults)"),
    ("--dynamic", lambda a: a.dynamic, "queue 1 item 7 (dynamic stores)"),
    ("--tenants", lambda a: a.tenants is not None,
     "queue 1 item 9 (multi-tenant serving)"),
    ("--shards > 1", lambda a: a.shards > 1,
     "queue 1 item 10 (sharded serving)"),
)


def _validate_args(ap: argparse.ArgumentParser, args) -> None:
    """Refuse what this slice does not serve, and bad values, up front."""
    if not args.loop:
        ap.error("only --loop is ported: the decode demo needs the model "
                 "zoo (ROADMAP.md queue 1 item 11)")
    for flag, is_set, item in _LATER:
        if is_set(args):
            ap.error(f"{flag} is not ported yet: ROADMAP.md {item}")
    if args.deadline_ms <= 0:
        ap.error(f"--deadline-ms must be > 0, got {args.deadline_ms}")
    if args.batch < 1:
        ap.error(f"--batch must be >= 1, got {args.batch}")
    if args.requests < 1:
        ap.error(f"--requests must be >= 1, got {args.requests}")
    if not 0.0 <= args.repeat_rate <= 1.0:
        ap.error(f"--repeat-rate must be in [0, 1], got {args.repeat_rate}")
    if args.pq_subdims < 1:
        ap.error(f"--pq-subdims must be >= 1, got {args.pq_subdims}")


def _build_parser() -> argparse.ArgumentParser:
    """The serve CLI parser (separate from `main` so tests and
    ``chip_smoke.py`` can drive it with their own argv)."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="serve the arch's reduced smoke() table")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) launches the CUDA kernel; "
                         "'cpu' runs the plain PyTorch version")
    ap.add_argument("--eps", type=float, default=0.1)
    ap.add_argument("--delta", type=float, default=0.1)
    ap.add_argument("--precision", default="fp32",
                    choices=["fp32", "int8", "int4", "pq"],
                    help="sampling arithmetic of the cascade: int8/int4 "
                         "quantized pulls under widened bounds (int4 "
                         "nibble-packed), pq codebook pulls under a "
                         "quant_err measured on the table")
    ap.add_argument("--pq-subdims", type=int, default=8,
                    help="product-quantization subspace width "
                         "(--precision pq; must divide the block width)")
    ap.add_argument("--adaptive", action="store_true",
                    help="certify per-query early exit at round ends")
    ap.add_argument("--bound", default="hoeffding",
                    choices=["hoeffding", "bernstein"],
                    help="certification radius family for --adaptive")
    ap.add_argument("--pull-mode", default="row",
                    choices=["row", "coord", "hybrid"])
    ap.add_argument("--batch", type=int, default=4,
                    help="micro-batch size (kernel lanes)")
    ap.add_argument("--loop", action="store_true",
                    help="run the micro-batching MIPS request loop")
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--deadline-ms", type=float, default=2.0,
                    help="batch-assembly wait (micro-batch deadline)")
    ap.add_argument("--interarrival-ms", type=float, default=0.1)
    ap.add_argument("--topk", type=int, default=4)
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--cache-entries", type=int, default=512)
    ap.add_argument("--repeat-rate", type=float, default=0.1,
                    help="fraction of requests repeating an earlier query")
    ap.add_argument("--recall-rate", type=float, default=0.05)
    ap.add_argument("--dynamic", action="store_true")
    ap.add_argument("--runtime", action="store_true")
    ap.add_argument("--tenants", default=None, metavar="SPEC.json")
    ap.add_argument("--pattern", default="uniform",
                    choices=["uniform", "poisson", "bursty"],
                    help="arrival pattern of the simulated stream")
    ap.add_argument("--stream-seed", type=int, default=0,
                    help="seed of the arrival trace and of the engine's "
                         "block permutations")
    ap.add_argument("--metrics-out", default=None,
                    help="write the metrics-registry snapshot here after "
                         "the stream (.prom/.txt = Prometheus text, "
                         "anything else = JSON)")
    return ap


def parse_args(argv: Optional[list] = None):
    """Parse and validate serve CLI arguments."""
    ap = _build_parser()
    args = ap.parse_args(argv)
    _validate_args(ap, args)
    return args


def main(argv: Optional[list] = None) -> None:
    """CLI entry point."""
    run_loop(parse_args(argv))


if __name__ == "__main__":
    main()
