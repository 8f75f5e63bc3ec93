"""Serving CLI of the port: the LM decode demo, the request loop and the
serving runtime.

The default mode is the PyTorch counterpart of ``repro.launch.serve``
without ``--loop``, the paper's feature in production position: a
language model of any family (`repro_torch.models.model.build_model`:
dense, moe, ssm, hybrid, encdec, vlm; weights drawn from seed 0) prefills
a batch of seeded prompts and decodes greedily, and with ``--mips
boundedme`` every decode step picks the next tokens by the BoundedME
bandit over the vocab table — one fused-cascade launch per step, on the
table's own type (bf16 at full width) — in place of the full vocab
matvec and argmax::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --mips boundedme --eps 0.1 --tokens 32

``--mips exact`` decodes with the f32 logits of every row;
``--precision int8|int4`` pulls quantized tiles (pq needs a table to
calibrate on and serves through ``--loop``).  The vlm family's prompts
start with ``n_patches`` seeded patch embeddings (``--prompt-len`` must
cover them), the encdec family's encoder reads ``encoder_seq`` seeded
frames.

With ``--loop``, the counterpart of ``repro.launch.serve --loop
[--runtime]``: a seeded query stream is served against the vocab table of an architecture
(its tied embedding, ``(padded_vocab, d_model)`` with the padding rows
masked) by `MIPSServeEngine`, one fused-cascade launch per micro-batch::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b --loop

With ``--runtime`` the stream is served open loop by the
continuous-batching `ServeRuntime` (admission, three priority classes,
the eps degradation ladder down to ``--eps-floor``, retries, optional
seeded fault injection with ``--inject-*``), one launch per dispatch at
the rung the ladder picks::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --loop --runtime --eps-floor 0.4 --pattern bursty \
        --inject-error-rate 0.05 --check-outcomes

With ``--dynamic`` the vocab table (its ``vocab`` live rows) is served
from a `repro_torch.store.DynamicTableStore` with ``--capacity-slack``
headroom, and ``--churn-rate`` of the arrivals also stage an upsert or a
delete + append pair, drained between dispatches; under ``--runtime``,
``--inject-flush-rate`` fails seeded store flushes::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --loop --runtime --dynamic --churn-rate 0.25 --inject-flush-rate 0.2

It runs on the CUDA card unless ``--device cpu`` is given.  The table is
drawn N(0, 0.02) from seed 0 (`repro_torch.convert`).  ``--precision
int8|int4|pq`` serves through the kernel's quantized tiers (pq with a
quant_err calibrated on the table, ``--pq-subdims`` wide subspaces) and
``--adaptive [--bound hoeffding|bernstein]`` through its early-exit
lanes::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --loop --precision pq --adaptive --bound bernstein

With ``--tenants SPEC.json`` (``--loop``, no ``--runtime``) one
`repro_torch.launch.tenancy.MultiTenantRuntime` serves several tenants'
tables on the device: each tenant of the spec file (the JAX package's
format, e.g. ``configs/tenants_smoke.json``) gets a seeded table of its
``rows`` in a `DynamicTableStore`, registered in a `TableRegistry` under
``--table-budget-mb`` (cold tables are paged out least-recently-served
first), and one merged open-loop stream — each tenant at ``rate_factor``
times the base rate — is scheduled by deficit round robin across the
tenants' private queues::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --loop --tenants configs/tenants_smoke.json --table-budget-mb 2048 \
        --check-outcomes

With ``--shards S`` (``--loop``, with or without ``--runtime`` and
``--dynamic``) the vocab table is row-sharded over a serving mesh of S
cards (`repro_torch.launch.mesh.make_serving_mesh`; ``--dynamic``: a
`repro_torch.store.ShardedTableStore`), each dispatch one fused-cascade
launch per shard and the exact cross-shard merge.  As in the JAX
package, the mesh is capped at the cards there are, and on one card (or
on the CPU) the loop serves unsharded; the decode demo ignores
``--shards``.  `build_loop` and `run_loop` also take a mesh from their
caller (one that repeats a device: S shards on one card or on the CPU)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --loop --runtime --dynamic --shards 4 --churn-rate 0.25
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import REGISTRY, get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import make_serving_table
from repro_torch.core.boundedme_torch import resolve_device
from repro_torch.core.schedule import flatten_schedule
from repro_torch.launch.admission import STATUSES, PriorityClass
from repro_torch.launch.engine import (MIPSServeEngine, ServeRuntime,
                                       seeded_perm)
from repro_torch.launch.faults import FaultInjector
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.launch.tenancy import (MultiTenantRuntime, TableRegistry,
                                        TenantConfig)
from repro_torch.models.model import LM, build_model
from repro_torch.models.steps import decode_step, mips_head, prefill_step
from repro_torch.obs import FlightRecorder, SpanTracer
from repro_torch.store import DynamicTableStore, ShardedTableStore

__all__ = ["arrival_trace", "simulate_stream", "make_churn", "build_loop",
           "serve_stream", "load_tenant_spec", "tenant_table",
           "build_tenants", "serve_tenants", "run_tenants", "decode_config",
           "demo_inputs", "run_decode_demo", "main"]

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
                    churn=None, pattern: str = "uniform", seed: int = 0,
                    open_loop: bool = False,
                    classes: Optional[Callable[[int], str]] = None,
                    tenants: Optional[Callable[[int], str]] = None,
                    burst_factor: float = 8.0, burst_len: int = 16,
                    trace=None, metrics_out=None, trace_out=None) -> dict:
    """Drive a query stream through an engine or runtime on a virtual clock.

    Arrivals follow a reproducible `arrival_trace` (``pattern`` /
    ``seed`` / ``burst_*``; or pass an explicit ``trace`` array) on a
    simulated clock that only advances by arrival spacing and by the
    *measured* compute time of each dispatch, so batching, deadline and
    overload dynamics run as in wall-clock serving without sleeps.

    ``open_loop=True`` stamps each submit at its *true* trace arrival
    time even when the virtual clock has already passed it, and admits
    every arrival the clock has overtaken *before* the next poll
    (arrivals keep coming while the server is busy — the load model
    under which queues grow and shedding fires).  The default closed-ish
    loop (arrivals wait for the clock, one submit per poll) is the
    micro-batching engine's.  ``churn(engine, i)`` (optional) runs before
    each arrival — stage store mutations there to simulate a live
    corpus.  ``classes(i)`` (`ServeRuntime` only) names the priority
    class of arrival ``i``; ``tenants(i)`` (`MultiTenantRuntime` only)
    names the tenant whose table serves it — a multi-tenant trace is a
    merged arrival trace plus this routing function.

    ``metrics_out`` / ``trace_out`` (optional paths) receive the metrics
    registry snapshot and the span tracer's Chrome trace-event JSON
    after the drain; the paths written are echoed in an ``artifacts``
    block.  Returns the engine stats plus ``virtual_s``,
    ``throughput_rps`` and the ``trace`` metadata, as the JAX package's.
    """
    n = len(queries)
    if trace is None:
        trace = arrival_trace(n, interarrival_ms=interarrival_ms,
                              pattern=pattern, seed=seed,
                              burst_factor=burst_factor,
                              burst_len=burst_len)
    trace = np.asarray(trace, np.float64)
    now = 0.0
    i = 0
    while i < n:
        now = max(now, float(trace[i]))
        # admit arrival i — and, open loop, every later arrival already
        # overdue because the clock advanced while the server was busy
        while True:
            if churn is not None:
                churn(engine, i)
            kw = {} if classes is None else {"cls": classes(i)}
            if tenants is not None:
                kw["tenant"] = tenants(i)
            engine.submit(queries[i],
                          now=(float(trace[i]) if open_loop else now), **kw)
            i += 1
            if not (open_loop and i < n and float(trace[i]) <= now):
                break
        _, busy = engine.poll(now=now)
        now += busy
        # batch-wait timer: flush a partial batch after the deadline even
        # with no new arrival to wake the loop
        t_next = float(trace[i]) if i < n else np.inf
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
    if trace_out is not None and getattr(engine, "tracer", None) is not None:
        engine.tracer.write(trace_out)
        artifacts["trace"] = str(trace_out)
    return {"virtual_s": now,
            "throughput_rps": max(1, n) / max(now, 1e-9),
            "trace": {"pattern": pattern, "seed": int(seed),
                      "interarrival_ms": float(interarrival_ms),
                      "open_loop": bool(open_loop),
                      "span_s": span,
                      "offered_rps": n / max(span, 1e-9) if n else 0.0},
            **({"artifacts": artifacts} if artifacts else {}),
            **engine.stats()}


def make_churn(store, churn_rate: float, scale: float):
    """The ``--dynamic`` mutation closure over a `DynamicTableStore` or a
    `ShardedTableStore`: before each arrival, with
    probability ``churn_rate``, stage an upsert of a live id (70 %) or a
    delete + append pair, of a row drawn N(0, scale^2 / N).  Draws come
    from ``default_rng(1)`` in the JAX package's order, so both packages
    stage the same mutations."""
    crng = np.random.default_rng(1)

    def churn(eng, i):
        if crng.random() >= churn_rate:
            return
        row = (scale * crng.normal(size=eng.N) / np.sqrt(eng.N)
               ).astype(np.float32)
        live = store.live_ids()
        if crng.random() < 0.7 or live.size == 0:
            tgt = (int(crng.choice(live)) if live.size
                   else store.append(row) or 0)
            store.upsert(tgt, row)
        elif store.free_rows > 0:
            store.delete(int(crng.choice(live)))
            store.append(row)

    return churn


def build_loop(args, mesh=None) -> Tuple[object, np.ndarray]:
    """The ``--loop`` engine (``--runtime``: the `ServeRuntime`, with its
    span tracer, flight recorder and fault injector as the flags ask)
    over the arch's vocab table, and its queries.

    With ``--dynamic`` the table is a `DynamicTableStore` of the vocab's
    ``vocab`` live rows (no padding rows) and ``--capacity-slack``
    headroom, on the serving device.  ``mesh`` (default
    ``make_serving_mesh(--shards)``, None on one card) shards the table
    over its devices: ``--dynamic`` builds a `ShardedTableStore` (fp32;
    the engines quantize each shard at ``--precision``).  Queries are
    N(0, 1) from ``default_rng(0)`` with the last ``--repeat-rate`` of
    them repeating earlier ones, as in the JAX package's loop.
    """
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    dev = resolve_device(args.device)
    if mesh is None and args.shards > 1:
        mesh = make_serving_mesh(args.shards, device=dev)
    block = min(512, cfg.d_model)
    common = dict(K=args.topk, eps=args.eps, delta=args.delta, mesh=mesh,
                  recall_sample_rate=args.recall_rate,
                  cache_entries=args.cache_entries, precision=args.precision,
                  adaptive=args.adaptive, bound=args.bound,
                  pull_mode=args.pull_mode, pq_subdims=args.pq_subdims,
                  seed=args.stream_seed, device=dev)
    if args.dynamic:
        # the store is fp32, as the JAX package casts the table for it
        rows, _ = make_serving_table(cfg, 0, "cpu")
        rows = rows[:cfg.vocab].float().numpy()
        if mesh is not None:
            table = ShardedTableStore(rows, mesh=mesh, block=block,
                                      capacity_slack=args.capacity_slack)
        else:
            table = DynamicTableStore(
                rows, block=block, capacity_slack=args.capacity_slack,
                precision=args.precision, pq_subdims=args.pq_subdims,
                device=dev)
    else:
        table, n_valid = make_serving_table(cfg, 0, dev)
        common.update(block=block, n_valid=n_valid)
    if args.runtime:
        deadline = args.request_deadline_ms
        classes = {       # interactive is never displaced; batch waits 4x
            "interactive": PriorityClass("interactive", priority=0,
                                         deadline_ms=deadline,
                                         sheddable=False),
            "default": PriorityClass("default", priority=1,
                                     deadline_ms=deadline),
            "batch": PriorityClass("batch", priority=2,
                                   deadline_ms=4 * deadline)}
        engine = ServeRuntime(
            table, eps_floor=args.eps_floor,
            degrade_rungs=args.degrade_rungs, lanes=args.batch,
            batch_wait_ms=args.deadline_ms,
            queue_capacity=args.queue_capacity, classes=classes,
            max_retries=args.max_retries, fault_injector=_injector(args),
            **_observers(args), **common)
    else:
        engine = MIPSServeEngine(
            table, batch_size=args.batch, deadline_ms=args.deadline_ms,
            **common)
    rng = np.random.default_rng(0)
    qs = rng.normal(size=(args.requests, engine.N)).astype(np.float32)
    if args.repeat_rate > 0:                  # cacheable duplicate queries
        n_dup = int(args.requests * args.repeat_rate)
        idx = rng.integers(0, max(1, args.requests - n_dup), n_dup)
        qs[args.requests - n_dup:] = qs[idx]
    return engine, qs


def _injector(args) -> Optional[FaultInjector]:
    """The seeded fault injector the ``--inject-*`` flags ask for."""
    if (args.inject_latency_rate > 0 or args.inject_error_rate > 0
            or args.inject_flush_rate > 0):
        return FaultInjector(
            args.fault_seed, latency_rate=args.inject_latency_rate,
            error_rate=args.inject_error_rate,
            flush_failure_rate=args.inject_flush_rate)
    return None


def _observers(args) -> dict:
    """The span tracer and flight recorder the artifact flags ask for."""
    return {"tracer": (SpanTracer(seed=args.stream_seed) if args.trace_out
                       else None),
            "flight": (FlightRecorder(capacity=args.flight_capacity,
                                      path=args.flight_recorder_path)
                       if args.flight_recorder_path else None)}


def stream_classes(args) -> Optional[Callable[[int], str]]:
    """``--runtime``'s class of each arrival: interactive, default,
    default, batch drawn uniformly from ``--stream-seed + 1``, as the
    JAX package's CLI draws them; None for the engine."""
    if not args.runtime:
        return None
    crng = np.random.default_rng(args.stream_seed + 1)
    names = ("interactive", "default", "default", "batch")
    picks = crng.integers(0, len(names), args.requests)
    return lambda i: names[picks[i]]


def serve_stream(args, engine, qs) -> dict:
    """Serve ``qs`` as the CLI does: the arrival pattern, ``--dynamic``'s
    churn on the engine's store, open loop with the priority classes
    under ``--runtime``, the artifacts the flags name, and a final
    flight-recorder snapshot."""
    store = engine.store
    churn = (make_churn(store, args.churn_rate, float(store.value_abs_max))
             if store is not None and args.churn_rate > 0 else None)
    stats = simulate_stream(
        engine, qs, interarrival_ms=args.interarrival_ms, churn=churn,
        pattern=args.pattern, seed=args.stream_seed,
        open_loop=args.runtime, classes=stream_classes(args),
        metrics_out=args.metrics_out,
        trace_out=args.trace_out if args.runtime else None)
    flight = getattr(engine, "flight", None)
    if flight is not None:
        # always leave a final snapshot on disk, so the artifact exists
        # on a fault-free run too (it supersedes mid-stream failure dumps)
        dumped = flight.dump("end_of_run", stats["virtual_s"])
        if dumped:
            stats.setdefault("artifacts", {})["flight"] = dumped
    return stats


def run_loop(args, mesh=None) -> dict:
    """``--loop``: serve the stream and print the stats as JSON (with
    ``--check-outcomes``, exit non-zero unless the runtime held its
    serving contract); ``mesh`` as in `build_loop`."""
    engine, qs = build_loop(args, mesh)
    plan = engine.plan
    mesh = (engine.executors[0] if args.runtime else engine.executor).mesh
    shards = 1 if mesh is None else mesh.shape["model"]
    if args.runtime:
        print(f"[serve] runtime: table=({engine.n},{engine.N}) "
              f"device={args.device} K={args.topk} eps={args.eps} "
              f"eps_floor={engine.ladder.eps_floor} "
              f"rungs={engine.ladder.n_rungs} lanes={args.batch} "
              f"queue={args.queue_capacity} pattern={args.pattern} "
              f"precision={plan.precision} adaptive={args.adaptive} "
              f"bound={args.bound} pull_mode={args.pull_mode} "
              f"dynamic={bool(args.dynamic)} churn={args.churn_rate} "
              f"shards={shards} "
              f"faults={'on' if engine.injector else 'off'} "
              f"warmup={engine.warmup():.3f}s", flush=True)
    else:
        print(f"[serve] loop: table=({engine.n},{engine.N}) "
              f"device={args.device} K={args.topk} eps={args.eps} "
              f"batch={args.batch} deadline={args.deadline_ms}ms "
              f"dynamic={bool(args.dynamic)} churn={args.churn_rate} "
              f"shards={shards} rounds={len(plan.schedule.rounds)} "
              f"precision={plan.precision} quant_err={plan.quant_err:.6g} "
              f"eps_eff={plan.eps_effective:.4f} adaptive={args.adaptive} "
              f"bound={args.bound} pull_mode={plan.pull_mode} "
              f"block={plan.block} "
              f"pull_speedup={plan.schedule.speedup:.2f}x", flush=True)
    stats = serve_stream(args, engine, qs)
    print(json.dumps(stats, indent=2))
    if args.runtime and args.check_outcomes:
        check_outcomes(args, stats)
    return stats


def check_outcomes(args, stats: dict) -> None:
    """--check-outcomes: exit unless the runtime held its serving
    contract over the stream — reaching this line at all proves no
    exception escaped `simulate_stream`; on top of that every request
    must have finished with exactly one typed status from the closed
    set, and the answered tail latency must stay inside 8x the request
    deadline (expiry bounds queueing; dispatch + retries ride on top)."""
    o = stats["outcomes"]
    unknown = set(o) - set(STATUSES)
    if unknown:
        sys.exit(f"[check] unknown outcome statuses: {sorted(unknown)}")
    total = sum(o.values())
    if total != stats["requests"]:
        sys.exit(f"[check] {stats['requests']} requests but {total} "
                 f"typed outcomes — a request finished without a "
                 f"status, or with two")
    bound = 8.0 * args.request_deadline_ms
    p99 = stats["latency_ms"]["p99"]
    if stats["completed"] and p99 > bound:
        sys.exit(f"[check] p99 {p99:.1f}ms exceeds {bound:.0f}ms "
                 f"(8x --request-deadline-ms)")
    print(f"[check] OK: outcomes closed, {stats['requests']} requests "
          f"all typed, p99 {p99:.1f}ms <= {bound:.0f}ms")


def load_tenant_spec(path: str) -> dict:
    """Parse a ``--tenants`` spec file into {name: spec-dict}.

    The JAX package's format: JSON, either a mapping of tenant name ->
    spec or ``{"tenants": {...}}``.  Each spec holds driver keys —
    ``rows`` (synthetic table rows, required) and ``rate_factor``
    (arrival-rate multiplier against ``--interarrival-ms``, default 1.0)
    — plus any `TenantConfig` field (``eps``, ``precision``, ``weight``,
    ``pinned``, ...).  Unknown keys are refused, so a mistyped knob
    cannot silently serve defaults.
    """
    with open(path) as f:
        spec = json.load(f)
    if isinstance(spec, dict) and isinstance(spec.get("tenants"), dict):
        spec = spec["tenants"]
    if not isinstance(spec, dict) or not spec:
        raise ValueError(f"{path}: expected a non-empty JSON object of "
                         f"tenant name -> spec")
    cfg_fields = {f.name for f in dataclasses.fields(TenantConfig)}
    driver_keys = {"rows", "rate_factor"}
    for name, s in spec.items():
        if not isinstance(s, dict) or "rows" not in s:
            raise ValueError(f"{path}: tenant {name!r} needs at least "
                             f"{{\"rows\": <n>}}")
        unknown = set(s) - cfg_fields - driver_keys
        if unknown:
            raise ValueError(f"{path}: tenant {name!r} has unknown keys "
                             f"{sorted(unknown)}")
        if float(s.get("rate_factor", 1.0)) <= 0:
            raise ValueError(f"{path}: tenant {name!r} rate_factor must "
                             f"be > 0")
    return spec


def tenant_table(rows: int, dim: int, seed: int, idx: int,
                 device) -> torch.Tensor:
    """Tenant ``idx``'s synthetic ``(rows, dim)`` table, N(0, 1 / dim)
    in float32, drawn on ``device`` by a generator seeded from
    ``SeedSequence([_TRACE_ROOT, seed, idx])`` (the JAX package's CLI
    seeds its numpy draw from the same sequence; the values differ)."""
    state = np.random.SeedSequence([_TRACE_ROOT, int(seed), int(idx)])
    g = torch.Generator(device=device)
    g.manual_seed(int(state.generate_state(1, np.uint64)[0] >> np.uint64(1)))
    table = torch.randn((rows, dim), generator=g, device=device)
    return table.div_(math.sqrt(dim))


def build_tenants(args) -> Tuple[MultiTenantRuntime, np.ndarray,
                                 np.ndarray, list]:
    """The ``--tenants`` runtime and its merged stream: ``(engine,
    queries, arrival times, tenant of each arrival)``.

    Each tenant of the spec (in name order) gets a `tenant_table` of its
    ``rows`` at the arch's ``d_model``, registered in a `TableRegistry`
    on ``--device`` under ``--table-budget-mb``, with a `TenantConfig`
    from the CLI's flags overridden by its spec and ``seed = --stream-seed
    + index``.  Each tenant arrives at ``rate_factor`` times the base
    rate on its own ``--pattern`` trace; the merge is sorted by time.
    Queries are N(0, 1) from ``default_rng(--stream-seed)`` with the last
    ``--repeat-rate`` of them repeating earlier ones, as in the JAX
    package's CLI.
    """
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    dim = cfg.d_model
    dev = resolve_device(args.device)
    spec = load_tenant_spec(args.tenants)
    obs = _observers(args)
    budget = (None if args.table_budget_mb is None
              else int(args.table_budget_mb * 2**20))
    registry = TableRegistry(byte_budget=budget, lanes=args.batch,
                             flight=obs["flight"], device=dev)
    rates = {}
    for idx, (name, s) in enumerate(sorted(spec.items())):
        s = dict(s)
        rows = int(s.pop("rows"))
        rates[name] = float(s.pop("rate_factor", 1.0))
        defaults = dict(K=args.topk, eps=args.eps, delta=args.delta,
                        eps_floor=args.eps_floor,
                        degrade_rungs=args.degrade_rungs,
                        precision=args.precision, pull_mode=args.pull_mode,
                        pq_subdims=args.pq_subdims, adaptive=args.adaptive,
                        bound=args.bound, cache_entries=args.cache_entries,
                        deadline_ms=args.request_deadline_ms,
                        queue_capacity=args.queue_capacity,
                        seed=args.stream_seed + idx)
        defaults.update(s)
        registry.register(name, tenant_table(rows, dim, args.stream_seed,
                                             idx, dev),
                          TenantConfig(**defaults))
    engine = MultiTenantRuntime(
        registry, batch_wait_ms=args.deadline_ms,
        max_retries=args.max_retries, fault_injector=_injector(args),
        recall_sample_rate=args.recall_rate, seed=args.stream_seed, **obs)
    names = sorted(spec)
    total_rate = sum(rates.values())
    times, labels = [], []
    for idx, name in enumerate(names):
        tr = arrival_trace(max(1, int(round(args.requests * rates[name]
                                            / total_rate))),
                           interarrival_ms=args.interarrival_ms / rates[name],
                           pattern=args.pattern,
                           seed=args.stream_seed + 1000 * (idx + 1))
        times.append(tr)
        labels.extend([name] * len(tr))
    times = np.concatenate(times)
    order = np.argsort(times, kind="stable")
    trace = times[order]
    labels = [labels[int(j)] for j in order]
    qrng = np.random.default_rng(args.stream_seed)
    qs = qrng.normal(size=(len(trace), dim)).astype(np.float32)
    if args.repeat_rate > 0:
        n_dup = int(len(trace) * args.repeat_rate)
        if n_dup:
            idxs = qrng.integers(0, max(1, len(trace) - n_dup), n_dup)
            qs[len(trace) - n_dup:] = qs[idxs]
    return engine, qs, trace, labels


def serve_tenants(args, engine: MultiTenantRuntime, qs, trace, labels,
                  churn=None) -> dict:
    """Serve the merged stream open loop through ``engine``, with the
    artifacts the flags name and a final flight-recorder snapshot;
    ``churn(engine, i)`` (optional) runs before each arrival."""
    stats = simulate_stream(
        engine, qs, interarrival_ms=args.interarrival_ms, churn=churn,
        pattern=args.pattern, seed=args.stream_seed, open_loop=True,
        tenants=lambda i: labels[i], trace=trace,
        metrics_out=args.metrics_out, trace_out=args.trace_out)
    if engine.flight is not None:
        dumped = engine.flight.dump("end_of_run", stats["virtual_s"])
        if dumped:
            stats.setdefault("artifacts", {})["flight"] = dumped
    return stats


def run_tenants(args) -> dict:
    """``--tenants``: build the registry and runtime, warm every tenant,
    serve the merged stream and print the stats as JSON (with
    ``--check-outcomes``, exit non-zero unless the runtime held its
    serving contract)."""
    engine, qs, trace, labels = build_tenants(args)
    reg = engine.registry
    budget = reg.byte_budget
    print(f"[serve] tenants: {len(reg.tenants())} tables "
          f"dim={qs.shape[1]} "
          f"device={reg.device} "
          f"budget={'none' if budget is None else f'{budget}B'} "
          f"lanes={args.batch} pattern={args.pattern} "
          f"requests={len(trace)} "
          f"faults={'on' if engine.injector else 'off'} "
          f"warmup={engine.warmup():.3f}s", flush=True)
    stats = serve_tenants(args, engine, qs, trace, labels)
    print(json.dumps(stats, indent=2))
    if args.check_outcomes:
        check_outcomes(args, stats)
    return stats


def decode_config(args) -> ArchConfig:
    """The decode demo's config: ``--arch`` (``--smoke`` reduced) with the
    head's ``--mips``, ``--eps``, ``--delta`` and ``--precision``."""
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    return dataclasses.replace(cfg, mips_mode=args.mips, mips_eps=args.eps,
                               mips_delta=args.delta,
                               mips_precision=args.precision)


def demo_inputs(cfg: ArchConfig, B: int, P: int, device
                ) -> Tuple[torch.Tensor, dict]:
    """The decode demo's prefill inputs, drawn from ``default_rng(0)`` in
    the JAX package's demo order: ``B`` prompts of ``P`` tokens, then the
    vlm family's ``patch_embeds (B, n_patches, d)`` and the encdec
    family's ``enc_frames (B, encoder_seq, d)`` in f32 -> ``(prompt,
    prefill keywords)`` on ``device``."""
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (B, P)))
    kw = {}
    if cfg.family == "vlm":
        kw["patch_embeds"] = rng.normal(size=(B, cfg.n_patches, cfg.d_model))
    if cfg.family == "encdec":
        kw["enc_frames"] = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model))
    return prompt.to(device), {
        k: torch.from_numpy(v.astype(np.float32)).to(device)
        for k, v in kw.items()}


def run_decode_demo(args, *, cfg: Optional[ArchConfig] = None,
                    model: Optional[LM] = None,
                    perm_of: Optional[Callable[[int, int], object]] = None
                    ) -> dict:
    """The default mode: batched prefill, then greedy decode.

    ``--batch`` prompts of ``--prompt-len`` tokens and the family's other
    prefill inputs (`demo_inputs`, as in the JAX package's demo) fill a
    cache of ``prompt_len + tokens``; the first decode step feeds each prompt's
    last token again at position ``prompt_len``, as the JAX demo does,
    and each step feeds the token the last one chose.  Decode step ``i``
    of a boundedme head draws its block permutation ``seeded_perm(0, i,
    n_blocks)``, or ``perm_of(i, n_blocks)`` when given (tests pass the
    JAX package's).  ``cfg`` (default `decode_config`) and ``model``
    (default `build_model` of ``cfg`` from seed 0 on ``--device``) may be
    passed in.

    Prints the head's plan and kernel path, the timings and the first
    sequence, and returns ``{"tokens": (B, tokens) int32 array,
    "prefill_ms", "decode_ms", "ms_per_token", "cfg", "model"}``.
    """
    dev = resolve_device(args.device)
    if cfg is None:
        cfg = decode_config(args)
    if model is None:
        model = build_model(cfg, seed=0, device=dev)
    if cfg.mips_mode == "boundedme":
        # the whole bandit of a decode step is one fused-cascade launch
        # over the head's tiled table, built here once; surface the static
        # plan, so the (eps, delta) <-> pull-count trade is visible
        plan = mips_head(model, cfg).plan
        flat = flatten_schedule(plan.schedule, final_coverage=True)
        tier = plan.precision
        if tier == "fp32" and cfg.dtype == "bfloat16":
            tier = "bf16"
        path = (f"CUDA fused_cascade_batched[{tier}], one launch per "
                f"decode step" if dev.type == "cuda"
                else "plain PyTorch version of the cascade (--device cpu)")
        print(f"[serve] fused cascade: rounds={len(plan.schedule.rounds)} "
              f"grid_steps={flat.n_steps} precision={plan.precision} "
              f"pull_speedup={plan.schedule.speedup:.2f}x path={path}",
              flush=True)
        n_blocks = plan.n_blocks
    sync = ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
            else (lambda: None))
    B, P = args.batch, args.prompt_len
    prompt, kw = demo_inputs(cfg, B, P, dev)
    t0 = time.perf_counter()
    _, caches = prefill_step(model, prompt, cache_len=P + args.tokens, **kw)
    sync()
    t_prefill = time.perf_counter() - t0
    tok = prompt[:, -1:]
    out = []
    t0 = time.perf_counter()
    for i in range(args.tokens):
        perm = None
        if cfg.mips_mode == "boundedme":
            perm = (perm_of(i, n_blocks) if perm_of is not None
                    else seeded_perm(0, i, n_blocks))
        nxt, caches = decode_step(model, cfg, caches, tok, P + i, perm=perm)
        out.append(nxt)
        tok = nxt[:, None]
    sync()
    t_decode = time.perf_counter() - t0
    gen = torch.stack(out, dim=1).cpu().numpy()
    per_tok = t_decode / max(1, args.tokens)
    print(f"[serve] arch={cfg.name} mips={cfg.mips_mode} eps={cfg.mips_eps} "
          f"batch={B} device={dev}")
    print(f"[serve] prefill {P} toks: {t_prefill * 1e3:.1f} ms; decode "
          f"{args.tokens} toks: {t_decode * 1e3:.1f} ms "
          f"({per_tok * 1e3:.2f} ms/tok)")
    print(f"[serve] first sequences: {gen[0][:16].tolist()}", flush=True)
    return {"tokens": gen, "prefill_ms": t_prefill * 1e3,
            "decode_ms": t_decode * 1e3, "ms_per_token": per_tok * 1e3,
            "cfg": cfg, "model": model}


def _validate_args(ap: argparse.ArgumentParser, args) -> None:
    """Refuse what the port does not serve, and bad values, up front."""
    if args.arch not in REGISTRY:
        ap.error(f"unknown --arch {args.arch!r}; have {sorted(REGISTRY)}")
    if not args.loop:
        if args.precision == "pq":
            ap.error("--precision pq requires --loop: pq plans need a "
                     "measured quantization-error bound calibrated on the "
                     "served table, which the serving engines perform at "
                     "build time; the decode demo's plan has no table to "
                     "calibrate on")
        for flag, on in (("--runtime", args.runtime),
                         ("--dynamic", args.dynamic),
                         ("--metrics-out", args.metrics_out)):
            if on:
                ap.error(f"{flag} requires --loop: it serves the request "
                         f"stream, not the decode demo")
        if args.prompt_len < 1 or args.tokens < 1:
            ap.error(f"--prompt-len and --tokens must be >= 1, got "
                     f"{args.prompt_len} and {args.tokens}")
        cfg = get_config(args.arch)
        if args.smoke:
            cfg = cfg.smoke()
        if cfg.family == "vlm" and args.prompt_len < cfg.n_patches:
            ap.error(f"--prompt-len {args.prompt_len} is shorter than the "
                     f"{cfg.n_patches} patch embeddings (n_patches) that "
                     f"{cfg.name} puts before the text: use --prompt-len "
                     f">= {cfg.n_patches}")
    if args.tenants is not None:
        if not args.loop:
            ap.error("--tenants requires --loop: the multi-tenant "
                     "registry serves the request stream, not the "
                     "decode demo")
        if args.runtime:
            ap.error("--tenants is its own runtime mode; drop --runtime "
                     "(the MultiTenantRuntime is always continuous-"
                     "batching)")
        if args.dynamic or args.shards > 1:
            ap.error("--tenants builds its own stores per tenant; drop "
                     "--dynamic/--shards (per-tenant precision and "
                     "placement live in the spec file)")
    if args.table_budget_mb is not None:
        if args.tenants is None:
            ap.error("--table-budget-mb requires --tenants: the byte "
                     "budget governs the multi-tenant table registry")
        if args.table_budget_mb <= 0:
            ap.error(f"--table-budget-mb must be > 0, got "
                     f"{args.table_budget_mb}")
    runtimes = args.runtime or args.tenants is not None
    if args.churn_rate > 0 and not args.dynamic:
        ap.error(f"--churn-rate {args.churn_rate} requires --dynamic: "
                 f"churn mutates a DynamicTableStore, but without "
                 f"--dynamic the table is a static array (add --dynamic, "
                 f"or drop --churn-rate)")
    if not 0.0 <= args.churn_rate <= 1.0:
        ap.error(f"--churn-rate must be in [0, 1], got {args.churn_rate}")
    if args.deadline_ms <= 0:
        ap.error(f"--deadline-ms must be > 0, got {args.deadline_ms}: it "
                 f"is the batch-assembly wait; 0 would flush a "
                 f"single-request batch at every poll (for per-request "
                 f"completion deadlines use --request-deadline-ms)")
    if args.eps_floor is not None:
        if not runtimes:
            ap.error("--eps-floor requires --runtime or --tenants: the "
                     "degradation ladder lives in the continuous-"
                     "batching runtimes (add --runtime, or drop "
                     "--eps-floor)")
        if args.eps_floor < args.eps:
            ap.error(f"--eps-floor {args.eps_floor} must be >= --eps "
                     f"{args.eps}: overload *relaxes* eps toward the "
                     f"floor (a floor tighter than the contract would "
                     f"mean degrading improves accuracy)")
    for name, val in (("--inject-latency-rate", args.inject_latency_rate),
                      ("--inject-error-rate", args.inject_error_rate),
                      ("--inject-flush-rate", args.inject_flush_rate)):
        if not 0.0 <= val <= 1.0:
            ap.error(f"{name} must be in [0, 1], got {val}")
        if val > 0 and not runtimes:
            ap.error(f"{name} requires --runtime or --tenants: fault "
                     f"injection is wired through the runtimes' "
                     f"retry/quarantine machinery (add --runtime)")
    if args.inject_flush_rate > 0 and not (args.dynamic or args.tenants):
        ap.error("--inject-flush-rate requires --dynamic or --tenants: "
                 "flush faults fire inside a store's flush_updates, and "
                 "without either there is no store")
    if args.queue_capacity < 1:
        ap.error(f"--queue-capacity must be >= 1, "
                 f"got {args.queue_capacity}")
    if args.request_deadline_ms <= 0:
        ap.error(f"--request-deadline-ms must be > 0, got "
                 f"{args.request_deadline_ms} (per-request completion "
                 f"budget; requests older than it are shed)")
    if args.max_retries < 0:
        ap.error(f"--max-retries must be >= 0, got {args.max_retries}")
    if (args.pull_mode != "row" and args.dynamic
            and args.precision != "fp32" and args.shards <= 1):
        ap.error(f"--pull-mode {args.pull_mode} is incompatible with a "
                 f"single-device quantized store (--dynamic --precision "
                 f"{args.precision}): the store's incrementally maintained "
                 f"{args.precision} shadow fixes the quantization-block "
                 f"geometry, which only the 'row' plan matches (use "
                 f"--pull-mode row, fp32, or --shards 2+)")
    if args.trace_out and not runtimes:
        ap.error("--trace-out requires --runtime or --tenants: span "
                 "tracing hooks live in the continuous-batching "
                 "runtimes")
    if args.flight_recorder_path and not runtimes:
        ap.error("--flight-recorder-path requires --runtime or "
                 "--tenants: the flight recorder records runtime "
                 "lifecycle events")
    if args.flight_capacity < 1:
        ap.error(f"--flight-capacity must be >= 1, "
                 f"got {args.flight_capacity}")
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
    ap.add_argument("--mips", default="exact",
                    choices=["exact", "boundedme"],
                    help="the decode demo's head: the full vocab matvec "
                         "and argmax, or the BoundedME bandit")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
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
                    help="micro-batch size (--loop) / kernel lanes "
                         "(--runtime) / decode batch (demo)")
    ap.add_argument("--loop", action="store_true",
                    help="run the micro-batching MIPS request loop")
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--deadline-ms", type=float, default=2.0,
                    help="batch-assembly wait (micro-batch deadline)")
    ap.add_argument("--interarrival-ms", type=float, default=0.1)
    ap.add_argument("--topk", type=int, default=4)
    ap.add_argument("--shards", type=int, default=1,
                    help="row shards of the --loop table, one per card "
                         "(capped at the cards there are; one card "
                         "serves unsharded)")
    ap.add_argument("--cache-entries", type=int, default=512)
    ap.add_argument("--repeat-rate", type=float, default=0.1,
                    help="fraction of requests repeating an earlier query")
    ap.add_argument("--recall-rate", type=float, default=0.05)
    ap.add_argument("--dynamic", action="store_true",
                    help="serve from a mutable DynamicTableStore "
                         "(upserts/deletes without a rebuild)")
    ap.add_argument("--churn-rate", type=float, default=0.0,
                    help="fraction of arrivals that also mutate the "
                         "table (needs --dynamic)")
    ap.add_argument("--capacity-slack", type=float, default=1.5,
                    help="store capacity headroom factor (--dynamic)")
    # continuous-batching runtime mode
    ap.add_argument("--runtime", action="store_true",
                    help="serve with the continuous-batching runtime "
                         "(admission control, priority classes, eps "
                         "degradation ladder, typed refusals)")
    ap.add_argument("--queue-capacity", type=int, default=64,
                    help="bounded admission queue depth (--runtime)")
    ap.add_argument("--eps-floor", type=float, default=None,
                    help="worst eps the degradation ladder may serve "
                         "under overload (>= --eps; default: no "
                         "degradation)")
    ap.add_argument("--degrade-rungs", type=int, default=3,
                    help="eps rungs (one executor each) between --eps and "
                         "--eps-floor")
    ap.add_argument("--request-deadline-ms", type=float, default=50.0,
                    help="per-request completion budget (--runtime); "
                         "requests queued past it are shed, not served "
                         "late")
    ap.add_argument("--max-retries", type=int, default=2,
                    help="dispatch retry budget before a micro-batch is "
                         "failed (--runtime)")
    ap.add_argument("--pattern", default="uniform",
                    choices=["uniform", "poisson", "bursty"],
                    help="arrival pattern of the simulated stream")
    ap.add_argument("--stream-seed", type=int, default=0,
                    help="seed of the arrival trace and of the engine's "
                         "block permutations")
    ap.add_argument("--inject-latency-rate", type=float, default=0.0,
                    help="fault injection: per-dispatch latency-spike "
                         "probability (--runtime)")
    ap.add_argument("--inject-error-rate", type=float, default=0.0,
                    help="fault injection: per-dispatch exception "
                         "probability (--runtime)")
    ap.add_argument("--inject-flush-rate", type=float, default=0.0,
                    help="fault injection: store flush failure "
                         "probability (--runtime --dynamic)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the deterministic fault schedule")
    ap.add_argument("--check-outcomes", action="store_true",
                    help="after the stream, fail unless every request "
                         "got a typed status from the closed set and "
                         "p99 stayed inside 8x the request deadline "
                         "(--runtime)")
    # observability artifacts
    ap.add_argument("--metrics-out", default=None,
                    help="write the metrics-registry snapshot here after "
                         "the stream (.prom/.txt = Prometheus text, "
                         "anything else = JSON)")
    ap.add_argument("--trace-out", default=None,
                    help="write per-request span traces here as Chrome "
                         "trace-event JSON — load in Perfetto / "
                         "chrome://tracing (--runtime)")
    ap.add_argument("--flight-recorder-path", default=None,
                    help="arm the crash flight recorder: a bounded ring "
                         "of structured serving events dumped here on "
                         "request failure, plus a final end-of-run "
                         "snapshot (--runtime)")
    ap.add_argument("--flight-capacity", type=int, default=256,
                    help="flight-recorder ring size in events")
    # multi-tenant mode
    ap.add_argument("--tenants", default=None, metavar="SPEC.json",
                    help="serve a multi-tenant registry instead of one "
                         "table: JSON mapping tenant name -> spec "
                         "({'rows': n, 'rate_factor': r, plus any "
                         "TenantConfig field}); drives one merged "
                         "arrival trace through the deficit-round-robin "
                         "MultiTenantRuntime (--loop)")
    ap.add_argument("--table-budget-mb", type=float, default=None,
                    help="device-memory budget for resident tenant "
                         "tables (MB); cold tables are paged out LRU "
                         "(--tenants; default: unbounded)")
    return ap


def parse_args(argv: Optional[list] = None):
    """Parse and validate serve CLI arguments."""
    ap = _build_parser()
    args = ap.parse_args(argv)
    _validate_args(ap, args)
    return args


def main(argv: Optional[list] = None) -> None:
    """CLI entry point: ``--loop`` for the request loop (``--tenants``:
    the multi-tenant runtime), default for the decode demo."""
    args = parse_args(argv)
    if args.tenants is not None:
        run_tenants(args)
    elif args.loop:
        run_loop(args)
    else:
        run_decode_demo(args)


if __name__ == "__main__":
    main()
