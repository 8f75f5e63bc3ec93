"""The port's continuous-batching `ServeRuntime` against the JAX package's.

Both runtimes serve the same traffic on the same virtual clock: every
rung executor's ``dispatch`` is wrapped, in both, to report a fixed
``DT`` in place of its measured seconds (the measured time differs
between the packages and would move rungs, expiry and refill), and the
port's ``perm_source`` hands it the reference's own permutations,
``jax.random.permutation(fold_in(PRNGKey(seed), didx), n_blocks)``.
The reference runs ``use_pallas=False``.  Traffic covers poison (NaN,
Inf, wrong width), overload (queue full and displacement), deadline
expiry, cache hits, and transient and persistent injected faults (retry
and quarantine).  Held equal: each request's status, reason, class,
eps/delta served, latency, retries, cache flag and ids; every counter of
``stats()`` with its key order; the metrics registry (but the measured
``cascade_dispatch_ms``); the span tracer's export and the flight
recorder's events.

Scores: the served scores are the exact fp32 rescore of the candidates
on every tier, summed in another order by each package, so they agree
to rtol 1e-5 and atol 1e-6 * max|score| on every tier; on the int8 and
int4 tiers the ids are held equal all the same, since each pull is an
exact integer dot.

A statistical cell holds each rung to its own contract: with the rung
forced, the served answers meet that rung's ``eps_served`` at an
empirical rate >= 1 - delta less the three-sigma binomial slack of
``tests/test_guarantees.py``.  The CLI's runtime flags are validated as
the JAX package's, and ``--smoke --loop --runtime --device cpu`` runs
end to end with its artifacts checked by ``tools/check_obs_artifacts.py``.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.launch import serve as jserve
from repro.launch.admission import PriorityClass as JaxClass
from repro.launch.engine import ServeRuntime as JaxRuntime
from repro.launch.faults import FaultInjector as JaxInjector
from repro.obs import FlightRecorder as JaxFlight
from repro.obs import SpanTracer as JaxTracer
from repro_torch.distributed.sharding import Mesh
from repro_torch.launch import serve
from repro_torch.launch.admission import STATUSES, PriorityClass
from repro_torch.launch.engine import (DispatchFailed, ServeRuntime,
                                       dispatch_with_retries)
from repro_torch.launch.faults import FaultInjector, InjectedDispatchError
from repro_torch.obs import FlightRecorder, SpanTracer

ROOT = Path(__file__).resolve().parents[1]
DT = 6e-4                       # the fixed dispatch seconds of both
N_ROWS, DIM, SEED = 600, 128, 3


def _table(seed=0):
    rng = np.random.default_rng(seed)
    return (0.02 * rng.normal(size=(N_ROWS, DIM))).astype(np.float32)


def _queries(n, seed=1):
    return np.random.default_rng(seed).normal(
        size=(n, DIM)).astype(np.float32)


def _classes(cls):
    return {"interactive": cls("interactive", priority=0, deadline_ms=6.0,
                               sheddable=False),
            "default": cls("default", priority=1, deadline_ms=6.0),
            "batch": cls("batch", priority=2, deadline_ms=24.0)}


def _fix_dt(executors):
    for ex in executors:
        real = ex.dispatch

        def dispatch(Qbuf, perm, real=real):
            ids, scores, rounds, _ = real(Qbuf, perm)
            return ids, scores, rounds, DT
        ex.dispatch = dispatch


def _jax_perm(didx, n_blocks):
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), didx)
    return np.array(jax.random.permutation(key, n_blocks))


def _pair(precision="fp32", adaptive=False, bound="hoeffding",
          pull_mode="row", **over):
    """The reference and the port runtime on one table, fixed DT each."""
    common = dict(K=4, eps=0.3, delta=0.1, eps_floor=1.2, degrade_rungs=3,
                  lanes=4, batch_wait_ms=1.0, queue_capacity=6,
                  max_retries=1, retry_backoff_ms=0.5,
                  dispatch_timeout_ms=1.0, cache_entries=8,
                  recall_sample_rate=0.5, block=32, coord_block=16,
                  n_valid=590, precision=precision, adaptive=adaptive,
                  bound=bound, pull_mode=pull_mode, pq_subdims=4,
                  quant_err=2e-5 if precision == "pq" else None, seed=SEED)
    common.update(over)
    inj = dict(latency_rate=0.3, latency_ms=2.0, error_rate=0.3,
               persistent_rate=0.5)
    jrt = JaxRuntime(_table(), use_pallas=False, classes=_classes(JaxClass),
                     fault_injector=JaxInjector(7, **inj),
                     tracer=JaxTracer(max_requests=64, seed=0),
                     flight=JaxFlight(capacity=64), **common)
    trt = ServeRuntime(_table(), classes=_classes(PriorityClass),
                       fault_injector=FaultInjector(7, **inj),
                       tracer=SpanTracer(max_requests=64, seed=0),
                       flight=FlightRecorder(capacity=64),
                       perm_source=_jax_perm, device="cpu", **common)
    _fix_dt(jrt._rung_execs)
    _fix_dt(trt.executors)
    return jrt, trt


def _scripted(rt, qs) -> int:
    """Poison, steady traffic, displacement, cache hits, expiry and
    resubmission of quarantined queries; returns the request count."""
    rt.warmup()
    rt.submit(np.full(DIM, np.nan, np.float32), now=0.0)
    rt.submit(np.full(DIM, np.inf, np.float32), now=0.0)
    rt.submit(np.ones(DIM + 2, np.float32), now=0.0)
    names = ("default", "batch", "interactive")
    t = 0.0
    for i in range(24):
        rt.submit(qs[i], now=t, cls=names[i % 3])
        rt.poll(now=t + 4e-4)
        t += 5e-4
    for i in range(24, 31):                 # a full queue of batch work
        rt.submit(qs[i], now=t, cls="batch")
    rt.submit(qs[31], now=t, cls="interactive")       # displaces one
    rt.drain(now=t + 1e-3)
    t += 1.0
    for i in range(6):                      # idle: cache hits and repeats
        rt.submit(qs[i], now=t)
        rt.poll(now=t + 2e-3)
        t += 5e-3
    for lo in (36, 44, 52):                 # bursts: overload, rung 2
        t += 1.0
        for i in range(lo, lo + 8):
            rt.submit(qs[i], now=t)
        rt.poll(now=t)
        rt.drain(now=t + 1e-3)
    t += 1.0
    for i in range(32, 36):                 # expire at the next poll
        rt.submit(qs[i], now=t, cls="batch")
    rt.poll(now=t + 10.0)
    rt.drain(now=t + 10.0)
    t += 20.0
    for i in range(36):                     # quarantined ones refused
        rt.submit(qs[i], now=t, cls="default")
        rt.poll(now=t + 2e-3)
        t += 3e-3
    rt.drain(now=t + 1.0)
    return rt.n_requests


def _keys(obj):
    if isinstance(obj, dict):
        return [(k, _keys(v)) for k, v in obj.items()]
    return None


def _same(a, b):
    """Equal, NaN equal to NaN."""
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, float) and np.isnan(a):
        return isinstance(b, float) and np.isnan(b)
    return a == b


def _hold(jrt, trt, n):
    statuses = set()
    for rid in range(n):
        j, t = jrt.result(rid), trt.result(rid)
        assert j is not None and t is not None, rid
        assert (t.status, t.reason, t.cls, t.eps_served, t.delta_served,
                t.latency_s, t.retries, t.cached) == (
            j.status, j.reason, j.cls, j.eps_served, j.delta_served,
            j.latency_s, j.retries, j.cached), rid
        statuses.add(t.status)
        if j.answered:
            np.testing.assert_array_equal(t.ids, np.asarray(j.ids))
            np.testing.assert_allclose(
                t.scores, j.scores, rtol=1e-5,
                atol=1e-6 * float(np.abs(j.scores).max()))
    js, ts = jrt.stats(), trt.stats()
    assert _keys(ts) == _keys(js)
    assert _same(ts, js)
    jm, tm = jrt.metrics.snapshot(), trt.metrics.snapshot()
    assert [m["name"] for m in tm["metrics"]] == \
        [m["name"] for m in jm["metrics"]]
    for a, b in zip(tm["metrics"], jm["metrics"]):
        if a["name"] != "cascade_dispatch_ms":     # measured seconds
            assert a == b, a["name"]
    assert json.dumps(trt.tracer.export()) == json.dumps(jrt.tracer.export())
    assert trt.flight.events() == jrt.flight.events()
    return statuses, ts


# (precision, adaptive, bound, pull_mode)
TIERS = [("fp32", False, "hoeffding", "row"),
         ("int8", False, "hoeffding", "coord"),
         ("int4", False, "hoeffding", "row"),
         ("pq", False, "hoeffding", "row"),
         ("int8", True, "bernstein", "row"),
         ("fp32", True, "hoeffding", "hybrid")]


@pytest.mark.parametrize("precision,adaptive,bound,mode", TIERS)
def test_runtime_matches_jax_runtime(precision, adaptive, bound, mode):
    jrt, trt = _pair(precision, adaptive, bound, mode)
    qs = _queries(60)
    n = _scripted(jrt, qs)
    assert _scripted(trt, qs) == n
    statuses, st = _hold(jrt, trt, n)
    assert statuses == set(STATUSES)
    q = st["queue"]
    assert q["rejected_poison"] == 3 and q["rejected_quarantined"] > 0
    assert q["displaced"] > 0 and q["expired_deadline"] > 0
    assert st["cache"]["hits"] > 0 and st["faults"]["retries"] > 0
    assert st["faults"]["failed_batches"] > 0
    assert st["faults"]["slow_dispatches"] > 0
    assert all(st["degradation"]["served_per_rung"])
    # warm-up dispatches are counted by the executors, not the runtime
    assert sum(ex.n_dispatches for ex in trt.executors) == \
        len(trt.executors) + st["dispatches"] - st["faults"][
            "failed_batches"]


@pytest.mark.parametrize("precision,adaptive,bound,mode",
                         [TIERS[0], TIERS[4]])
def test_open_loop_stream_matches_jax_runtime(precision, adaptive, bound,
                                              mode):
    """`simulate_stream` open loop over a bursty trace with classes."""
    jrt, trt = _pair(precision, adaptive, bound, mode)
    qs = list(_queries(90))
    qs[7] = np.full(DIM, np.nan, np.float32)
    names = ("interactive", "default", "default", "batch")
    picks = np.random.default_rng(1).integers(0, 4, len(qs))
    kw = dict(interarrival_ms=0.2, pattern="bursty", seed=2,
              open_loop=True, classes=lambda i: names[picks[i]])
    for rt in (jrt, trt):
        rt.warmup()
    jst = jserve.simulate_stream(jrt, qs, **kw)
    tst = serve.simulate_stream(trt, qs, **kw)
    assert _keys(tst) == _keys(jst) and _same(tst, jst)
    statuses, _ = _hold(jrt, trt, len(qs))
    assert {"ok", "degraded", "rejected", "overloaded"} <= statuses


@pytest.mark.parametrize("pattern", ["uniform", "bursty"])
def test_closed_loop_stream_matches_jax_engine(pattern):
    """The micro-batching engine's closed loop is the JAX package's."""
    from repro.launch.engine import MIPSServeEngine as JaxEngine
    from repro_torch.launch.engine import MIPSServeEngine
    common = dict(K=4, eps=0.3, delta=0.1, block=32, batch_size=4,
                  deadline_ms=1.0, n_valid=590, seed=SEED, cache_entries=8)
    jeng = JaxEngine(_table(), use_pallas=False, **common)
    teng = MIPSServeEngine(_table(), device="cpu", perm_source=lambda s:
                           _jax_perm(s, jeng.plan.n_blocks), **common)
    _fix_dt([jeng._exec])
    _fix_dt([teng.executor])
    qs = _queries(40)
    qs[32:] = qs[24:32]
    kw = dict(interarrival_ms=0.1, pattern=pattern, seed=4)
    jst = jserve.simulate_stream(jeng, qs, **kw)
    tst = serve.simulate_stream(teng, qs, **kw)
    for key in ("virtual_s", "throughput_rps", "trace", "requests",
                "completed", "batches", "full_flushes", "deadline_flushes",
                "mean_batch_occupancy", "cache", "latency_ms"):
        assert _same(tst[key], jst[key]), key
    assert tst["cache"]["hits"] > 0 and tst["full_flushes"] > 0


def test_runtime_rungs_take_their_own_plans():
    """Under 'hybrid' each rung resolves its own pull mode, and each
    dispatch's permutation spans the chosen rung's own blocks."""
    seen = []

    def perm_source(didx, n_blocks):
        seen.append(n_blocks)
        return np.random.default_rng(didx).permutation(n_blocks)
    rt = ServeRuntime(_table(), K=4, eps=0.05, eps_floor=2.0,
                      degrade_rungs=3, lanes=4, block=32, coord_block=8,
                      pull_mode="hybrid", queue_capacity=4,
                      perm_source=perm_source, device="cpu")
    blocks = [ex.plan.n_blocks for ex in rt.executors]
    assert len(set(blocks)) > 1, blocks
    qs = _queries(12)
    for i in range(12):
        rt.submit(qs[i], now=0.0)
    rt.drain(now=0.0)
    assert set(seen) <= set(blocks) and len(seen) == rt.n_dispatches


def test_dispatch_with_retries_reuses_the_perm():
    """A dispatch's retries reuse its permutation; past the budget the
    last cause surfaces in `DispatchFailed`."""
    class Ex:
        def __init__(self, fails):
            self.fails, self.perms = fails, []

        def dispatch(self, Qbuf, perm):
            self.perms.append(perm)
            if len(self.perms) <= self.fails:
                raise RuntimeError(f"real fault {len(self.perms)}")
            return np.zeros((1, 1)), np.zeros((1, 1)), None, 0.5

    perm = np.arange(4)
    ex = Ex(fails=2)
    out = dispatch_with_retries(ex, None, perm, didx=0, max_retries=2,
                                retry_backoff_s=1e-3)
    assert out[3:] == (0.5 + 3e-3, 2, 3e-3, 0.0)
    assert all(p is perm for p in ex.perms) and len(ex.perms) == 3
    with pytest.raises(DispatchFailed) as info:
        dispatch_with_retries(Ex(fails=5), None, perm, didx=0,
                              max_retries=1)
    assert info.value.retries == 1 and "real fault 2" in str(info.value)
    inj = FaultInjector(0, error_rate=1.0, persistent_rate=1.0)
    with pytest.raises(DispatchFailed) as info:
        dispatch_with_retries(Ex(fails=0), None, perm, didx=3,
                              injector=inj, max_retries=2)
    assert isinstance(info.value.cause, InjectedDispatchError)


def test_runtime_refuses_what_is_not_ported():
    with pytest.raises(TypeError, match="DynamicTableStore"):
        ServeRuntime({"rows": _table()}, device="cpu")
    # a mesh (refused before sharded serving was ported) shards every rung
    mesh = Mesh(["cpu"] * 2)
    sharded = ServeRuntime(_table(), K=2, lanes=2, mesh=mesh, device="cpu")
    assert all(ex.mesh is mesh for ex in sharded.executors)
    for kw, match in ((dict(batch_wait_ms=0), "batch_wait_ms"),
                      (dict(lanes=0), "lanes"),
                      (dict(max_retries=-1), "max_retries")):
        with pytest.raises(ValueError, match=match):
            ServeRuntime(_table(), device="cpu", **kw)
    rt = ServeRuntime(_table(), K=2, lanes=2, device="cpu")
    assert rt.apply_updates(0.0) == 0


# ---- the (eps, delta) contract per rung ------------------------------------

# tests/test_guarantees.py's geometry: 128 arms, 128 blocks, the last
# round samples a strict subset of the blocks (asserted below)
G_ARMS, G_DIM, G_BLOCK, G_K = 128, 8192, 64, 2
G_EPS, G_FLOOR, G_DELTA, G_VRANGE, G_TRIALS = 1.6, 6.4, 0.2, 8.0, 200


def _margin(delta, trials):
    """Three-sigma binomial slack on an empirical rate at ``delta``."""
    return 3.0 * np.sqrt(delta * (1.0 - delta) / trials)


@pytest.mark.parametrize("rung", [0, 1, 2])
def test_each_rung_meets_its_eps_served(rung):
    rng = np.random.default_rng(0)
    V = rng.normal(size=(G_ARMS, G_DIM)).astype(np.float32)
    Q = rng.normal(size=(G_TRIALS, G_DIM)).astype(np.float32)
    rt = ServeRuntime(V, K=G_K, eps=G_EPS, delta=G_DELTA, eps_floor=G_FLOOR,
                      degrade_rungs=3, lanes=8, block=G_BLOCK,
                      value_range=G_VRANGE, queue_capacity=G_TRIALS,
                      cache_entries=0, device="cpu")
    rt.ladder.rung = lambda load: rung       # forced degradation
    plan = rt.executors[rung].plan
    assert plan.schedule.rounds[-1].t_cum < plan.n_blocks
    for q in Q:
        rt.submit(q, now=0.0)
    rt.drain(now=0.0)
    eps_r = rt.ladder.eps_values[rung]
    S = (V.astype(np.float64) @ Q.astype(np.float64).T).T / G_DIM
    viols = 0
    for b in range(G_TRIALS):
        res = rt.result(b)
        assert res.status == ("ok" if rung == 0 else "degraded")
        assert res.eps_served == eps_r and res.delta_served == G_DELTA
        true_top = np.sort(S[b])[::-1][:G_K]
        got = np.sort(S[b][res.ids])[::-1]
        viols += bool(np.any(true_top - got > eps_r + 1e-7))
    assert viols / G_TRIALS <= G_DELTA + _margin(G_DELTA, G_TRIALS)
    assert rt.stats()["degradation"]["served_per_rung"][rung] == G_TRIALS


# ---- the CLI ---------------------------------------------------------------

CLI_REFUSALS = [
    (["--deadline-ms", "0"], "--request-deadline-ms"),
    (["--runtime", "--eps", "0.3", "--eps-floor", "0.1"], "relax"),
    (["--eps-floor", "0.5"], "--runtime"),
    (["--inject-error-rate", "0.5"], "--runtime"),
    (["--inject-latency-rate", "0.5"], "--runtime"),
    (["--runtime", "--inject-error-rate", "1.5"], "[0, 1]"),
    (["--runtime", "--inject-flush-rate", "0.5"], "--dynamic"),
    (["--runtime", "--queue-capacity", "0"], "--queue-capacity"),
    (["--runtime", "--request-deadline-ms", "0"], "--request-deadline-ms"),
    (["--trace-out", "t.json"], "--runtime"),
    (["--flight-recorder-path", "f.json"], "--runtime"),
    (["--runtime", "--flight-capacity", "0"], "--flight-capacity")]


@pytest.mark.parametrize("argv,fragment", CLI_REFUSALS)
def test_cli_runtime_checks_match_jax_package(argv, fragment, capsys):
    full = ["--arch", "qwen1.5-0.5b", "--loop", *argv]
    with pytest.raises(SystemExit):
        serve.parse_args(full)
    assert fragment in capsys.readouterr().err
    ap = jserve._build_parser()
    args = ap.parse_args(full)
    with pytest.raises(SystemExit):
        jserve._validate_args(ap, args)
    assert fragment in capsys.readouterr().err


def test_cli_valid_runtime_combination_passes(capsys):
    argv = ["--arch", "qwen1.5-0.5b", "--loop", "--runtime",
            "--eps-floor", "0.5", "--degrade-rungs", "4",
            "--pattern", "bursty", "--inject-error-rate", "0.2",
            "--inject-latency-rate", "0.1", "--fault-seed", "3",
            "--max-retries", "0", "--queue-capacity", "8",
            "--request-deadline-ms", "5", "--trace-out", "t.json",
            "--flight-recorder-path", "f.json", "--flight-capacity", "8",
            "--check-outcomes"]
    args = serve.parse_args(argv)
    ap = jserve._build_parser()
    jserve._validate_args(ap, ap.parse_args(argv))
    assert (args.runtime, args.eps_floor, args.degrade_rungs,
            args.fault_seed) == (True, 0.5, 4, 3)
    with pytest.raises(SystemExit):
        serve.parse_args(argv[:3] + ["--runtime", "--max-retries", "-1"])
    assert "--max-retries" in capsys.readouterr().err


def test_cli_runtime_end_to_end_with_artifacts(tmp_path, capsys):
    paths = {k: tmp_path / f"{k}.{ext}" for k, ext in
             (("metrics", "prom"), ("trace", "json"), ("flight", "json"))}
    serve.main(["--arch", "qwen1.5-0.5b", "--smoke", "--loop", "--runtime",
                "--device", "cpu", "--requests", "48", "--eps-floor", "0.4",
                "--pattern", "bursty", "--queue-capacity", "8",
                "--inject-error-rate", "0.25", "--inject-latency-rate",
                "0.05", "--check-outcomes",
                "--metrics-out", str(paths["metrics"]),
                "--trace-out", str(paths["trace"]),
                "--flight-recorder-path", str(paths["flight"])])
    out = capsys.readouterr().out
    assert "[serve] runtime:" in out and "[check] OK" in out
    stats = json.loads(out[out.index("{"):out.index("[check]")])
    assert sum(stats["outcomes"].values()) == stats["requests"] == 48
    assert stats["trace"]["open_loop"] is True
    assert set(stats["artifacts"]) == {"metrics", "trace", "flight"}
    assert stats["faults"]["dispatch_errors"] == \
        stats["faults"]["injected"]["dispatch_errors"]
    run = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "check_obs_artifacts.py"),
         "--metrics", str(paths["metrics"]), "--trace", str(paths["trace"]),
         "--flight", str(paths["flight"])],
        capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr


@pytest.mark.parametrize("outcomes,requests,p99,message", [
    ({"ok": 3, "lost": 1}, 4, 1.0, "unknown outcome"),
    ({"ok": 3, "failed": 0}, 4, 1.0, "typed outcomes"),
    ({"ok": 4}, 4, 41.0, "exceeds 40ms")])
def test_check_outcomes_fails_the_run(outcomes, requests, p99, message):
    args = serve.parse_args(["--arch", "qwen1.5-0.5b", "--loop",
                             "--runtime", "--request-deadline-ms", "5"])
    stats = {"outcomes": outcomes, "requests": requests, "completed": 4,
             "latency_ms": {"p99": p99}}
    with pytest.raises(SystemExit, match=message):
        serve.check_outcomes(args, stats)


def _chip_smoke():
    """``chip_smoke.py`` as a module (it imports torch and numpy only at
    its top)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("label,tier", [
    ("fp32", ["--precision", "fp32"]),
    ("int8+adaptive", ["--precision", "int8", "--adaptive", "--bound",
                       "bernstein"])])
def test_phase5_fixed_service_time_counts(label, tier, monkeypatch):
    """``chip_smoke.py`` phase 5's pass 1 on the CPU: with every rung
    dispatch reporting the fixed ``RUNTIME_DT``, both of its tiers' streams
    give all five outcomes over two rungs or more, and the outcome
    counts, rungs launched and requests served per rung are the same at
    ``--smoke`` width and on a table twice as wide and tall (its
    queries repeating where the smoke stream's do): what the card's pass
    is held to does not depend on the table's size, nor on the host."""
    import dataclasses
    cs = _chip_smoke()
    assert cs.RUNTIME_DT == DT
    argv = cs.RUNTIME_ARGV + tier + ["--device", "cpu"]
    small = cs.runtime_fixed_pass(argv + ["--smoke"], label)
    fixed = small["fixed"]
    o = fixed["outcomes"]
    assert all(o[s] > 0 for s in ("ok", "degraded", "overloaded",
                                  "rejected", "failed")), o
    assert len(fixed["rungs_launched"]) >= 2
    assert sum(o.values()) == 256
    real = serve.get_config
    monkeypatch.setattr(serve, "get_config", lambda arch: (
        dataclasses.replace(real(arch).smoke(), d_model=256, vocab=1024)))
    wide = cs.runtime_fixed_pass(argv, label, like=small["queries"])
    assert np.shape(wide["queries"]) == (256, 256)
    assert wide["fixed"] == fixed
