"""The port's runtime policy copies against the JAX package's originals.

Each module of ``repro_torch`` below is a copy of a pure-numpy module of
``repro`` (the port imports nothing of the JAX package); both get the
same seeded inputs and must give equal outputs, exactly:

* `AdmissionController` and `DegradationLadder`: equal verdicts (status,
  reason, class, latency), displacements, batch order, expiries,
  quarantine and ``stats()`` on the same seeded admit/take sequence;
  `DeficitRoundRobin` equal allowances;
* `FaultInjector`: the same schedule (spikes, failing attempts, error
  text) and ``stats()`` for several seeds; its store-flush hook fails the
  same flush indices with the same error text;
* `SpanTracer` and `FlightRecorder`: byte-equal JSON for the same events;
* `dispatch_lane_stats`: equal output on the same schedules and rounds;
* the obs package's exports and the no-op registry.
"""

import json

import numpy as np
import pytest

from repro.core.schedule import make_schedule as jax_make_schedule
from repro.distributed.sharding import \
    dispatch_lane_stats as jax_lane_stats
from repro.launch import admission as jadm
from repro.launch import faults as jfaults
from repro import obs as jobs
from repro_torch import obs as tobs
from repro_torch.core.schedule import make_schedule
from repro_torch.distributed.sharding import dispatch_lane_stats
from repro_torch.launch import admission as tadm
from repro_torch.launch import faults as tfaults

DIM = 12


def _classes(mod):
    return {
        "interactive": mod.PriorityClass("interactive", priority=0,
                                         deadline_ms=4.0, sheddable=False),
        "default": mod.PriorityClass("default", priority=1, deadline_ms=4.0),
        "batch": mod.PriorityClass("batch", priority=2, deadline_ms=16.0),
    }


def _result_tuple(res):
    return (res.status, res.reason, res.cls, res.latency_s, res.retries,
            res.cached, res.eps_served, res.delta_served)


def _admission_trace(mod, seed):
    """A seeded admit/take/quarantine sequence; returns every verdict."""
    rng = np.random.default_rng(seed)
    ac = mod.AdmissionController(DIM, queue_capacity=5,
                                 classes=_classes(mod),
                                 quarantine_capacity=3)
    names = ("interactive", "default", "batch")
    log = []
    t = 0.0
    for rid in range(120):
        t += float(rng.exponential(4e-4))
        kind = rng.random()
        if kind < 0.08:                         # poison of three kinds
            q = [np.full(DIM, np.nan), np.full(DIM, np.inf),
                 np.ones(DIM + 1)][rid % 3]
        elif kind < 0.12:
            q = "not a query"
        else:
            q = rng.normal(size=DIM)
        arr, reason = ac.validate(q)
        log.append(("validate", reason))
        if arr is None:
            ac.count_poison()
            continue
        cls = ac.resolve_class(names[int(rng.integers(0, 3))])
        tk = mod.Ticket(rid, arr, cls, t, t + cls.deadline_s, None,
                        ac.fingerprint(arr))
        verdict, displaced = ac.admit(tk)
        log.append(("admit", None if verdict is None
                    else _result_tuple(verdict),
                    [(v.req_id, _result_tuple(r)) for v, r in displaced]))
        if rng.random() < 0.05:
            ac.add_quarantine(tk.fingerprint, "dispatch failure")
            again = mod.Ticket(rid, arr, cls, t, t + cls.deadline_s, None,
                               ac.fingerprint(arr))
            log.append(("requarantined", _result_tuple(ac.admit(again)[0])))
        if rng.random() < 0.4:
            batch, expired = ac.take(t, int(rng.integers(1, 5)),
                                     expire=bool(rng.random() < 0.8))
            log.append(("take", [tk.req_id for tk in batch],
                        [(tk.req_id, _result_tuple(r))
                         for tk, r in expired]))
        log.append(("depth", ac.depth, ac.oldest_submit(), ac.load()))
    log.append(("stats", ac.stats()))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_admission_controller_matches_jax_package(seed):
    want = _admission_trace(jadm, seed)
    got = _admission_trace(tadm, seed)
    assert got == want
    stats = got[-1][1]
    assert stats["overloaded"] + stats["displaced"] > 0
    assert stats["rejected_poison"] > 0 and stats["expired_deadline"] > 0
    assert list(stats) == list(want[-1][1])


def test_admission_refusals_match_jax_package():
    for mod in (jadm, tadm):
        with pytest.raises(ValueError, match="queue_capacity"):
            mod.AdmissionController(DIM, queue_capacity=0)
        with pytest.raises(KeyError, match="unknown priority class"):
            mod.AdmissionController(DIM).resolve_class("gold")
    assert tadm.STATUSES == jadm.STATUSES
    assert tadm.__all__ == jadm.__all__


@pytest.mark.parametrize("eps,floor,rungs,start", [
    (0.1, 0.4, 3, 0.5), (0.2, 0.8, 4, 0.25), (0.3, 0.3, 3, 0.5),
    (0.1, None, 3, 0.5), (0.05, 3.2, 1, 1.0), (0.1, 0.9, 5, 0.75)])
def test_degradation_ladder_matches_jax_package(eps, floor, rungs, start):
    jl = jadm.DegradationLadder(eps, floor, rungs=rungs, start=start)
    tl = tadm.DegradationLadder(eps, floor, rungs=rungs, start=start)
    assert tl.eps_values == jl.eps_values and tl.n_rungs == jl.n_rungs
    assert (tl.eps, tl.eps_floor, tl.start) == (jl.eps, jl.eps_floor,
                                                jl.start)
    for load in np.linspace(0.0, 1.5, 61):
        assert tl.rung(float(load)) == jl.rung(float(load))
    for mod in (jadm, tadm):
        with pytest.raises(ValueError, match="eps_floor"):
            mod.DegradationLadder(0.5, 0.1)
        with pytest.raises(ValueError, match="start"):
            mod.DegradationLadder(0.1, 0.4, start=0.0)


def _drr_trace(mod, seed):
    rng = np.random.default_rng(seed)
    drr = mod.DeficitRoundRobin(4.0, cap_rounds=2.0)
    for name, w in (("a", 1.0), ("b", 2.0), ("c", 0.5)):
        drr.add_flow(name, w)
    log = []
    for _ in range(40):
        backlog = {f: bool(rng.random() < 0.7) for f in drr.flows()}
        drr.start_round(backlog)
        for f in drr.flows():
            allow = drr.allowance(f)
            drr.consume(f, float(rng.integers(0, allow + 1)))
            if not backlog[f]:
                drr.reset(f)
            log.append((f, allow, drr.allowance(f)))
        drr.rotate()
        if rng.random() < 0.1:
            drr.add_flow("a", float(rng.integers(1, 4)))
    drr.remove_flow("b")
    log.append(drr.flows())
    return log


@pytest.mark.parametrize("seed", [0, 5])
def test_deficit_round_robin_matches_jax_package(seed):
    assert _drr_trace(tadm, seed) == _drr_trace(jadm, seed)


def _fault_trace(mod, seed, **kw):
    inj = mod.FaultInjector(seed, **kw)
    log = []
    for d in range(300):
        for attempt in range(4):
            e = inj.dispatch_error(d, attempt)
            log.append(None if e is None else (type(e).__name__, str(e)))
        log.append((inj.fail_attempts(d), inj.latency_s(d)))
    log.append(inj.stats())
    log.append((inj.n_latency_injected, inj.injected_latency_s,
                inj.n_errors_injected, inj.n_persistent_errors))
    return log, inj


@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
@pytest.mark.parametrize("rates", [
    dict(latency_rate=0.05, error_rate=0.05),
    dict(latency_rate=0.3, latency_ms=2.0, error_rate=0.3,
         persistent_rate=0.5),
    dict(error_rate=1.0, persistent_rate=0.0)])
def test_fault_injector_schedule_matches_jax_package(seed, rates):
    want, jinj = _fault_trace(jfaults, seed, **rates)
    got, tinj = _fault_trace(tfaults, seed, **rates)
    assert got == want
    assert (tinj.metrics.snapshot() == jinj.metrics.snapshot())


def test_fault_injector_refuses_the_store_surface():
    for kw in (dict(latency_rate=1.5), dict(error_rate=-0.1),
               dict(flush_failure_rate=2.0)):
        for mod in (jfaults, tfaults):
            with pytest.raises(ValueError, match="must be in"):
                mod.FaultInjector(0, **kw)
    assert issubclass(tfaults.InjectedDispatchError, RuntimeError)
    # the store surface, once refused, is ported: `attach` installs the
    # flush hook, whose stateless per-flush draws fail the JAX
    # injector's flush indices with the same text
    from repro_torch.store import StoreFlushError
    for seed, rate in ((0, 0.2), (3, 0.5), (9, 0.0)):
        logs, injs = [], []
        for mod in (jfaults, tfaults):
            inj = mod.FaultInjector(seed, flush_failure_rate=rate)
            store = type("Store", (), {"fault_hook": None})()
            inj.attach(store)
            log = []
            for _ in range(120):
                try:
                    store.fault_hook()
                    log.append(None)
                except RuntimeError as e:
                    log.append((type(e).__name__, str(e)))
                    if mod is tfaults:
                        assert isinstance(e, StoreFlushError)
            logs.append(log)
            injs.append(inj)
        assert logs[1] == logs[0]
        assert injs[1].stats() == injs[0].stats()
        assert injs[1].metrics.snapshot() == injs[0].metrics.snapshot()
        assert injs[1].n_flush_failures == sum(x is not None
                                               for x in logs[1])
        assert (injs[1].n_flush_failures > 0) == (rate > 0)


def _trace_events(mod, seed, max_requests):
    tr = mod.SpanTracer(max_requests=max_requests, max_global_events=16,
                        seed=seed)
    rng = np.random.default_rng(seed)
    t = 0.0
    for rid in range(60):
        t += float(rng.exponential(1e-3))
        tr.request_begin(rid, t, priority_class=["a", "b"][rid % 2])
        tr.instant(rid, "admitted", t, depth=rid % 5)
        tr.span(rid, "queued", t, t + 2e-4, didx=rid // 4)
        if rid % 7:
            tr.request_end(rid, t + 5e-4, "ok", reason="")
        tr.global_span(f"dispatch {rid}", t, t + 3e-4, rung=rid % 3,
                       eps_served=0.1 * (1 + rid % 3))
    return tr


@pytest.mark.parametrize("seed,max_requests", [(0, 512), (3, 8), (9, 1)])
def test_span_tracer_json_byte_equal(seed, max_requests, tmp_path):
    jt = _trace_events(jobs, seed, max_requests)
    tt = _trace_events(tobs, seed, max_requests)
    assert json.dumps(tt.export()) == json.dumps(jt.export())
    jt.write(tmp_path / "j.json")
    tt.write(tmp_path / "t.json")
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    assert (tt.n_seen, tt.n_dropped) == (jt.n_seen, jt.n_dropped)


@pytest.mark.parametrize("capacity", [4, 256])
def test_flight_recorder_dump_byte_equal(capacity, tmp_path):
    paths = []
    for name, mod in (("j", jobs), ("t", tobs)):
        fr = mod.FlightRecorder(capacity=capacity,
                                path=str(tmp_path / f"{name}.json"))
        for i in range(20):
            fr.record("admitted", i * 1e-3, rid=i, depth=i % 3)
            if i % 6 == 5:
                fr.record("fault_dispatch_error", None, didx=i,
                          injected=True, error="boom")
                fr.dump("request_failed", i * 1e-3)
        assert fr.dump("end_of_run", 1.0) == str(tmp_path / f"{name}.json")
        assert mod.FlightRecorder(capacity=2).dump("x") is None
        paths.append(tmp_path / f"{name}.json")
    assert paths[1].read_bytes() == paths[0].read_bytes()
    assert json.loads(paths[1].read_text())["n_dumps"] == 4


@pytest.mark.parametrize("n,N,K,eps,bound", [
    (600, 128, 4, 0.3, "hoeffding"), (2048, 512, 2, 0.05, "bernstein"),
    (64, 32, 1, 0.5, "hoeffding")])
def test_dispatch_lane_stats_matches_jax_package(n, N, K, eps, bound):
    kw = dict(K=K, eps=eps, delta=0.1, value_range=1.0, bound=bound)
    sched = make_schedule(n // 8, N // 32, **kw)
    jsched = jax_make_schedule(n // 8, N // 32, **kw)
    rng = np.random.default_rng(n)
    n_rounds = len(sched.rounds)
    for lanes, filled in ((4, 4), (8, 3), (4, 0), (2, 5)):
        for rounds in (None, rng.integers(0, n_rounds + 2, lanes),
                       rng.integers(0, n_rounds + 1, (lanes, 3))):
            got = dispatch_lane_stats(rounds, schedule=sched, lanes=lanes,
                                      filled=filled)
            want = jax_lane_stats(rounds, schedule=jsched, lanes=lanes,
                                  filled=filled)
            assert got == want


def test_obs_package_exports_match_jax_package():
    assert tobs.__all__ == jobs.__all__
    for name in tobs.__all__:
        assert hasattr(tobs, name)
    reg, jreg = tobs.null_registry(), jobs.null_registry()
    for r in (reg, jreg):
        c = r.counter("x_total", "help", ("k",))
        c.inc(3, k="a")
        r.histogram("h_ms").observe(2.0)
        r.adopt(tobs.MetricsRegistry())
    assert reg.snapshot() == jreg.snapshot() == {"metrics": []}
    assert reg.counter("y").total() == 0.0 and reg.gauge("g").get() == 0.0
