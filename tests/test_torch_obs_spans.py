"""The port's host spans (`repro_torch.obs.trace.span`) on the CPU: off
with no profiler recording, on under one, with the expected names,
counts, nesting, counters and no device-side events, and the serving
engine's answers the same either way."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.core.boundedme_torch import (decode_tiled, draw_perms,
                                              make_plan, tile_table)
from repro_torch.launch.engine import MIPSServeEngine
from repro_torch.models.model import build_model
from repro_torch.models.steps import decode_step, prefill_step
from repro_torch.obs import trace

ENGINE_SPANS = {"engine.submit", "engine.submit.cache", "engine.poll",
                "engine.flush", "engine.flush.pack", "engine.flush.file",
                "engine.result", "executor.dispatch", "executor.sync",
                "executor.d2h", "cascade.queries", "cascade.perm",
                "cascade.launch", "cascade.rescale"}
#: each span's parent in one engine loop
PARENT = {"engine.submit.cache": "engine.submit",
          "engine.flush": "engine.poll",
          "engine.flush.pack": "engine.flush",
          "engine.flush.file": "engine.flush",
          "executor.dispatch": "engine.flush",
          "executor.sync": "executor.dispatch",
          "executor.d2h": "executor.dispatch",
          "cascade.queries": "executor.dispatch",
          "cascade.perm": "executor.dispatch",
          "cascade.launch": "executor.dispatch",
          "cascade.rescale": "executor.dispatch"}


@pytest.fixture(autouse=True)
def clean_spans():
    trace.reset_spans()
    yield
    trace.reset_spans()


def _table(n=300, N=256, seed=0):
    return np.random.default_rng(seed).normal(size=(n, N)).astype(
        np.float32)


def _engine(V, **kw):
    return MIPSServeEngine(V, K=3, batch_size=4, deadline_ms=1e6, block=64,
                           cache_entries=16, seed=3, device="cpu", **kw)


def _loop(eng, Q):
    """Submit each query, poll after each; the answers by request id."""
    out = {}
    for q in Q:
        eng.submit(q)
        done, _ = eng.poll()
        for rid in done:
            out[rid] = eng.result(rid)
    return out


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof, trace.span_stats()


def test_spans_record_nothing_without_a_profiler():
    V = _table()
    _loop(_engine(V), V[:8] + 0.01)
    assert trace.span_stats() == {}
    assert trace.span("a") is trace.span("b", device=torch.device("cpu"))
    with trace.span("a") as sp:
        assert not sp                              # a body may skip counts
        sp.count("bytes", 3)
    assert trace.span_stats() == {}


def test_engine_loop_spans_and_counts():
    V = _table()
    eng = _engine(V)
    _loop(eng, V[:4] + 0.01)                       # warm: one flush
    answers, prof, st = _traced(lambda: _loop(eng, V[4:16] + 0.01))
    assert set(st) == ENGINE_SPANS
    assert len(answers) == 12
    assert st["engine.submit"]["count"] == 12
    assert st["engine.submit.cache"]["count"] == 12
    assert st["engine.poll"]["count"] == 12
    assert st["engine.result"]["count"] == 12      # one per answer
    for name in ("engine.flush", "engine.flush.pack", "engine.flush.file",
                 "executor.dispatch", "executor.sync", "executor.d2h",
                 "cascade.queries", "cascade.perm", "cascade.launch",
                 "cascade.rescale"):
        assert st[name]["count"] == 3, name        # one per flush
    # a fresh seeded permutation each flush, read on the host each time
    assert st["cascade.perm"]["counters"] == {"host_reads": 3}
    assert st["executor.dispatch"]["counters"] == {}
    for name, a in st.items():
        assert a["device_s"] is None, name
        assert 0 <= a["self_s"] <= a["host_s"] + 1e-12, name


def test_span_on_a_cpu_device_records_no_device_time():
    def one():
        with trace.span("x", device=torch.device("cpu")) as sp:
            assert sp                              # on: counts are kept
            sp.count("n", 1)
    _, prof, st = _traced(one)
    assert st["x"] == {"count": 1, "host_s": st["x"]["host_s"],
                       "self_s": st["x"]["self_s"], "device_s": None,
                       "counters": {"n": 1}}
    assert trace._PENDING == []


def test_children_nest_and_self_time_is_total_less_children():
    V = _table()
    eng = _engine(V)
    _, prof, st = _traced(lambda: _loop(eng, V[:8] + 0.01))
    events = [e for e in prof.events() if e.name in ENGINE_SPANS]
    for e in events:
        if e.name in PARENT:
            assert e.cpu_parent is not None, e.name
            assert e.cpu_parent.name == PARENT[e.name], e.name
    # a parent's self time is its total less its children's totals
    kids = {}
    for child, parent in PARENT.items():
        kids.setdefault(parent, []).append(child)
    for parent, children in kids.items():
        want = st[parent]["host_s"] - sum(st[c]["host_s"] for c in children)
        assert st[parent]["self_s"] == pytest.approx(want, abs=1e-9)


def test_spans_are_host_events_never_device_events():
    V = _table()
    eng = _engine(V)
    _, prof, st = _traced(lambda: _loop(eng, V[:8] + 0.01))
    cpu = {e.name for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CPU}
    dev = {e.name for e in prof.events()
           if e.device_type != torch.autograd.DeviceType.CPU}
    assert set(st) <= cpu
    assert not set(st) & dev
    assert "cascade_kernel" not in " ".join(st)


def test_engine_answers_bitwise_with_spans_on_and_off():
    V = _table(seed=1)
    Q = V[:20] + 0.02
    off = _loop(_engine(V), Q)
    on, _, st = _traced(lambda: _loop(_engine(V), Q))
    assert st and off.keys() == on.keys()
    for rid in off:
        assert np.array_equal(off[rid][0], on[rid][0])
        assert np.array_equal(off[rid][1], on[rid][1])


def test_decode_tiled_spans_and_perm_reads():
    V = torch.from_numpy(_table())
    plan = make_plan(300, 256, K=2, eps=0.2, delta=0.1, value_range=30.0,
                     block=64)
    V4 = tile_table(V, plan, "cpu")
    Q = V[:5] + 0.01
    fresh = torch.randperm(plan.n_blocks)
    drawn = draw_perms(plan.n_blocks)
    _, _, st = _traced(lambda: (decode_tiled(V4, Q, fresh, plan=plan),
                                decode_tiled(V4, Q, drawn, plan=plan)))
    assert set(st) == {"cascade.queries", "cascade.perm", "cascade.launch",
                       "cascade.rescale"}
    assert all(a["count"] == 2 for a in st.values())
    # the fresh tensor is read once; a drawn one is known
    assert st["cascade.perm"]["counters"] == {"host_reads": 1}


def test_decode_step_spans_and_kv_bytes():
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").smoke(),
                              n_layers=2, mips_mode="boundedme")
    model = build_model(cfg, seed=0, device="cpu")
    B, S, steps = 2, 6, 3
    tok = torch.randint(0, cfg.vocab, (B, S))
    _, caches = prefill_step(model, tok, cache_len=S + steps)
    nxt = tok[:, -1]

    def run():
        nonlocal nxt, caches
        for j in range(steps):
            nxt, caches = decode_step(model, cfg, caches, nxt[:, None],
                                      S + j)
    _, prof, st = _traced(run)
    assert st["decode_step"]["count"] == steps
    assert st["decode_step.body"]["count"] == steps
    assert st["decode_step.head"]["count"] == steps
    assert st["layer.attention"]["count"] == steps * cfg.n_layers
    assert st["layer.mlp"]["count"] == steps * cfg.n_layers
    assert st["cascade.launch"]["count"] == steps
    sdpa = st["layer.attention.sdpa"]
    assert sdpa["count"] == steps * cfg.n_layers
    assert sdpa["device_s"] is None                # no card
    item = caches[0]["k"].element_size()
    want = sum(2 * B * (S + j + 1) * cfg.n_kv_heads * cfg.head_dim * item
               for j in range(steps)) * cfg.n_layers
    assert sdpa["counters"] == {"kv_bytes": want}
    e = next(e for e in prof.events() if e.name == "layer.attention.sdpa")
    assert e.cpu_parent.name == "layer.attention"
    e = next(e for e in prof.events() if e.name == "cascade.launch")
    assert e.cpu_parent.name == "decode_step.head"


def test_reset_spans_forgets_everything():
    def one():
        with trace.span("x") as sp:
            sp.count("n", 2)
    _, _, st = _traced(one)
    assert st["x"]["count"] == 1 and st["x"]["counters"] == {"n": 2}
    trace.reset_spans()
    assert trace.span_stats() == {}


def test_threads_lose_no_update_and_nest_per_thread():
    """Spans entered from many threads at once: every entry counted, and
    each thread's child time taken off its own parent only."""
    import sys
    import threading
    n_threads, n_spans = 12, 300

    def work():
        for _ in range(n_spans):
            with trace.span("outer"):
                with trace.span("inner") as sp:
                    sp.count("n", 1)

    def run():
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
        finally:
            sys.setswitchinterval(old)
    _, _, st = _traced(run)
    assert st["outer"]["count"] == st["inner"]["count"] == n_threads * n_spans
    assert st["inner"]["counters"] == {"n": n_threads * n_spans}
    assert st["outer"]["self_s"] == pytest.approx(
        st["outer"]["host_s"] - st["inner"]["host_s"], abs=1e-9)
