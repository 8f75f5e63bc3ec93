"""The per-layer readers of the program's spans on synthetic readings and
synthetic span stats: each reads its cell's spans, and returns None
without them, in the other cell, or on a program that has no spans."""

from __future__ import annotations

import pytest

from portbench import counts, harness

SERVE = {"kind": "serve", "trace": None, "answered": 0, "dispatches": 0}
DECODE = {"kind": "decode", "trace": None, "traced_steps": 16,
          "window_s": 0.0}


def _agg(count, host_s, self_s=None, device_s=None, **counters):
    return {"count": count, "host_s": host_s,
            "self_s": host_s if self_s is None else self_s,
            "device_s": device_s, "counters": counters}


SERVE_SPANS = {
    "engine.submit": _agg(64, 0.004, 0.003),
    "engine.submit.cache": _agg(64, 0.001),
    "engine.poll": _agg(100, 0.030, 0.002),
    "engine.flush": _agg(4, 0.027, 0.001),
    "engine.flush.pack": _agg(4, 0.0005),
    "engine.flush.file": _agg(4, 0.0015),
    "engine.result": _agg(64, 0.0002),
    "executor.dispatch": _agg(4, 0.024, 0.002),
    "executor.sync": _agg(4, 0.018),
    "executor.d2h": _agg(4, 0.001),
}
SDPA = _agg(160, 1.9, 1.9, device_s=1.84, kv_bytes=349_000_000_000)


def _read(name, reading):
    mod = harness.load_module(harness.reader_path(name),
                              "test_reader_" + name.replace(".", "_"))
    return mod.read(reading)


@pytest.fixture
def spans(monkeypatch):
    """Point the program's ``span_stats`` at a dict the test fills."""
    from repro_torch.obs import trace
    table = {}
    monkeypatch.setattr(trace, "span_stats", lambda: dict(table))
    return table


def test_serving_readers(spans):
    spans.update(SERVE_SPANS)
    assert _read("dispatch_host_ms", SERVE) == pytest.approx(
        1e3 * (0.024 - 0.018) / 4)
    own = 0.003 + 0.001 + 0.002 + 0.001 + 0.0005 + 0.0015 + 0.0002
    assert _read("engine_self_ms", SERVE) == pytest.approx(1e3 * own / 64)
    assert _read("decode_sdpa_ms", SERVE) is None
    assert _read("sdpa_roofline_pct.decode", SERVE) is None


def test_decode_readers(spans):
    spans.update({"layer.attention.sdpa": SDPA,
                  "decode_step": _agg(16, 2.2)})
    assert _read("decode_sdpa_ms", DECODE) == pytest.approx(1e3 * 1.84 / 16)
    least = 349_000_000_000 / counts.H100_SXM["hbm_bytes_per_s"]
    assert _read("sdpa_roofline_pct.decode", DECODE) == pytest.approx(
        100 * least / 1.84)
    assert _read("dispatch_host_ms", DECODE) is None
    assert _read("engine_self_ms", DECODE) is None
    assert _read("decode_sdpa_ms", dict(DECODE, traced_steps=0)) is None


@pytest.mark.parametrize("name,reading", [
    ("dispatch_host_ms", SERVE), ("engine_self_ms", SERVE),
    ("decode_sdpa_ms", DECODE), ("sdpa_roofline_pct.decode", DECODE)])
def test_readers_without_spans(spans, monkeypatch, name, reading):
    """Nothing recorded (a CPU run, an untraced run), spans without device
    time, and a program without ``span_stats`` (the parent of the PR
    that added it): None, never an error."""
    assert _read(name, reading) is None
    spans["layer.attention.sdpa"] = dict(SDPA, device_s=None)
    spans["engine.submit"] = SERVE_SPANS["engine.submit"]
    assert _read(name, reading) is None
    from repro_torch.obs import trace
    monkeypatch.delattr(trace, "span_stats")
    spans.update(SERVE_SPANS, **{"layer.attention.sdpa": SDPA})
    assert _read(name, reading) is None


def test_traced_serving_line_reports_the_span_metrics(spans):
    spans.update(SERVE_SPANS)
    cell = harness.find_cell("serve-closed32")
    summary = {"window_s": 1.0, "busy_s": 0.5, "ops": [],
               "device_ops": [], "idle_gaps": []}
    outcome = {"attempted": 1, "failed": 0, "trace": summary,
               "checks": {"score_err": {"value": 0.0, "limit": 1.0}},
               "reading": dict(SERVE, trace=summary)}
    dev = {"platform": "gpu", "kind": "x", "count": 1,
           "memory_peak_bytes": 0}
    line = harness.finish(cell, outcome, 1.0, True, dev)
    assert set(line["metrics"]) == {"idle_pct.serve", "dispatch_host_ms",
                                    "engine_self_ms"}
