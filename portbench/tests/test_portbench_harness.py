"""The harness on the CPU: its arguments, its refusal without a card, the
result line's schema, discovery by name, the contract of
``BENCHMARK.json`` and what the benchmark's modules import."""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import harness

ROOT = harness.ROOT
PKG = harness.PKG
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_arguments():
    a = harness.parse_args(["--workload", "w", "--seed", str(2 ** 40 + 3),
                            "--seconds", "10", "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace) == ("w", 2 ** 40 + 3,
                                                        10.0, 1)
    assert harness.parse_args(["--workload", "w", "--seed", "1",
                               "--seconds", "2"]).trace == 0
    for bad in (["--workload", "w", "--seed", "1", "--seconds", "0"],
                ["--workload", "w", "--seed", "1", "--seconds", "1",
                 "--trace", "2"],
                ["--seed", "1", "--seconds", "1"]):
        with pytest.raises(SystemExit):
            harness.parse_args(bad)


def test_refuses_without_a_card(capsys):
    """No CUDA device here: a code other than 0 and no result line."""
    import torch
    assert not torch.cuda.is_available()
    rc = harness.main(["--workload", "serve-closed32", "--seed",
                       str(2 ** 33), "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out.strip() == ""


def test_result_line_schema():
    cell = harness.find_cell("serve-closed32")
    outcome = {"metrics": {"serve_p95_ms": 9.5, "serve_qps": 3000.0},
               "attempted": 30000, "failed": 0,
               "checks": {"score_err": {"value": 1e-7, "limit": 1e-5},
                          "top1_err": {"value": 2e-7, "limit": 1e-5}},
               "reading": {"kind": "serve", "trace": None}}
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
              "count": 1, "memory_peak_bytes": 1}
    line = harness.finish(cell, outcome, 21.5, False, device)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True
    assert set(line["metrics"]) == {"serve_p95_ms", "serve_qps", "setup_s"}
    assert line["metrics"]["setup_s"] == {"value": 21.5, "unit": "s"}
    json.loads(json.dumps(line))
    outcome["checks"]["top1_err"]["value"] = 1.0
    assert harness.finish(cell, outcome, 1.0, False, device)["correct"] \
        is False
    # traced: only the per-layer metrics that find something to read
    summary = {"window_s": 1.0, "busy_s": 0.75, "ops": [],
               "device_ops": [["k", 0.75]], "idle_gaps": [["x", 0.1]]}
    outcome["reading"] = {"kind": "serve", "trace": summary,
                          "answered": 0, "dispatches": 0}
    outcome["trace"] = summary
    line = harness.finish(cell, outcome, 1.0, True, device)
    assert line["metrics"] == {"idle_pct.serve": {"value": 25.0,
                                                  "unit": "%"}}
    assert list(line)[-2:] == ["breakdown", "checks"]


def test_forbidden_modules_by_whole_top_level_name():
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.core", "jaxtyping", "reprox", "torch",
         "repro", "repro.core", "jax", "jax.numpy", "jaxlib.xla", "flax"]) \
        == ["flax", "jax", "jax.numpy", "jaxlib.xla", "repro", "repro.core"]


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            top = mod.split(".", 1)[0]
            assert top not in harness.FORBIDDEN, (f, mod)
    for mod in _imports(PKG / "reference.py"):
        assert mod.split(".", 1)[0] not in ("repro_torch", "portbench"), mod


def test_benchmark_json_keeps_the_contract():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"][1] == "portbench/run.py"
    assert 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
        assert (PKG / "traffic" / f"{w['traffic']}.json").is_file()
        assert (PKG / "limits" / f"{w['name']}.json").is_file()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e and harness.reader_path(m["name"]).is_file()
        for cell in m["workloads"]:
            # each cell a metric lists reports the metric it moves
            assert harness._applies(e2e[m["moves"]], cell)
    for w in b["workloads"]:
        reported = [m for m in b["end_to_end"]
                    if harness._applies(m, w["name"])]
        assert len(reported) >= 2
        assert any(harness._applies(m, w["name"]) for m in b["per_layer"])


def _tree_hashes(root: Path):
    return {p.relative_to(root): hashlib.sha1(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_new_cell_needs_only_new_files(tmp_path):
    """A configuration, a traffic mix, a kind of entry, a per-layer
    metric and a cell, added as files and entries: the harness finds
    them, runs the cell and reads the metric; no file that was there
    changes and the old cells are found as before."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _tree_hashes(tmp_path / "portbench")
    pkg = tmp_path / "portbench"
    (pkg / "configs" / "tiny.json").write_text('{"rows": 3}')
    (pkg / "traffic" / "once.json").write_text('{"driver": "echo"}')
    (pkg / "limits" / "tiny-once.json").write_text(
        '{"same": {"limit": 0}}')
    (pkg / "drivers" / "echo.py").write_text(
        "def run(run, control=False):\n"
        "    n = run.cell.config['rows']\n"
        "    return {'metrics': {'rows_s': n / run.seconds},\n"
        "            'attempted': n, 'failed': 0, 'window_start': 0.0,\n"
        "            'checks': {'same': {'value': 0, 'limit': 0}},\n"
        "            'memory_peak_bytes': 0, 'reading': {'rows': n}}\n")
    (pkg / "metrics" / "rows_seen.py").write_text(
        "def read(r):\n    return r.get('rows')\n")
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "tiny", "source": "https://example.org",
                         "file": "portbench/configs/tiny.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "tiny-once", "config": "tiny",
                           "traffic": "once", "chips": 1, "why": "a test"})
    b["end_to_end"].append({"name": "rows_s", "unit": "rows/s",
                            "better": "higher", "bound": 0.05,
                            "source": "host_clock",
                            "workloads": ["tiny-once"]})
    b["per_layer"].append({"name": "rows_seen", "unit": "rows",
                           "better": "higher", "source": "program_counter",
                           "layer": "test", "moves": "rows_s",
                           "workloads": ["tiny-once"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    after = _tree_hashes(pkg)
    assert all(after[k] == v for k, v in before.items())

    cell = harness.find_cell("tiny-once", root=tmp_path)
    assert cell.config == {"rows": 3} and cell.driver.name == "echo.py"
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "rows_s"]
    assert [m["name"] for m in cell.per_layer] == ["rows_seen"]
    driver = harness.load_module(cell.driver, "echo_driver")
    out = driver.run(harness.Run(cell=cell, seed=1, seconds=2.0,
                                 trace=False, device="cpu"))
    dev = {"platform": "gpu", "kind": "x", "count": 1,
           "memory_peak_bytes": 0}
    line = harness.finish(cell, out, 0.5, False, dev, root=tmp_path)
    assert line["metrics"]["rows_s"]["value"] == 1.5 and line["correct"]
    line = harness.finish(cell, out, 0.5, True, dev, root=tmp_path)
    assert line["metrics"] == {"rows_seen": {"value": 3.0, "unit": "rows"}}
    old = harness.find_cell("serve-closed32", root=tmp_path)
    new = harness.find_cell("serve-closed32")
    assert old.driver.name == new.driver.name
    assert dataclasses.replace(old, driver=None) == \
        dataclasses.replace(new, driver=None)
