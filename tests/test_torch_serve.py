"""The port's serving path against the JAX package's, and its boundaries.

* `MIPSServeEngine` parity: with ``perm_source`` handing the port the
  JAX engine's own permutations (``jax.random.permutation(fold_in(
  PRNGKey(seed), batch_seq), n_blocks)``), both engines serve the same
  query stream on the same virtual clock to equal ids, allclose scores
  (rtol 1e-5, atol 1e-6 * max|score|: fp32 sums in another order) and
  equal batch, occupancy and cache counters.
* `serving_table_from_jax` carries the JAX package's serve table over.
* The port and ``chip_smoke.py`` import neither jax nor ``repro``.
* Without CUDA and without ``device="cpu"`` the entry points raise, and
  the options of later slices are refused.
"""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.engine import MIPSServeEngine as JaxEngine
from repro.models.model import init_params
from repro_torch.configs import get_config
from repro_torch.convert import make_serving_table, serving_table_from_jax
from repro_torch.core.boundedme_torch import bounded_me_decode, make_plan
from repro_torch.launch import serve
from repro_torch.launch.engine import (CascadeExecutor, MIPSServeEngine,
                                       seeded_perm)

ROOT = Path(__file__).resolve().parents[1]


def _table(n=600, N=128, seed=0):
    rng = np.random.default_rng(seed)
    return (0.02 * rng.normal(size=(n, N))).astype(np.float32)


def _stream(n_req=30, N=128, seed=1):
    rng = np.random.default_rng(seed)
    qs = rng.normal(size=(n_req, N)).astype(np.float32)
    qs[-5:] = qs[:5]                         # cacheable repeats
    return qs


def _drive(engine, qs):
    """Same trigger sequence for every engine: the clock is not advanced
    by measured compute time, only by the arrival schedule."""
    for i, q in enumerate(qs):
        engine.submit(q, now=i * 7e-4)
        engine.poll(now=i * 7e-4)
    engine.drain(now=len(qs) * 7e-4)
    return [engine.result(r) for r in range(len(qs))]


@pytest.mark.parametrize("mode", ["row", "coord"])
def test_engine_matches_jax_engine(mode):
    table = _table()
    qs = _stream()
    common = dict(K=4, eps=0.3, delta=0.1, block=32, batch_size=4,
                  deadline_ms=2.0, n_valid=590, pull_mode=mode,
                  coord_block=16, seed=3)
    jeng = JaxEngine(table, use_pallas=False, **common)
    n_blocks = jeng.plan.n_blocks
    root = jax.random.PRNGKey(3)
    teng = MIPSServeEngine(
        table, device="cpu",
        perm_source=lambda s: np.array(jax.random.permutation(
            jax.random.fold_in(root, s), n_blocks)), **common)
    jres, tres = _drive(jeng, qs), _drive(teng, qs)
    for (jids, jsc), (tids, tsc) in zip(jres, tres):
        np.testing.assert_array_equal(tids, jids)
        np.testing.assert_allclose(tsc, jsc, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(jsc).max()))
    js, ts = jeng.stats(), teng.stats()
    for key in ("requests", "completed", "pending", "batches",
                "full_flushes", "deadline_flushes", "mean_batch_occupancy",
                "cache", "plan"):
        assert ts[key] == js[key], key
    assert ts["cache"]["hits"] == 5


def test_engine_own_permutations_are_seeded():
    table, qs = _table(), _stream()
    runs = []
    for _ in range(2):
        eng = MIPSServeEngine(table, K=4, eps=0.3, block=32, batch_size=4,
                              seed=11, device="cpu")
        runs.append(_drive(eng, qs))
    for (a, sa), (b, sb) in zip(*runs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(sa, sb)
    p = seeded_perm(11, 5, 16).numpy()
    assert sorted(p.tolist()) == list(range(16))
    assert not np.array_equal(p, seeded_perm(11, 6, 16).numpy())


def test_serving_table_from_jax_init_params():
    jcfg = jax_get_config("qwen1.5-0.5b").smoke()
    cfg = get_config("qwen1.5-0.5b").smoke()
    assert dataclasses.astuple(cfg) == dataclasses.astuple(jcfg)
    assert cfg.padded_vocab == jcfg.padded_vocab
    params = init_params(jcfg, jax.random.PRNGKey(0))
    want = np.asarray(params["embed"], np.float32)
    table, n_valid = serving_table_from_jax(
        {k: np.asarray(v) for k, v in params.items()
         if k in ("embed", "unembed")}, cfg)
    assert table.dtype == torch.float32
    np.testing.assert_array_equal(table.numpy(), want)
    assert n_valid == jcfg.vocab            # the JAX serve loop's n_valid
    full = get_config("qwen1.5-0.5b")
    assert (full.padded_vocab, full.vocab, full.d_model) == (
        153600, 151936, 1024)


def test_make_serving_table_shape_and_scale():
    cfg = get_config("qwen1.5-0.5b").smoke()
    table, n_valid = make_serving_table(cfg, seed=4, device="cpu")
    again, _ = make_serving_table(cfg, seed=4, device="cpu")
    assert table.shape == (cfg.padded_vocab, cfg.d_model)
    assert n_valid == cfg.vocab
    assert torch.equal(table, again)
    assert abs(float(table.std()) - 0.02) < 2e-3


def test_serve_cli_loop_on_cpu():
    args = serve.parse_args(["--arch", "qwen1.5-0.5b", "--smoke", "--loop",
                             "--device", "cpu", "--requests", "24",
                             "--recall-rate", "1.0"])
    stats = serve.run_loop(args)
    assert stats["completed"] == 24 and stats["pending"] == 0
    assert stats["recall"]["samples"] > 0
    assert stats["recall"]["mean"] >= 0.75
    assert stats["batches"] * 4 >= 24 - stats["cache"]["hits"]


@pytest.mark.parametrize("argv", [
    ["--runtime"], ["--dynamic"], ["--tenants", "t.json"], ["--shards", "2"],
    ["--precision", "int8"], ["--adaptive"]])
def test_serve_cli_refuses_later_slices(argv, capsys):
    with pytest.raises(SystemExit):
        serve.parse_args(["--arch", "qwen1.5-0.5b", "--loop", *argv])
    assert "ROADMAP.md" in capsys.readouterr().err


def test_serve_cli_refuses_decode_demo(capsys):
    with pytest.raises(SystemExit):
        serve.parse_args(["--arch", "qwen1.5-0.5b"])
    assert "model zoo" in capsys.readouterr().err


def test_executor_refuses_later_slices():
    table = _table(64, 32)
    for kw in (dict(mesh=object()), dict(precision="int8"),
               dict(adaptive=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            CascadeExecutor(table, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        CascadeExecutor({"rows": table}, device="cpu")


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    table = _table(64, 32)
    plan = make_plan(64, 32, K=2, value_range=1.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bounded_me_decode(table, table[:2], np.arange(plan.n_blocks),
                          plan=plan)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CascadeExecutor(table)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MIPSServeEngine(table)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "qwen1.5-0.5b", "--smoke", "--loop",
                    "--requests", "4"])


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_no_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, mod)
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "spec = importlib.util.spec_from_file_location("
        "'chip_smoke', 'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
