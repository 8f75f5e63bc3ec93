"""The port's serving path against the JAX package's, and its boundaries.

* `MIPSServeEngine` parity: with ``perm_source`` handing the port the
  JAX engine's own permutations (``jax.random.permutation(fold_in(
  PRNGKey(seed), batch_seq), n_blocks)``), both engines serve the same
  query stream on the same virtual clock to equal ids, allclose scores
  (rtol 1e-5, atol 1e-6 * max|score|: fp32 sums in another order) and
  equal batch, occupancy and cache counters.
* The same per tier — int8, int4, pq (each package trains its own
  codebook on the table, one quant_err for both) — and with adaptive
  early exit, whose ``stats()["adaptive"]`` (rounds histogram, mean pull
  fraction) must be equal too.
* `serving_table_from_jax` carries the JAX package's serve table over.
* The port and ``chip_smoke.py`` import neither jax nor ``repro``.
* Without CUDA and without ``device="cpu"`` the entry points raise (the
  decode demo and ``--tenants`` too), and the options of later slices
  are refused.
* ``--tenants`` / ``--table-budget-mb``: the argument checks give the
  JAX package's CLI's messages; ``--smoke --loop --tenants
  configs/tenants_smoke.json --device cpu --check-outcomes`` runs to its
  end with its artifacts valid (``tools/check_obs_artifacts.py
  --expect-tenants``), its ``stats()`` keys those of the JAX CLI's run;
  `simulate_stream` routes arrival ``i`` to ``tenants(i)``.
* The decode demo runs on the CPU at smoke size and refuses what it does
  not serve (`tests/test_torch_decode_demo.py` holds its tokens against
  the JAX package's).
"""

import ast
import dataclasses
import json
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
from repro_torch.distributed.sharding import Mesh
from repro_torch.launch.engine import (CascadeExecutor, MIPSServeEngine,
                                       seeded_perm)
from repro_torch.store import DynamicTableStore

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


# (precision, adaptive, bound, mode)
TIER_ENGINES = [("int8", False, "hoeffding", "row"),
                ("int4", False, "hoeffding", "coord"),
                ("pq", False, "hoeffding", "row"),
                ("int8", True, "bernstein", "row"),
                ("fp32", True, "hoeffding", "coord"),
                ("pq", True, "bernstein", "coord")]


@pytest.mark.parametrize("precision,adaptive,bound,mode", TIER_ENGINES)
def test_engine_tiers_match_jax_engine(precision, adaptive, bound, mode):
    table = _table()
    qs = _stream()
    common = dict(K=4, eps=0.3, delta=0.1, block=32, batch_size=4,
                  deadline_ms=2.0, n_valid=590, pull_mode=mode,
                  coord_block=16, seed=3, precision=precision,
                  adaptive=adaptive, bound=bound, pq_subdims=4,
                  quant_err=2e-5 if precision == "pq" else None)
    jeng = JaxEngine(table, use_pallas=False, **common)
    n_blocks = jeng.plan.n_blocks
    root = jax.random.PRNGKey(3)
    teng = MIPSServeEngine(
        table, device="cpu",
        perm_source=lambda s: np.array(jax.random.permutation(
            jax.random.fold_in(root, s), n_blocks)), **common)
    assert dataclasses.astuple(teng.plan) == dataclasses.astuple(jeng.plan)
    jres, tres = _drive(jeng, qs), _drive(teng, qs)
    for (jids, jsc), (tids, tsc) in zip(jres, tres):
        np.testing.assert_array_equal(tids, jids)
        np.testing.assert_allclose(tsc, jsc, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(jsc).max()))
    js, ts = jeng.stats(), teng.stats()
    for key in ("requests", "completed", "pending", "batches",
                "full_flushes", "deadline_flushes", "mean_batch_occupancy",
                "cache", "plan", "adaptive"):
        assert ts[key] == js[key], key
    if adaptive:
        assert ts["adaptive"]["samples"] == ts["requests"] - 5


def test_executor_quantizes_the_table_once():
    table = _table(64, 32)
    ex = CascadeExecutor(table, K=2, block=16, precision="int4",
                         device="cpu")
    Vq, vscale = ex.quantized
    assert Vq.dtype == torch.int8 and Vq.shape[-1] == 8
    before = [t.clone() for t in ex.quantized]
    ids, scores, rounds, dt = ex.dispatch(table[:3], np.arange(2))
    assert rounds is None and ids.shape == (3, 2) and dt > 0
    assert all(a is b for a, b in zip(ex.quantized, (Vq, vscale)))
    assert all(torch.equal(a, b) for a, b in zip(ex.quantized, before))
    pq = CascadeExecutor(table, K=2, block=16, precision="pq",
                         pq_subdims=4, pull_mode="hybrid", device="cpu")
    assert pq.plan.quant_err > 0 and pq.quantized[1].shape[-1] == 4
    ada = CascadeExecutor(table, K=2, block=16, adaptive=True, device="cpu")
    assert ada.dispatch(table[:3], np.arange(2))[2].shape == (3,)
    assert CascadeExecutor(table, device="cpu").quantized is None


@pytest.mark.parametrize("argv", [
    ["--precision", "int8"], ["--precision", "int4", "--pull-mode", "coord"],
    ["--precision", "pq", "--pq-subdims", "4"],
    ["--precision", "int8", "--adaptive", "--bound", "bernstein"]])
def test_serve_cli_tiers_on_cpu(argv, capsys):
    args = serve.parse_args(["--arch", "qwen1.5-0.5b", "--smoke", "--loop",
                             "--device", "cpu", "--requests", "12",
                             "--recall-rate", "1.0", *argv])
    stats = serve.run_loop(args)
    assert stats["completed"] == 12 and stats["pending"] == 0
    assert stats["adaptive"]["enabled"] == ("--adaptive" in argv)
    head = capsys.readouterr().out.splitlines()[0]
    assert f"precision={args.precision}" in head and "eps_eff=" in head
    assert "quant_err=" in head
    with pytest.raises(SystemExit):
        serve.parse_args(["--arch", "qwen1.5-0.5b", "--loop",
                          "--pq-subdims", "0"])


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


@pytest.mark.parametrize("argv,fragment", [
    (["--churn-rate", "0.25"], "requires --dynamic"),
    (["--tenants", "t.json", "--shards", "2"], "drop --dynamic/--shards"),
    (["--precision", "pq", "--dynamic", "--pull-mode", "coord"],
     "incompatible with a single-device quantized store")])
def test_serve_cli_refuses_later_slices(argv, fragment, capsys):
    """Combinations the JAX package's CLI refuses are refused with its
    reasons (``--shards`` under ``--tenants``: placement lives in the
    spec file)."""
    with pytest.raises(SystemExit):
        serve.parse_args(["--arch", "qwen1.5-0.5b", "--loop", *argv])
    assert fragment in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["--shards", "2"], ["--adaptive", "--shards", "2"],
    ["--precision", "int8", "--dynamic", "--pull-mode", "coord",
     "--shards", "2"],
    ["--runtime", "--eps-floor", "0.4", "--shards", "2",
     "--check-outcomes"],
    ["--runtime", "--dynamic", "--churn-rate", "0.25",
     "--inject-flush-rate", "0.2", "--shards", "2", "--check-outcomes"]])
def test_serve_cli_serves_shards(argv, capsys):
    """``--shards`` (refused until sharded serving was ported) serves:
    with a two-shard CPU mesh handed in, the loop's executor shards the
    table (``--dynamic``: a `ShardedTableStore`, which also lifts the
    single-device store's pull-mode rule) and the startup line says
    ``shards=2``; without one, the CPU is one device and the loop serves
    unsharded, as the JAX package's CLI does on one device (where a
    quantized single-device store then refuses the coord plan, as the
    JAX package's executor does)."""
    args = serve.parse_args(["--arch", "qwen1.5-0.5b", "--smoke", "--loop",
                             "--device", "cpu", "--requests", "12",
                             *argv])
    mesh = Mesh(["cpu"] * 2)
    stats = serve.run_loop(args, mesh=mesh)
    assert "shards=2" in capsys.readouterr().out
    assert stats["completed"] == 12
    if args.dynamic:
        assert stats["store"]["n_shards"] == 2
    if args.adaptive:
        assert stats["adaptive"]["samples"] % 2 == 0
    if args.pull_mode != "row":
        with pytest.raises(ValueError, match="incompatible"):
            serve.build_loop(args)
        return
    engine, _ = serve.build_loop(args)
    execs = engine.executors if args.runtime else [engine.executor]
    assert all(ex.mesh is None for ex in execs)


def test_serve_cli_refuses_decode_demo(capsys):
    """The decode demo is ported for every family; what it does not serve
    is refused with its reason: pq (no table to calibrate on, as in the
    JAX package's CLI), loop-only modes, and an unknown arch."""
    for argv, fragment in (
            (["--precision", "pq"], "requires --loop"),
            (["--runtime"], "requires --loop"),
            (["--tokens", "0"], "must be >= 1")):
        with pytest.raises(SystemExit):
            serve.parse_args(["--arch", "qwen1.5-0.5b", *argv])
        assert fragment in capsys.readouterr().err, argv
    for arch in ("mamba2-130m", "qwen3-moe-30b-a3b", "whisper-medium",
                 "command-r-35b"):
        args = serve.parse_args(["--arch", arch, "--mips", "boundedme"])
        assert serve.decode_config(args).mips_mode == "boundedme", arch
    with pytest.raises(SystemExit):
        serve.parse_args(["--arch", "llama-7b"])
    assert "unknown --arch" in capsys.readouterr().err
    args = serve.parse_args(["--arch", "tinyllama-1.1b", "--smoke"])
    assert not args.loop and args.mips == "exact" and args.tokens == 32
    # the decode demo takes --shards and serves unsharded, as the JAX
    # package's demo does (it was refused before sharding was ported)
    args = serve.parse_args(["--arch", "qwen1.5-0.5b", "--shards", "2"])
    assert args.shards == 2 and not args.loop


@pytest.mark.parametrize("mips", ["exact", "boundedme"])
def test_serve_cli_decode_demo_on_cpu(mips, capsys):
    serve.main(["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu",
                "--mips", mips, "--tokens", "3", "--batch", "2",
                "--prompt-len", "4"])
    out = capsys.readouterr().out
    assert f"mips={mips}" in out and "ms/tok" in out
    seq = out.strip().splitlines()[-1]
    assert seq.startswith("[serve] first sequences: [")
    assert len(seq.split("[")[-1].split(",")) == 3
    assert ("fused cascade" in out) == (mips == "boundedme")


def test_executor_serves_a_mesh_and_refuses_other_tables():
    """``mesh=`` (refused before sharded serving was ported) shards the
    table: fp32, int8 and adaptive serve over two CPU shards; a mesh
    needs a static table or a `ShardedTableStore`."""
    table = _table(64, 32)
    mesh = Mesh(["cpu"] * 2)
    for kw in (dict(mesh=mesh), dict(mesh=mesh, precision="int8"),
               dict(mesh=mesh, adaptive=True)):
        ex = CascadeExecutor(table, K=2, device="cpu", **kw)
        assert ex.mesh is mesh and ex.plan.n == 32
        ids, _, rounds, _ = ex.dispatch(table[:3],
                                        np.arange(ex.plan.n_blocks))
        assert ids.shape == (3, 2) and (ids < 64).all()
        assert (rounds is not None) == ex.adaptive
        if ex.adaptive:
            assert rounds.shape == (3, 2)
    with pytest.raises(ValueError, match="needs a ShardedTableStore"):
        CascadeExecutor(DynamicTableStore(table, device="cpu"),
                        mesh=mesh, device="cpu")
    with pytest.raises(TypeError, match="DynamicTableStore"):
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
    for mips in ("exact", "boundedme"):       # the decode demo
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.main(["--arch", "qwen1.5-0.5b", "--smoke", "--mips", mips,
                        "--tokens", "2"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "qwen1.5-0.5b", "--smoke", "--loop",
                    "--tenants", str(ROOT / "configs" / "tenants_smoke.json")])


TENANT_ARGV = [
    (["--tenants", "t.json"], "--tenants requires --loop"),
    (["--loop", "--tenants", "t.json", "--runtime"], "own runtime mode"),
    (["--loop", "--tenants", "t.json", "--dynamic"],
     "builds its own stores"),
    (["--loop", "--table-budget-mb", "10"],
     "--table-budget-mb requires --tenants"),
    (["--loop", "--tenants", "t.json", "--table-budget-mb", "0"],
     "--table-budget-mb must be > 0"),
    (["--loop", "--eps-floor", "0.5"], "requires --runtime or --tenants"),
    (["--loop", "--inject-error-rate", "0.1"],
     "requires --runtime or --tenants"),
    (["--loop", "--runtime", "--inject-flush-rate", "0.1"],
     "requires --dynamic or --tenants"),
    (["--loop", "--trace-out", "t.json"], "requires --runtime or --tenants"),
    (["--loop", "--flight-recorder-path", "f.json"],
     "requires --runtime or --tenants")]


@pytest.mark.parametrize("argv,fragment", TENANT_ARGV)
def test_serve_cli_tenant_checks_match_jax_package(argv, fragment, capsys):
    """The ``--tenants`` and ``--table-budget-mb`` checks, and the checks
    ``--tenants`` relaxes, refuse with the JAX package's CLI's message."""
    from repro.launch import serve as jserve
    argv = ["--arch", "qwen1.5-0.5b", *argv]
    with pytest.raises(SystemExit):
        serve.parse_args(argv)
    got = capsys.readouterr().err.strip().splitlines()[-1]
    ap = jserve._build_parser()
    with pytest.raises(SystemExit):
        jserve._validate_args(ap, ap.parse_args(argv))
    want = capsys.readouterr().err.strip().splitlines()[-1]
    assert fragment in got
    assert got.split("error: ", 1)[1] == want.split("error: ", 1)[1]


def test_serve_cli_tenant_flags_accepted():
    """What ``--tenants`` enables parses: the ladder, faults (flush
    faults too), artifacts and a budget."""
    args = serve.parse_args([
        "--arch", "qwen1.5-0.5b", "--loop", "--tenants", "t.json",
        "--table-budget-mb", "64", "--eps-floor", "0.4",
        "--inject-error-rate", "0.1", "--inject-flush-rate", "0.1",
        "--trace-out", "t.json", "--flight-recorder-path", "f.json"])
    assert args.tenants == "t.json" and args.table_budget_mb == 64.0


def test_simulate_stream_routes_tenants():
    """``tenants(i)`` names arrival ``i``'s tenant; classes stay off."""
    seen = []

    class Engine:
        deadline_s, pending_count, metrics, tracer = 1e-3, 0, None, None

        def submit(self, q, now=None, **kw):
            seen.append((float(q[0]), now, kw))

        def poll(self, now=None):
            return [], 0.0

        def stats(self):
            return {}

    qs = np.arange(6, dtype=np.float32)[:, None]
    serve.simulate_stream(Engine(), qs, tenants=lambda i: "ab"[i % 2],
                          open_loop=True, interarrival_ms=0.5)
    assert [kw for _, _, kw in seen] == [{"tenant": "ab"[i % 2]}
                                         for i in range(6)]
    assert [t for _, t, _ in seen] == [i * 5e-4 for i in range(6)]


def test_serve_cli_tenants_on_cpu(tmp_path, capsys):
    """The CPU end-to-end ``--tenants`` run: ``--check-outcomes`` holds,
    every tenant answers, the artifacts validate with their tenants, and
    the stats keys are the JAX CLI's on the same flags."""
    from repro.launch import serve as jserve
    from test_torch_runtime import _keys
    art = {k: str(tmp_path / f"{k}.{ext}") for k, ext in
           (("metrics", "prom"), ("trace", "json"), ("flight", "json"))}
    spec = str(ROOT / "configs" / "tenants_smoke.json")
    flags = ["--arch", "qwen1.5-0.5b", "--smoke", "--loop", "--tenants",
             spec, "--requests", "96", "--eps-floor", "4.0",
             "--inject-error-rate", "0.1", "--table-budget-mb", "1.2",
             "--check-outcomes"]
    stats = serve.run_tenants(serve.parse_args(
        flags + ["--device", "cpu", "--metrics-out", art["metrics"],
                 "--trace-out", art["trace"],
                 "--flight-recorder-path", art["flight"]]))
    out = capsys.readouterr().out
    assert "[check] OK" in out
    names = sorted(json.load(open(spec))["tenants"])
    assert sorted(stats["tenants"]) == names
    for name in names:       # every request typed once, per tenant
        t = stats["tenants"][name]
        assert t["requests"] > 0 and sum(t["outcomes"].values()) == \
            t["requests"], name
    assert stats["answered"] > 0 and stats["pending"] == 0
    assert stats["registry"]["evictions"] > 0
    assert stats["registry"]["resident_bytes"] <= stats["registry"][
        "byte_budget"]
    obs = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "check_obs_artifacts.py"),
         "--metrics", art["metrics"], "--trace", art["trace"],
         "--flight", art["flight"], "--expect-tenants", ",".join(names)],
        capture_output=True, text=True)
    assert obs.returncode == 0, obs.stdout + obs.stderr
    ap = jserve._build_parser()
    jargs = ap.parse_args(flags)
    jserve._validate_args(ap, jargs)
    jserve._run_tenants(jargs)
    jout = capsys.readouterr().out
    jstats = json.loads(jout[jout.index("\n{") + 1:jout.rindex("}") + 1])
    stats.pop("artifacts")
    for st in (stats, jstats):
        # residency-dependent: the store block and the rebuild causes
        for t in st["tenants"].values():
            t.pop("store", None)
            t["placement"]["executor_builds"] = {}
        for t in st["registry"]["tenants"].values():
            t["executor_builds"] = {}
    assert _keys(stats) == _keys(jstats)


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_no_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    names = {f.relative_to(ROOT / "src").as_posix() for f in files}
    assert {"repro_torch/launch/admission.py", "repro_torch/launch/faults.py",
            "repro_torch/obs/trace.py", "repro_torch/obs/flight.py",
            "repro_torch/distributed/sharding.py",
            "repro_torch/store/dynamic_table.py",
            "repro_torch/models/layers.py", "repro_torch/models/model.py",
            "repro_torch/models/steps.py",
            "repro_torch/configs/tinyllama_1_1b.py",
            "repro_torch/configs/qwen2_5_3b.py",
            "repro_torch/core/boundedme.py",
            "repro_torch/core/median_elim.py",
            "repro_torch/core/bounded_se.py",
            "repro_torch/baselines/__init__.py",
            "repro_torch/baselines/exact.py",
            "repro_torch/baselines/lsh_mips.py",
            "repro_torch/baselines/pca_mips.py",
            "repro_torch/baselines/greedy_mips.py"} <= names
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
