"""The port's sharded serving against the JAX package's, on the CPU.

A `Mesh` that repeats the CPU device stands in for XLA's forced host
device count: S = 2 and 3 shards of a small table (a few hundred rows,
d 64-256, ragged n, ``N % block != 0``) run the plain cascade per shard.

The oracle is the JAX package's own per-shard call: `bounded_me_decode`
on each zero-padded row shard with the same key (its permutation is the
port's ``perm``), ``k_out`` and live count, then the JAX package's merge
done in numpy (exact rescore when ``final_exact=False``, gaps against
the ``k_out``-th score, fillers at -inf, the global top-K by a stable
descending sort, as ``jax.lax.top_k`` orders ties).  Ids, gaps' finite
pattern and ``rounds_used`` must be equal; scores and gaps agree to rtol
1e-5 and atol 1e-6 * max|score| on every tier, because the merge's
scores are exact fp32 inner products summed in another order by XLA
(the int8 and int4 estimates are bitwise, but the merge never sees
them).  Against the port's own per-shard `decode_tiled` the whole tuple
is bitwise on every tier.  One case runs the JAX package's
`sharded_bounded_me_decode` itself on two forced host devices in a
subprocess.
"""

import contextlib
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.boundedme_jax import bounded_me_batched as jax_batched
from repro.core.boundedme_jax import bounded_me_decode as jax_decode
from repro.core.boundedme_jax import make_plan as jax_make_plan
from repro.core.schedule import flatten_schedule as jax_flatten
from repro.distributed.sharding import make_shard_plan as jax_shard_plan
from repro_torch.core import boundedme_torch as bt
from repro_torch.core.mips import sharded_mips_topk
from repro_torch.core.schedule import flatten_schedule
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import (Mesh, device_guard,
                                              make_shard_plan,
                                              shard_valid_counts,
                                              sharded_bounded_me_decode,
                                              sharded_decode_tiled)
from repro_torch.distributed.specs import serving_table_sharding
from repro_torch.kernels import library
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.engine import (CascadeExecutor, MIPSServeEngine,
                                       ServeRuntime)

TIERS = ["fp32", "int8", "int4", "pq"]


def _mesh(S):
    return Mesh(["cpu"] * S)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    if fin.any():
        scale = float(np.abs(want[fin]).max())
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5,
                                   atol=1e-6 * scale)


def _data(n, N, B=4, seed=0):
    rng = np.random.default_rng(seed + n + N)
    V = (0.02 * rng.normal(size=(n, N))).astype(np.float32)
    Q = rng.normal(size=(B, N)).astype(np.float32)
    return V, Q


def _knobs(V, precision, **kw):
    out = dict(K=4, eps=0.3, delta=0.1, block=64,
               value_range=2.0 * float(np.abs(V).max()),
               precision=precision,
               quant_err=1e-3 if precision == "pq" else None)
    out.update(kw)
    return out


def _numpy_merge(ids, scores, gaps, K):
    """The JAX package's merge over (B, S, k_out) candidates."""
    B = ids.shape[0]
    flat_i, flat_s, flat_g = (a.reshape(B, -1) for a in (ids, scores, gaps))
    pos = np.stack([np.argsort(-row, kind="stable")[:K] for row in flat_s])
    take = lambda a: np.take_along_axis(a, pos, axis=1)   # noqa: E731
    return take(flat_i), take(flat_s), take(flat_g)


def _jax_reference(V, Q, key, S, *, n_valid, final_exact=True,
                   adaptive=False, **kw):
    """Per-shard JAX `bounded_me_decode` plus the numpy merge."""
    n, N = V.shape
    jplan, n_local, n_pad, k_out = jax_shard_plan(n, N, S, **kw)
    Vp = np.pad(V, ((0, n_pad), (0, 0)))
    nv = (np.asarray(n_valid) if np.ndim(n_valid) == 1 else
          np.clip(n_valid - np.arange(S) * n_local, 0, n_local))
    ids, scores, gaps, rounds = [], [], [], []
    for s in range(S):
        Vl = Vp[s * n_local:(s + 1) * n_local]
        out = jax_decode(Vl, Q, key, plan=jplan, final_exact=final_exact,
                         use_pallas=False, k_out=k_out, n_valid=int(nv[s]),
                         adaptive=adaptive)
        ji, js = np.asarray(out[0]), np.asarray(out[1])
        if not final_exact:
            js = (np.einsum("bkc,bc->bk", Vl[np.clip(ji, 0, n_local - 1)],
                            Q) / np.float32(N)).astype(np.float32)
        g = (js - js[:, k_out - 1:k_out] if k_out > jplan.K
             else np.full_like(js, np.inf))
        ids.append(ji + s * n_local)
        scores.append(np.where(ji < nv[s], js, -np.inf).astype(np.float32))
        gaps.append(g)
        rounds.append(np.asarray(out[2]) if adaptive
                      else np.zeros(ji.shape[0], np.int32))
    cand = [np.stack(a, axis=1) for a in (ids, scores, gaps)]
    return (*_numpy_merge(*cand, kw["K"]), np.stack(rounds, axis=1), cand)


def _perm_of(key, n_blocks):
    return torch.from_numpy(np.array(jax.random.permutation(key, n_blocks)))


# ---- the mesh, placement and the shard plan --------------------------------

def test_the_one_mesh_axis_is_model():
    """The JAX signature's ``model_axis`` stays on the library calls, and
    only the port's one axis is accepted."""
    mesh = _mesh(2)
    V, Q = _data(64, 64)
    perm = bt.draw_perms(1)
    with pytest.raises(ValueError, match="model_axis must be 'model'"):
        sharded_bounded_me_decode(V, Q, perm, mesh=mesh, K=2, block=64,
                                  model_axis="rows")
    with pytest.raises(ValueError, match="model_axis must be 'model'"):
        sharded_mips_topk(V, Q, perm.expand(len(Q), 1), 2, mesh=mesh,
                          block=64, model_axis="rows")


def test_mesh_and_make_serving_mesh(monkeypatch):
    m = _mesh(3)
    assert m.shape == {"model": 3} and m.axis_names == ("model",)
    assert all(d == torch.device("cpu") for d in m.devices)
    with pytest.raises(ValueError, match="at least one"):
        Mesh([])
    assert mesh_mod.make_serving_mesh(device="cpu") is None
    assert mesh_mod.make_serving_mesh(4, device="cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert mesh_mod.make_serving_mesh(1) is None
    four = mesh_mod.make_serving_mesh()
    assert [str(d) for d in four.devices] == [f"cuda:{i}" for i in range(4)]
    assert mesh_mod.make_serving_mesh(8).shape == {"model": 4}   # capped
    assert mesh_mod.make_serving_mesh(2).shape == {"model": 2}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh_mod.make_serving_mesh(4) is None


@pytest.mark.parametrize("n,N,S,K,precision,mode", [
    (301, 200, 2, 4, "fp32", "row"), (301, 200, 3, 4, "int8", "row"),
    (300, 256, 3, 5, "int4", "coord"), (97, 100, 2, 3, "pq", "row"),
    (150, 64, 3, 60, "fp32", "hybrid"), (12, 64, 3, 12, "fp32", "row")])
def test_make_shard_plan_matches_jax(n, N, S, K, precision, mode):
    kw = dict(K=K, eps=0.25, delta=0.1, value_range=3.0, block=64,
              precision=precision, pull_mode=mode, coord_block=32,
              quant_err=1e-3 if precision == "pq" else None)
    jplan, *jgeo = jax_shard_plan(n, N, S, **kw)
    plan, *geo = make_shard_plan(n, N, S, **kw)
    assert geo == jgeo
    for f in ("n", "N", "K", "tile", "block", "n_tiles", "n_blocks",
              "precision", "pull_mode", "k_out_cap"):
        assert getattr(plan, f) == getattr(jplan, f), f
    for a, b in zip(flatten_schedule(plan.schedule).packed(),
                    jax_flatten(jplan.schedule).packed()):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        make_shard_plan(n, N, S, **dict(kw, K=n + 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_serving_table_sharding_pads_and_lays_out_each_shard(dtype):
    V, _ = _data(301, 200)
    table = torch.from_numpy(V).to(dtype)
    plan, n_local, n_pad, _ = make_shard_plan(301, 200, 3, K=4, block=64)
    shards = serving_table_sharding(table, _mesh(3), plan)
    assert n_pad == 2 and len(shards) == 3
    padded = torch.nn.functional.pad(table, (0, 0, 0, n_pad))
    for s, V4 in enumerate(shards):
        assert V4.dtype == dtype
        want = bt.tile_table(padded[s * n_local:(s + 1) * n_local], plan,
                             "cpu")
        assert torch.equal(V4, want)


def test_shard_valid_counts():
    np.testing.assert_array_equal(shard_valid_counts(250, 3, 100),
                                  [100, 100, 50])
    np.testing.assert_array_equal(shard_valid_counts(90, 3, 100),
                                  [90, 0, 0])
    np.testing.assert_array_equal(
        shard_valid_counts(np.array([3, 0, 7]), 3, 100), [3, 0, 7])
    with pytest.raises(ValueError, match="per-shard"):
        shard_valid_counts(np.array([1, 2]), 3, 100)


# ---- the sharded decode against the JAX package ----------------------------

@pytest.mark.parametrize("nv_kind", ["prefix", "vector"])
@pytest.mark.parametrize("final_exact", [True, False])
@pytest.mark.parametrize("S", [2, 3])
@pytest.mark.parametrize("precision", TIERS)
def test_sharded_decode_matches_jax_per_shard(precision, S, final_exact,
                                              nv_kind):
    """Ragged n (301 over 2 or 3 shards), N % block != 0 (200 over 64),
    caller padding (n_valid 290) or a per-shard live vector."""
    V, Q = _data(301, 200)
    kw = _knobs(V, precision)
    n_local = -(-301 // S)
    n_valid = (290 if nv_kind == "prefix"
               else np.array([n_local - 3, 7, 60][:S]))
    key = jax.random.PRNGKey(11)
    want = _jax_reference(V, Q, key, S, n_valid=n_valid,
                          final_exact=final_exact, **kw)
    plan = make_shard_plan(301, 200, S, **kw)[0]
    ids, scores, gaps, cand = sharded_bounded_me_decode(
        V, Q, _perm_of(key, plan.n_blocks), mesh=_mesh(S), n_valid=n_valid,
        final_exact=final_exact, return_candidates=True, **kw)
    np.testing.assert_array_equal(cand["ids"].numpy(), want[4][0])
    _close(cand["scores"].numpy(), want[4][1])
    np.testing.assert_array_equal(ids.numpy(), want[0])
    _close(scores.numpy(), want[1])
    _close(gaps.numpy(), want[2])
    assert ids.dtype == torch.int32 and scores.dtype == torch.float32
    live = np.concatenate([np.arange(int(c)) + s * n_local for s, c in
                           enumerate(shard_valid_counts(n_valid, S,
                                                        n_local))])
    fin = np.isfinite(scores.numpy())
    assert np.isin(ids.numpy()[fin], live).all()


@pytest.mark.parametrize("S", [2, 3])
@pytest.mark.parametrize("precision,bound", [
    ("fp32", "hoeffding"), ("fp32", "bernstein"), ("int8", "bernstein")])
def test_sharded_adaptive_matches_jax_per_shard(precision, bound, S):
    """Planted rows make shards certify at different rounds."""
    rng = np.random.default_rng(5)
    V = rng.normal(size=(203, 300)).astype(np.float32)
    Q = rng.normal(size=(4, 300)).astype(np.float32)
    for b, strength in enumerate([0.0, 0.3, 0.6, 1.5]):
        V[rng.choice(203, 3, replace=False)] += strength * Q[b]
    kw = dict(K=3, eps=4.0, delta=0.1, value_range=8.0, block=64,
              precision=precision, bound=bound)
    key = jax.random.PRNGKey(4)
    want = _jax_reference(V, Q, key, S, n_valid=200, adaptive=True, **kw)
    plan = make_shard_plan(203, 300, S, **kw)[0]
    ids, scores, gaps, rounds = sharded_bounded_me_decode(
        V, Q, _perm_of(key, plan.n_blocks), mesh=_mesh(S), n_valid=200,
        adaptive=True, **kw)
    assert rounds.shape == (4, S) and rounds.dtype == torch.int32
    np.testing.assert_array_equal(rounds.numpy(), want[3])
    np.testing.assert_array_equal(ids.numpy(), want[0])
    _close(scores.numpy(), want[1])
    _close(gaps.numpy(), want[2])


TIER_CASES = [(t, False) for t in TIERS] + [("fp32", True), ("int8", True)]


@pytest.mark.parametrize("precision,adaptive", TIER_CASES)
def test_sharded_decode_bitwise_the_ports_per_shard_calls(precision,
                                                          adaptive):
    """Every tier, bitwise: the port's per-shard `decode_tiled` on the
    same shards, artifacts, perm and live counts, merged in numpy."""
    V, Q = _data(250, 130)
    kw = _knobs(V, precision)
    S = 3
    plan, n_local, _, k_out = make_shard_plan(250, 130, S, **kw)
    mesh = _mesh(S)
    shards = serving_table_sharding(V, mesh, plan)
    quant = (None if precision == "fp32"
             else [bt.quantize_table(V4, plan) for V4 in shards])
    nv = shard_valid_counts(240, S, n_local)
    perm = bt.draw_perms(plan.n_blocks)
    out = sharded_decode_tiled(shards, Q, perm, mesh=mesh, plan=plan, K=4,
                               k_out=k_out, n_valid=nv, quantized=quant,
                               adaptive=adaptive)
    ids, scores, gaps, rounds = [], [], [], []
    for s in range(S):
        o = bt.decode_tiled(shards[s], Q, perm, plan=plan, k_out=k_out,
                            n_valid=int(nv[s]),
                            quantized=None if quant is None else quant[s],
                            adaptive=adaptive)
        ji, js = o[0].numpy(), o[1].numpy()
        gaps.append(js - js[:, k_out - 1:k_out])
        ids.append(ji + s * n_local)
        scores.append(np.where(ji < nv[s], js, -np.inf).astype(np.float32))
        if adaptive:
            rounds.append(o[2].numpy())
    want = _numpy_merge(*(np.stack(a, 1) for a in (ids, scores, gaps)), 4)
    for got, w in zip(out[:3], want):
        np.testing.assert_array_equal(got.numpy(), w)
    if adaptive:
        np.testing.assert_array_equal(out[3].numpy(), np.stack(rounds, 1))


def test_sharded_decode_matches_jax_sharded_function_subprocess(tmp_path):
    """The JAX package's `sharded_bounded_me_decode` itself on two forced
    host devices (a subprocess, as tests/test_sharded_serve.py runs it):
    fp32 and int8, exact and estimated final scores, ragged n."""
    out = tmp_path / "jax.npz"
    code = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=2").strip()
        import jax, numpy as np
        from repro.distributed.sharding import sharded_bounded_me_decode
        mesh = jax.make_mesh((2,), ("model",))
        rng = np.random.default_rng(3)
        V = (0.02 * rng.normal(size=(201, 192))).astype(np.float32)
        Q = rng.normal(size=(4, 192)).astype(np.float32)
        res = {{"V": V, "Q": Q}}
        key = jax.random.PRNGKey(5)
        for prec in ("fp32", "int8"):
            for fe in (True, False):
                ids, sc, gaps = sharded_bounded_me_decode(
                    V, Q, key, mesh=mesh, K=4, n_valid=195, eps=0.3,
                    delta=0.1, value_range=2 * float(np.abs(V).max()),
                    block=64, final_exact=fe, precision=prec,
                    use_pallas=False)
                res[f"{{prec}}_{{fe}}"] = np.stack(
                    [np.asarray(ids).astype(np.float32), np.asarray(sc),
                     np.asarray(gaps)])
        np.savez({str(out)!r}, **res)
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=600)
    assert "OK" in r.stdout, r.stdout + r.stderr
    got = np.load(out)
    V, Q = got["V"], got["Q"]
    key = jax.random.PRNGKey(5)
    for prec in ("fp32", "int8"):
        for fe in (True, False):
            kw = dict(K=4, eps=0.3, delta=0.1, block=64, precision=prec,
                      value_range=2 * float(np.abs(V).max()))
            plan = make_shard_plan(201, 192, 2, **kw)[0]
            ids, sc, gaps = sharded_bounded_me_decode(
                V, Q, _perm_of(key, plan.n_blocks), mesh=_mesh(2),
                n_valid=195, final_exact=fe, **kw)
            want = got[f"{prec}_{fe}"]
            np.testing.assert_array_equal(ids.numpy(), want[0])
            _close(sc.numpy(), want[1])
            _close(gaps.numpy(), want[2])


# ---- the merge's tie order -------------------------------------------------

def test_merge_ties_keep_the_lower_position_first():
    """Rows duplicated across shards tie exactly; ``jax.lax.top_k`` on the
    same candidates keeps the lower (shard-major) position first, and so
    must the port's merge."""
    rng = np.random.default_rng(8)
    base = (0.02 * rng.normal(size=(64, 128))).astype(np.float32)
    V = np.concatenate([base, base, base])         # shard s = rows of s
    Q = rng.normal(size=(3, 128)).astype(np.float32)
    kw = dict(K=5, eps=0.3, delta=0.1, block=64,
              value_range=2 * float(np.abs(V).max()))
    plan = make_shard_plan(192, 128, 3, **kw)[0]
    ids, scores, _, cand = sharded_bounded_me_decode(
        V, Q, bt.draw_perms(plan.n_blocks), mesh=_mesh(3),
        return_candidates=True, **kw)
    flat = cand["scores"].reshape(3, -1)
    vals, pos = jax.lax.top_k(jnp.asarray(flat.numpy()), 5)
    want = np.take_along_axis(cand["ids"].reshape(3, -1).numpy(),
                              np.asarray(pos), axis=1)
    np.testing.assert_array_equal(ids.numpy(), want)
    np.testing.assert_array_equal(scores.numpy(), np.asarray(vals))
    # the winners tie across shards: each row's copies rank shard-major
    assert (np.diff(scores.numpy()[:, :3], axis=1) == 0).all()
    assert (np.diff(ids.numpy()[:, :3], axis=1) == 64).all()


def test_merge_fills_past_the_live_rows_with_ordered_infs():
    """Fewer live rows than K: -inf fillers, in jax.lax.top_k's order."""
    V, Q = _data(96, 128, B=2)
    kw = dict(K=6, eps=0.3, delta=0.1, block=64, value_range=0.5)
    plan = make_shard_plan(96, 128, 2, **kw)[0]
    ids, scores, _, cand = sharded_bounded_me_decode(
        V, Q, bt.draw_perms(plan.n_blocks), mesh=_mesh(2),
        n_valid=np.array([2, 1]), return_candidates=True, **kw)
    assert np.isfinite(scores.numpy()).sum(axis=1).tolist() == [3, 3]
    flat = cand["scores"].reshape(2, -1)
    vals, pos = jax.lax.top_k(jnp.asarray(flat.numpy()), 6)
    want = np.take_along_axis(cand["ids"].reshape(2, -1).numpy(),
                              np.asarray(pos), axis=1)
    np.testing.assert_array_equal(ids.numpy(), want)
    np.testing.assert_array_equal(scores.numpy(), np.asarray(vals))
    assert set(ids.numpy()[0, :3].tolist()) == {0, 1, 48}


# ---- device placement ------------------------------------------------------

def test_each_shard_launches_under_its_own_device_guard(monkeypatch):
    """Every shard's cascade is issued inside one guard of its own
    device, after every device's staging and before any merge copy; the
    guards are entered around the launches only."""
    S = 3
    mesh = _mesh(S)
    V, Q = _data(240, 128)
    plan, n_local, _, k_out = make_shard_plan(240, 128, S, K=4, block=64)
    shards = serving_table_sharding(V, mesh, plan)
    stack, log = [], []

    @contextlib.contextmanager
    def guard(dev):
        stack.append(dev)
        log.append(("enter", dev))
        try:
            yield
        finally:
            stack.pop()

    real = sharding.cascade_tiled

    def recording(V4, Qp, perm, **kw):
        log.append(("launch", tuple(stack), next(
            s for s, t in enumerate(shards) if t is V4)))
        assert V4.device == Qp.device == perm.device == stack[-1]
        return real(V4, Qp, perm, **kw)

    monkeypatch.setattr(sharding, "device_guard", guard)
    monkeypatch.setattr(sharding, "cascade_tiled", recording)
    sharded_decode_tiled(shards, Q, bt.draw_perms(plan.n_blocks), mesh=mesh,
                         plan=plan, K=4, k_out=k_out, n_valid=240)
    launches = [e for e in log if e[0] == "launch"]
    assert [e[2] for e in launches] == list(range(S))
    assert all(len(e[1]) == 1 for e in launches)   # one guard, not nested
    assert [e[0] for e in log] == ["enter", "launch"] * S
    assert [e[1] for e in log if e[0] == "enter"] == list(mesh.devices)


def test_device_guard_and_the_current_device_check(monkeypatch):
    """The shard guard switches to its card (nothing on the CPU); a
    kernel wrapper's `on_device` switches only to another card than the
    current one, and `require_current` refuses operands off it."""
    assert isinstance(device_guard(torch.device("cpu")),
                      contextlib.nullcontext)
    g = device_guard(torch.device("cuda", 1))
    assert isinstance(g, torch.cuda.device) and g.idx == 1
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert isinstance(library.on_device(torch.device("cuda", 0)),
                      contextlib.nullcontext)
    g = library.on_device(torch.device("cuda", 1))
    assert isinstance(g, torch.cuda.device) and g.idx == 1
    library.require_current(torch.device("cuda", 0))
    with pytest.raises(ValueError, match="current device is cuda:0"):
        library.require_current(torch.device("cuda", 1))


# ---- sharded_mips_topk -----------------------------------------------------

@pytest.mark.parametrize("S,precision,n_valid", [
    (2, "fp32", None), (3, "int8", 290), (3, "int4", None),
    (2, "pq", 280)])
def test_sharded_mips_topk_matches_jax_per_shard(S, precision, n_valid):
    """Per-query keys (their permutations the port's ``perms``), one
    batched call per shard of the JAX package, then the merge."""
    V, Q = _data(300, 200, B=3)
    kw = _knobs(V, precision, K=3)
    n_local = 300 // S
    keys = jax.random.split(jax.random.PRNGKey(2), 3)
    jplan = jax_make_plan(n_local, 200, **dict(kw, delta=0.1 / S))
    perms = torch.stack([_perm_of(k, jplan.n_blocks) for k in keys])
    cids, csc = [], []
    for s in range(S):
        ji, js = jax_batched(V[s * n_local:(s + 1) * n_local], Q, keys,
                             plan=jplan, final_exact=True, use_pallas=False)
        gi = np.asarray(ji) + s * n_local
        js = np.asarray(js)
        if n_valid is not None:
            js = np.where(gi < n_valid, js, -np.inf)
        cids.append(gi)
        csc.append(js)
    all_i, all_s = np.concatenate(cids, 1), np.concatenate(csc, 1)
    pos = np.stack([np.argsort(-r, kind="stable")[:3] for r in all_s])
    ids, scores = sharded_mips_topk(V, Q, perms, 3, mesh=_mesh(S),
                                    n_valid=n_valid, **{
                                        k: v for k, v in kw.items()
                                        if k != "K"})
    np.testing.assert_array_equal(ids.numpy(),
                                  np.take_along_axis(all_i, pos, 1))
    _close(scores.numpy(), np.take_along_axis(all_s, pos, 1))
    with pytest.raises(ValueError, match="evenly"):
        sharded_mips_topk(np.concatenate([V, V[:1]]), Q, perms, 3,
                          mesh=_mesh(S), **{k: v for k, v in kw.items()
                                            if k != "K"})


# ---- the engines over a mesh -----------------------------------------------

@pytest.mark.parametrize("precision,adaptive", TIER_CASES)
def test_executor_dispatch_is_the_sharded_decode(precision, adaptive):
    """A static table sharded once at construction: every dispatch equals
    `sharded_bounded_me_decode` on the raw table, bitwise, with
    ``rounds_used (B, S)``; the padded rows never answer; recall masks
    them."""
    V, Q = _data(301, 200)
    mesh = _mesh(3)
    ex = CascadeExecutor(V, K=4, eps=0.3, block=64, mesh=mesh, n_valid=290,
                         precision=precision, adaptive=adaptive,
                         quant_err=1e-3 if precision == "pq" else None,
                         device="cpu")
    assert ex.plan.n == 101 and ex.mesh is mesh
    perm = bt.draw_perms(ex.plan.n_blocks)
    ids, scores, rounds, dt = ex.dispatch(Q, perm)
    want = sharded_bounded_me_decode(
        V, Q, perm, mesh=mesh, K=4, n_valid=290, eps=0.3, delta=0.1,
        value_range=ex.plan_value_range, block=64, precision=precision,
        quant_err=1e-3 if precision == "pq" else None, adaptive=adaptive)
    np.testing.assert_array_equal(ids, want[0].numpy())
    np.testing.assert_array_equal(scores, want[1].numpy())
    if adaptive:
        np.testing.assert_array_equal(rounds, want[3].numpy())
    else:
        assert rounds is None
    assert (ids < 290).all() and dt > 0
    assert ex.recall_of(Q[0], ids[0]) >= 0.5
    with pytest.raises(ValueError, match="shard_operands"):
        ex.tiled_table


def test_engine_and_runtime_serve_a_mesh():
    """`MIPSServeEngine` and `ServeRuntime` pass ``mesh=`` through: the
    answers are the executors' sharded dispatches, the adaptive rounds
    histogram and lane accounting take ``(B, S)``."""
    V, _ = _data(301, 200)
    rng = np.random.default_rng(1)
    qs = rng.normal(size=(12, 200)).astype(np.float32)
    mesh = _mesh(2)
    eng = MIPSServeEngine(V, K=4, eps=0.3, block=64, batch_size=4,
                          mesh=mesh, n_valid=290, adaptive=True,
                          cache_entries=0, device="cpu")
    for i, q in enumerate(qs):
        eng.submit(q, now=0.0)
    eng.drain(now=1.0)
    st = eng.stats()
    assert st["completed"] == 12
    assert st["adaptive"]["samples"] == 12 * 2          # B x S exits
    perm = eng._perm_source(0)
    ids, scores, _, _ = eng.executor.dispatch(qs[:4], perm)
    for i in range(4):
        got = eng.result(i)
        np.testing.assert_array_equal(got[0], ids[i])
        np.testing.assert_array_equal(got[1], scores[i])
    rt = ServeRuntime(V, K=4, eps=0.3, eps_floor=0.6, block=64, lanes=4,
                      mesh=mesh, n_valid=290, adaptive=True, device="cpu")
    assert all(ex.mesh is mesh for ex in rt.executors)
    for i, q in enumerate(qs):
        rt.submit(q, now=i * 1e-4)
    rt.drain(now=1.0)
    s = rt.stats()
    assert s["outcomes"]["ok"] + s["outcomes"]["degraded"] == 12
    assert 0 < s["lanes"]["mean_executed_pull_frac"] <= 1.0
