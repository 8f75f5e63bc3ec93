"""Decode of a model placed over a ``DeviceMesh`` against the JAX package,
on the CPU, ranks simulated under ``LocalTensorMode``
(``simulated_mesh(..., device="cpu")``).

* Kernel 1 as an operator: ``torch.library.opcheck`` of
  ``repro_torch::fused_cascade_batched`` and ``repro_torch::fused_cascade``
  (schema, fake implementation against the CPU one, dispatch under
  ``FakeTensorMode``), and the operator running once per simulated rank
  on that rank's tensors.
* `sharded_bounded_me_decode` and `sharded_mips_topk` over (1, 2) and
  (2, 2) meshes, the batch replicated or split over 'data': ids equal to
  the JAX package's own functions on 2 or 4 forced host devices (one
  subprocess computes them all, as ``tests/test_sharded_serve.py`` runs
  the JAX sharded path), scores and gaps to rtol 1e-5 and atol 1e-6 *
  max|score| on every tier (the merged scores are exact fp32 inner
  products, the int8 tier's rescored ones too, summed by XLA in another
  order: 1 ulp apart, as ``tests/test_torch_sharding.py`` holds them),
  and the whole tuple bitwise the port's serving-`Mesh` version under
  the same perm.
* `decode_step` of smoke qwen1.5-0.5b (2 layers, ``vocab_pad=64``,
  ``mips_eps=0.01``: the JAX test's settings) placed by `param_pspecs`:
  tokens equal to the JAX single-device exact `decode_step` and to the
  port's one-device bandit `decode_step`.
* Decode attention over a cache split on 'model' and on ('data',
  'model'), with a prompt shorter than one shard: hidden states within
  rtol 1e-5 (f32) of one device's, at the scale of the largest entry
  (the softmax's sums and the PV product reduce over ranks in another
  order), equal tokens, no NaN.
* The dry run's ``decode_32k`` cells of the two boundedme archs trace
  under the bandit head, and a dense decode cell gathers less than its
  cache.
"""

import contextlib
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY
from repro.models.model import init_params
from repro.models.steps import decode_step as jax_decode_step
from repro.models.steps import prefill_step as jax_prefill_step
from repro_torch.configs import get_config, get_shape
from repro_torch.convert import params_from_jax
from repro_torch.core.boundedme_torch import (decode_operands, draw_perms,
                                              make_plan, tile_table)
from repro_torch.core.mips import sharded_mips_topk
from repro_torch.distributed.sharding import (Mesh, logical_mesh,
                                              make_shard_plan,
                                              sharded_bounded_me_decode)
from repro_torch.distributed.specs import (batch_pspecs, param_pspecs,
                                           place_params, place_tree)
from repro_torch.kernels import ref
from repro_torch.launch import dryrun as D
from repro_torch.launch.comm_analysis import TraceCounter, collective_bytes
from repro_torch.launch.mesh import simulated_mesh
from repro_torch.models.steps import decode_step, prefill_step

N_ROWS, DIM, B = 301, 200, 4

#: (name, mesh shape, batch_axes, K, precision, adaptive, n_valid kind)
DECODE_CASES = [
    ("m12_k1_fp32", (1, 2), None, 1, "fp32", False, "prefix"),
    ("m12_k4_int8", (1, 2), None, 4, "int8", False, "prefix"),
    ("m12_k4_vec", (1, 2), None, 4, "fp32", False, "vector"),
    ("m22_k4_fp32", (2, 2), "data", 4, "fp32", False, "prefix"),
    ("m22_k1_int8", (2, 2), "data", 1, "int8", False, "prefix"),
    ("m22_k4_adaptive", (2, 2), "data", 4, "fp32", True, "prefix"),
]
#: (name, mesh shape, batch_axes, K, precision, n_valid)
MIPS_CASES = [
    ("m12_k4_fp32", (1, 2), None, 4, "fp32", None),
    ("m22_k1_int8", (2, 2), "data", 1, "int8", 290),
]


def _data():
    rng = np.random.default_rng(17)
    V = (0.02 * rng.normal(size=(N_ROWS, DIM))).astype(np.float32)
    Q = rng.normal(size=(B, DIM)).astype(np.float32)
    for b in range(B):                  # a clear winner per query
        V[rng.integers(N_ROWS - 20)] += 0.05 * Q[b]
    return V, Q


def _knobs(V, precision, K):
    return dict(K=K, eps=0.3, delta=0.1, block=64,
                value_range=2.0 * float(np.abs(V).max()),
                precision=precision)


def _n_valid(kind):
    return 290 if kind == "prefix" else np.array([140, 97])


_JAX_CODE = """
import os
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4").strip()
import sys
import jax, numpy as np
from jax.sharding import Mesh
sys.path.insert(0, {tests!r})
import test_torch_decode_mesh as T
from repro.core.mips import sharded_mips_topk
from repro.distributed.sharding import sharded_bounded_me_decode
V, Q = T._data()
key = jax.random.PRNGKey(9)
devs = np.array(jax.devices())
out = {{}}
def mesh_of(shape):
    return Mesh(devs[:shape[0] * shape[1]].reshape(shape), ("data", "model"))
for name, shape, ba, K, prec, ad, nv in T.DECODE_CASES:
    r = sharded_bounded_me_decode(
        V, Q, key, mesh=mesh_of(shape), K=K, batch_axes=ba,
        n_valid=T._n_valid(nv), adaptive=ad, use_pallas=False,
        **{{k: v for k, v in T._knobs(V, prec, K).items() if k != "K"}})
    for i, a in enumerate(r):
        out[f"decode_{{name}}_{{i}}"] = np.asarray(a)
keys = jax.random.split(jax.random.PRNGKey(3), T.B)
for name, shape, ba, K, prec, nv in T.MIPS_CASES:
    V2 = np.concatenate([V, V[:11]])[:300]
    r = sharded_mips_topk(
        V2, Q, keys, K, mesh=mesh_of(shape), batch_axes=ba, n_valid=nv,
        use_pallas=False,
        **{{k: v for k, v in T._knobs(V, prec, K).items() if k != "K"}})
    for i, a in enumerate(r):
        out[f"mips_{{name}}_{{i}}"] = np.asarray(a)
np.savez({path!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module", autouse=True)
def _jax_run(tmp_path_factory):
    """The JAX package's sharded functions on 4 forced host devices, in a
    subprocess (this process keeps its one device) started with the
    module's first test, so that it runs beside the others."""
    path = str(tmp_path_factory.mktemp("jax") / "sharded.npz")
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(tests, "..", "src"))
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(
        _JAX_CODE.format(tests=tests, path=path))], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc, path
    proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def jax_sharded(_jax_run):
    proc, path = _jax_run
    out, err = proc.communicate(timeout=600)
    assert "OK" in out, out + err
    return dict(np.load(path))


def _full(t):
    """A DTensor result as one plain tensor, the simulated ranks' copies
    reconciled (they must agree)."""
    if isinstance(t, dict):
        return {k: _full(v) for k, v in t.items()}
    if isinstance(t, torch.distributed.tensor.DTensor):
        t = t.full_tensor()
    if hasattr(t, "reconcile"):
        t = t.reconcile()
    return t.detach().cpu()


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    if fin.any():
        scale = float(np.abs(want[fin]).max())
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5,
                                   atol=1e-6 * scale)


def _perm(key, n_blocks):
    return torch.from_numpy(np.array(jax.random.permutation(key,
                                                            n_blocks)))


# ---- kernel 1 as an operator -------------------------------------------------

def _op_args(precision, adaptive):
    V, Q = _data()
    plan = make_plan(N_ROWS, DIM, K=4, eps=0.3, delta=0.1, block=64,
                     value_range=1.0, precision=precision)
    V4 = tile_table(V, plan, "cpu")
    sc, rm, bpos, tf, nf, cert = decode_operands(
        plan, final_exact=True, adaptive=adaptive, device=V4.device)
    Qp = torch.nn.functional.pad(torch.from_numpy(Q),
                                 (0, plan.n_blocks * 64 - DIM))
    Qb = Qp.reshape(B, plan.n_blocks, 64).contiguous()
    cols = draw_perms(plan.n_blocks, B)[:, bpos].to(torch.int32)
    vscale = qscale = None
    if precision == "int8":
        from repro_torch.core.quantize import quantize_blocks, quantize_tiles
        V4, vscale = quantize_tiles(V4)
        Qb, qscale = quantize_blocks(Qb)
    return plan, (V4, Qb, sc, rm, cols, vscale, qscale, None, cert,
                  plan.n, plan.K, tf, nf, plan.K + 1, 290, False, plan.K,
                  False)


@pytest.mark.parametrize("precision,adaptive", [("fp32", False),
                                                ("int8", True)])
def test_kernel_op_opcheck(precision, adaptive):
    """The batched and the single-query operators pass ``opcheck``
    (schema, fake against CPU implementation, dispatch under fake
    tensors); the fake outputs have the real ones' shapes and types."""
    _, args = _op_args(precision, adaptive)
    torch.library.opcheck(torch.ops.repro_torch.fused_cascade_batched,
                          args)
    single = (args[0], args[1][0], *args[2:4], args[4][0],
              args[5], None if args[6] is None else args[6][0], *args[7:])
    torch.library.opcheck(torch.ops.repro_torch.fused_cascade, single)
    real = torch.ops.repro_torch.fused_cascade_batched(*args)
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = torch.ops.repro_torch.fused_cascade_batched(*(
            mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
            for a in args))
    assert [(f.shape, f.dtype) for f in fake] == \
        [(r.shape, r.dtype) for r in real]
    assert len(real) == (3 if adaptive else 2)


def test_kernel_op_runs_once_per_simulated_rank(monkeypatch):
    """Under ``LocalTensorMode`` the operator runs once per rank, each on
    that rank's own shard and live count; the entry's result equals the
    plain version's."""
    seen = []
    real = ref.fused_cascade_batched_ref

    def spy(V4, *a, **k):
        assert type(V4) is torch.Tensor          # a rank's plain tensor
        seen.append((V4.data_ptr(), k["n_valid"]))
        return real(V4, *a, **k)
    monkeypatch.setattr(ref, "fused_cascade_batched_ref", spy)
    V, Q = _data()
    kw = _knobs(V, "fp32", 4)
    plan = make_shard_plan(N_ROWS, DIM, 2, **kw)[0]
    perm = draw_perms(plan.n_blocks)
    with simulated_mesh((2, 2), device="cpu") as mesh:
        sharded_bounded_me_decode(torch.from_numpy(V), torch.from_numpy(Q),
                                  perm, mesh=mesh, n_valid=290,
                                  batch_axes="data", **kw)
    assert len(seen) == 4 and len({p for p, _ in seen}) == 4
    assert sorted(nv for _, nv in seen) == [139, 139, 151, 151]


# ---- decode_step of a model placed over a mesh -----------------------------

def _configs(**kw):
    base = dict(vocab_pad=64, mips_eps=0.01, n_layers=2)
    base.update(kw)
    return (dataclasses.replace(REGISTRY["qwen1.5-0.5b"].smoke(), **base),
            dataclasses.replace(get_config("qwen1.5-0.5b").smoke(), **base))


@pytest.fixture(scope="module")
def smoke_model():
    jcfg, cfg = _configs()
    params = init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, params, jax.tree.map(np.asarray, params)


PROMPT, CACHE, STEPS = 8, 16, 4


def _prompt(cfg):
    return np.random.default_rng(0).integers(0, cfg.vocab, (B, PROMPT)
                                             ).astype(np.int32)


def _jax_exact_tokens(jcfg, params, tok):
    cfg_e = dataclasses.replace(jcfg, mips_mode="exact")
    _, caches = jax_prefill_step(params, jcfg, jnp.asarray(tok),
                                 cache_len=CACHE)
    step = jax.jit(lambda p, c, t, pos: jax_decode_step(p, cfg_e, c, t, pos))
    cur, out = jnp.asarray(tok[:, -1:]), []
    for i in range(STEPS):
        nxt, caches = step(params, caches, cur, jnp.int32(PROMPT + i))
        out.append(np.asarray(nxt))
        cur = nxt[:, None]
    return np.stack(out, 1)


def _port_tokens(cfg, params_np, tok, perms, mesh=None, rules=None,
                 hidden=False, steps=STEPS):
    """Greedy tokens (and each step's last hidden state) of the port's
    `decode_step`, on one device or placed over ``mesh``."""
    model = params_from_jax(params_np, cfg, device="cpu")
    t = torch.from_numpy(tok)
    toks, hids = [], []
    with (logical_mesh(mesh, rules) if mesh is not None
          else contextlib.nullcontext()):
        if mesh is not None:
            place_params(model, param_pspecs(
                cfg, dict(model.named_parameters()), mesh), mesh)
            t = place_tree({"tokens": t}, batch_pspecs(mesh, B, {
                "tokens": t}), mesh)["tokens"]
        _, caches = prefill_step(model, t, CACHE)
        cur = t[:, -1:]
        for i in range(steps):
            if hidden:
                h, _ = model(cur, caches=[{k: v for k, v in c.items()}
                                          for c in caches], pos=PROMPT + i)
                hids.append(_full(h[:, -1]))
            nxt, caches = decode_step(model, cfg, caches, cur, PROMPT + i,
                                      perm=perms[i])
            toks.append(_full(nxt))
            cur = nxt[:, None]
    return torch.stack(toks, 1).numpy(), hids


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_decode_step_over_a_mesh_matches_jax_exact_and_one_device(
        shape, smoke_model):
    jcfg, cfg, params, params_np = smoke_model
    cfg_b = dataclasses.replace(cfg, mips_mode="boundedme")
    tok = _prompt(cfg)
    perms = [_perm(jax.random.PRNGKey(i), 1) for i in range(STEPS)]
    want = _jax_exact_tokens(jcfg, params, tok)
    one, _ = _port_tokens(cfg_b, params_np, tok, perms)
    with simulated_mesh(shape, device="cpu") as mesh:
        got, _ = _port_tokens(cfg_b, params_np, tok, perms, mesh)
    np.testing.assert_array_equal(one, want)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,rules", [
    ((1, 4), None), ((2, 2), {"batch": None, "kvseq": ("data", "model")})],
    ids=["model", "data_model"])
def test_split_cache_attention_matches_one_device(shape, rules,
                                                  smoke_model):
    """A 32-position cache split 4 ways, a 4-token prompt: at the first
    step three ranks hold only positions past the query."""
    global PROMPT, CACHE
    jcfg, cfg, params, params_np = smoke_model
    tok = _prompt(cfg)[:, :4]
    perms = [None] * 2
    old = PROMPT, CACHE
    PROMPT, CACHE = 4, 32
    try:
        want, want_h = _port_tokens(cfg, params_np, tok, perms, hidden=True,
                                    steps=2)
        with simulated_mesh(shape, device="cpu") as mesh:
            with TraceCounter() as tc:
                got, got_h = _port_tokens(cfg, params_np, tok, perms, mesh,
                                          rules, hidden=True, steps=2)
    finally:
        PROMPT, CACHE = old
    np.testing.assert_array_equal(got, want)
    for g, w in zip(got_h, want_h):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(w.abs().max()))
    # no collective carries a cache: the largest all-gather is far below
    # one layer's K (4 x 32 x kv heads x head dim x 4 bytes)
    layer_k = B * 32 * cfg.n_kv_heads * cfg.head_dim * 4
    gathers = [s for k, s in tc.collectives if k == "all-gather"]
    assert max(collective_bytes([("all-gather", s)])["total_bytes"]
               for s in gathers) < layer_k


# ---- the dry run -------------------------------------------------------------

MESH = ((2, 4), ("data", "model"))


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "command-r-35b"])
def test_boundedme_decode_cells_trace(arch):
    cfg = get_config(arch).smoke()
    assert cfg.mips_mode == "boundedme"
    rec = D.run_cell(cfg, get_shape("decode_32k"), "single", save=False,
                     mesh_shape=MESH)
    assert rec["ok"], rec.get("traceback")
    assert rec["mips_mode"] == "boundedme"
    assert rec["collectives"]["all-gather_count"] > 0


def test_dense_decode_cell_gathers_less_than_its_cache():
    rec = D.run_cell(get_config("qwen1.5-0.5b").smoke(),
                     get_shape("decode_32k"), "single", save=False,
                     mesh_shape=MESH)
    assert rec["ok"], rec.get("traceback")
    assert 0 < rec["collectives"]["all-gather_bytes"] < rec["cache_bytes"]


# ---- the sharded decode and mips_topk over a DeviceMesh --------------------

@pytest.mark.parametrize("case", DECODE_CASES, ids=[c[0] for c in
                                                     DECODE_CASES])
def test_mesh_decode_matches_jax_and_the_serving_mesh(case, jax_sharded):
    name, shape, ba, K, prec, ad, nv_kind = case
    V, Q = _data()
    kw = _knobs(V, prec, K)
    nv = _n_valid(nv_kind)
    plan = make_shard_plan(N_ROWS, DIM, 2, **kw)[0]
    perm = _perm(jax.random.PRNGKey(9), plan.n_blocks)
    want = sharded_bounded_me_decode(
        V, Q, perm, mesh=Mesh(["cpu"] * 2), n_valid=nv, adaptive=ad,
        return_candidates=True, **kw)
    with simulated_mesh(shape, device="cpu") as mesh:
        got = sharded_bounded_me_decode(
            torch.from_numpy(V), torch.from_numpy(Q), perm, mesh=mesh,
            n_valid=nv, batch_axes=ba, adaptive=ad, return_candidates=True,
            **kw)
        got = [_full(g) for g in got]
    for g, w in zip(got[:-1], want[:-1]):
        assert torch.equal(g, w)
    for k in ("ids", "scores", "gaps"):
        assert torch.equal(got[-1][k], want[-1][k])
    jx = [jax_sharded[f"decode_{name}_{i}"] for i in range(3 + ad)]
    np.testing.assert_array_equal(got[0].numpy(), jx[0])
    _close(got[1].numpy(), jx[1])
    _close(got[2].numpy(), jx[2])
    if ad:
        np.testing.assert_array_equal(got[3].numpy(), jx[3])
    assert got[0].shape == (B, K) and got[0].dtype == torch.int32


@pytest.mark.parametrize("case", MIPS_CASES, ids=[c[0] for c in MIPS_CASES])
def test_mesh_mips_topk_matches_jax_and_the_serving_mesh(case, jax_sharded):
    name, shape, ba, K, prec, nv = case
    V, Q = _data()
    V2 = np.concatenate([V, V[:11]])[:300]
    kw = {k: v for k, v in _knobs(V, prec, K).items() if k != "K"}
    plan = make_plan(150, DIM, K=K, **dict(kw, delta=kw["delta"] / 2))
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    perms = torch.stack([_perm(k, plan.n_blocks) for k in keys])
    want = sharded_mips_topk(V2, Q, perms, K, mesh=Mesh(["cpu"] * 2),
                             n_valid=nv, **kw)
    with simulated_mesh(shape, device="cpu") as mesh:
        got = [_full(g) for g in sharded_mips_topk(
            torch.from_numpy(V2), torch.from_numpy(Q), perms, K, mesh=mesh,
            n_valid=nv, batch_axes=ba, **kw)]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    np.testing.assert_array_equal(got[0].numpy(),
                                  jax_sharded[f"mips_{name}_0"])
    _close(got[1].numpy(), jax_sharded[f"mips_{name}_1"])
