"""The rounding of 16-bit partial sums reduced across ranks.

The port's rule (`repro_torch.distributed.sharding.redistribute`): a
bf16 or f16 partial sum is reduced in f32 — each rank's part cast to
f32, the parts added in f32, the result cast back once.  That is what
XLA compiles the JAX package's bf16 reductions to, the ``psum`` that
the source asks for and GSPMD's partial sums alike: a convert, an f32
all-reduce, a convert.  The JAX references run here on 4 forced host
devices in one subprocess (this process keeps its one device); the
port's ranks are simulated on the CPU (`simulated_mesh`).

* The MLP's row-parallel down projection ``y = h @ w_down``, ``h (B, S,
  ff)`` split over 'ff' and ``w_down (ff, d)`` over its rows, in two
  JAX forms: ``shard_map`` of the local bf16 ``einsum`` and a ``psum``
  over 'model', and ``jax.jit`` of the whole product with
  ``NamedSharding`` inputs (GSPMD).  The port runs its model code's
  path: DTensors placed by the specs' ``w_down`` rule and the logical
  'ff' axis, the product a partial sum and `shard` to ``("batch",
  "seq", None)``.
* The expert-parallel MoE (`_moe_ep`) in bf16 against
  ``_moe_ep_shardmap``, whose ``psum`` merges the ranks' outputs.
* Data-parallel bf16 gradients, reduced by the train step's
  `_as_param`, against JAX's jitted ``grad``: a matmul weight, the
  training head's table (a bf16 operand of an f32 product, `widen`)
  and a bias (`bias_add`: each rank's bf16 chain, then f32).
* `fan_out`: a partial-sum gradient and a whole one of one input,
  summed in f32 and rounded once.
* No bf16 or f16 all-reduce or reduce-scatter is left in a bf16 train
  or decode step of the dense, moe and tied-embedding families on a
  (2, 2) mesh, with and without FSDP (`TraceCounter`).
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.distributed.sharding import (PartitionSpec, fan_out,
                                              logical_mesh, shard,
                                              shard_map_compat, spec_of)
from repro_torch.distributed.specs import (batch_pspecs, param_pspecs,
                                           place_params, place_tree)
from repro_torch.launch.comm_analysis import TraceCounter
from repro_torch.launch.mesh import simulated_mesh
from repro_torch.models import layers as TL
from repro_torch.models.model import build_model
from repro_torch.models.steps import (_as_param, decode_step, prefill_step,
                                      train_step)
from repro_torch.optim.adamw import AdamWConfig, init_opt

ROOT = Path(__file__).resolve().parent.parent
B, S, FF, D = 2, 8, 512, 128
SEEDS = (0, 1)
RANKS = 4

JAX_CASES = textwrap.dedent("""
    import dataclasses
    import sys
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import REGISTRY
    from repro.distributed.sharding import logical_mesh, shard_map_compat
    from repro.models import layers as L

    src, dst = sys.argv[1], sys.argv[2]
    a = dict(np.load(src))
    out = {}
    devs = np.array(jax.devices()[:4])
    f32 = lambda t: np.asarray(t.astype(jnp.float32))
    bf = lambda k: jnp.asarray(a[k], jnp.bfloat16)

    # the row-parallel projection: psum, GSPMD, and each rank's part
    mesh = Mesh(devs.reshape(1, 4), ("data", "model"))
    hs, ws = P(None, None, "model"), P("model", None)
    dot = lambda h, w: jnp.einsum("bsf,fd->bsd", h, w)
    psum = jax.jit(shard_map_compat(
        lambda h, w: jax.lax.psum(dot(h, w), "model"), mesh=mesh,
        in_specs=(hs, ws), out_specs=P(None, None, None)))
    parts = jax.jit(shard_map_compat(
        lambda h, w: dot(h, w)[None], mesh=mesh, in_specs=(hs, ws),
        out_specs=P("model", None, None, None)))
    gspmd = jax.jit(dot, in_shardings=(NamedSharding(mesh, hs),
                                       NamedSharding(mesh, ws)),
                    out_shardings=NamedSharding(mesh, P()))
    for i in range(int(a["n_row"])):
        h, w = bf(f"h{i}"), bf(f"w{i}")
        for name, fn in (("psum", psum), ("gspmd", gspmd),
                         ("parts", parts)):
            y = fn(h, w)
            assert y.dtype == jnp.bfloat16
            out[f"{name}{i}"] = f32(y)

    # the expert-parallel MoE, its psum over 'model'
    cfg = dataclasses.replace(
        REGISTRY["qwen3-moe-30b-a3b"].smoke(), dtype="bfloat16",
        n_experts=8, experts_per_token=4, capacity_factor=16.0)
    lp = {k: (jnp.asarray(a[k], jnp.float32) if k == "router" else bf(k))
          for k in ("router", "w_gate", "w_up", "w_down")}
    try:
        with logical_mesh(mesh):
            y = jax.jit(lambda x, p: L.moe_layer(x, p, cfg))(bf("moe_x"), lp)
        out["moe"] = f32(y)
    except Exception as e:
        out["moe_error"] = np.array(f"{type(e).__name__}: {e}"[:500])

    # data-parallel gradients: sum(f(param, x) * c), x and c over 'data'
    from repro.models.model import logits_from_hidden
    hcfg = dataclasses.replace(REGISTRY["tinyllama-1.1b"].smoke(),
                               dtype="bfloat16")
    dmesh = Mesh(devs.reshape(4, 1), ("data", "model"))
    fs = {"weight": lambda p, x: x @ p,
          "head": lambda p, x: logits_from_hidden(
              {"embed": p, "unembed": p}, hcfg, x),
          "bias": lambda p, x: x + p}
    for name, f in fs.items():
        loss = lambda p, x, c, f=f: jnp.sum(f(p, x).astype(jnp.float32) * c)
        grad = jax.jit(jax.grad(loss),
                       in_shardings=(NamedSharding(dmesh, P()),
                                     NamedSharding(dmesh, P("data")),
                                     NamedSharding(dmesh, P("data"))),
                       out_shardings=NamedSharding(dmesh, P()))
        g = grad(bf(f"{name}_p"), bf(f"{name}_x"),
                 jnp.asarray(a[f"{name}_c"]))
        assert g.dtype == jnp.bfloat16
        out[f"{name}_grad"] = f32(g)
    np.savez(dst, **out)
""")


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16, held exactly in f32."""
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(
        np.float32)


def _ulp(a: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each value of ``a`` (2^-7 of its binade)."""
    e = np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126)))
    return np.ldexp(1.0, (e - 7).astype(int))


def _f32_sum(parts) -> np.ndarray:
    """The parts added in f32 in rank order."""
    acc = np.asarray(parts[0], np.float32)
    for p in parts[1:]:
        acc = acc + np.asarray(p, np.float32)
    return acc


def _bf16_chain(parts) -> np.ndarray:
    """The parts added in bf16 in rank order, rounding after each add
    (the reduction the rule replaces)."""
    acc = parts[0]
    for p in parts[1:]:
        acc = _bf16(acc + p)
    return acc


def _moe_inputs(rng):
    """Integer weights and inputs under which every expert FFN product
    and sum is exact in both packages (as in ``test_torch_families``'s
    combine test), so that the combine's and the reduction's roundings
    are all that is left to differ."""
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b").smoke(),
                              dtype="bfloat16", n_experts=8,
                              experts_per_token=4, capacity_factor=16.0)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return cfg, {
        "router": (rng.normal(size=(d, E)) / np.sqrt(d)).astype(np.float32),
        "w_gate": np.ones((E, d, f), np.float32),
        "w_up": rng.integers(-1, 2, (E, d, f)).astype(np.float32),
        "w_down": rng.integers(-1, 2, (E, f, d)).astype(np.float32),
        "moe_x": rng.integers(1, 3, (2, 16, d)).astype(np.float32)}


def _head_config():
    """The training head's config: tinyllama's smoke (vocab 512, unpadded)
    in bf16."""
    return dataclasses.replace(get_config("tinyllama-1.1b").smoke(),
                               dtype="bfloat16")


#: the data-parallel gradient cases: (parameter, x, cotangent) shapes
DP_SHAPES = {"weight": ((128, 64), (8, 16, 128), (8, 16, 64)),
             "head": ((512, 128), (8, 16, 128), (8, 16, 512)),
             "bias": ((128,), (8, 16, 128), (8, 16, 128))}


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """The inputs and the JAX results of every case, from one subprocess
    on 4 forced host devices."""
    rng = np.random.default_rng(7)
    a = {"n_row": np.array(len(SEEDS))}
    for i, seed in enumerate(SEEDS):
        r = np.random.default_rng(seed)
        a[f"h{i}"] = _bf16(r.normal(size=(B, S, FF)))
        a[f"w{i}"] = _bf16(0.02 * r.normal(size=(FF, D)))
    cfg, moe = _moe_inputs(rng)
    a.update(moe)
    for name, (p_shape, x_shape, c_shape) in DP_SHAPES.items():
        a[f"{name}_p"] = _bf16(0.05 * rng.normal(size=p_shape))
        a[f"{name}_x"] = _bf16(rng.normal(size=x_shape))
        a[f"{name}_c"] = rng.normal(size=c_shape).astype(np.float32)
    tmp = tmp_path_factory.mktemp("sharded_bf16")
    np.savez(tmp / "in.npz", **a)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src")] + ([os.environ["PYTHONPATH"]]
                                          if os.environ.get("PYTHONPATH")
                                          else [])))
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=4")
    proc = subprocess.run(
        [sys.executable, "-c", JAX_CASES, str(tmp / "in.npz"),
         str(tmp / "out.npz")],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return a, dict(np.load(tmp / "out.npz")), cfg


def _full(y: torch.Tensor) -> np.ndarray:
    y = y.full_tensor()
    if hasattr(y, "reconcile"):
        y = y.reconcile()
    return y.float().numpy()


def _port_row_parallel(h: np.ndarray, w: np.ndarray) -> np.ndarray:
    """The model code's path: the product of placed DTensors, a partial
    sum over 'model', reduced by `shard`."""
    ht = torch.from_numpy(h).to(torch.bfloat16)
    wt = torch.from_numpy(w).to(torch.bfloat16)
    with simulated_mesh((1, RANKS), device="cpu") as mesh, \
            logical_mesh(mesh):
        placed = place_tree({"h": ht, "w_down": wt},
                            {"h": spec_of("batch", "seq", "ff"),
                             "w_down": PartitionSpec("model", None)}, mesh)
        y = shard(placed["h"] @ placed["w_down"], "batch", "seq", None)
        assert y.dtype == torch.bfloat16
        return _full(y)


def _port_reduce(parts: np.ndarray) -> np.ndarray:
    """`shard` of a partial sum over 'model' whose rank r holds
    ``parts[r]``."""
    from torch.distributed.tensor import Partial, Replicate
    stacked = torch.from_numpy(parts).to(torch.bfloat16)
    with simulated_mesh((1, RANKS), device="cpu") as mesh, \
            logical_mesh(mesh):
        st = place_tree({"p": stacked}, {"p": PartitionSpec(
            "model", None, None, None)}, mesh)["p"]
        part = shard_map_compat(lambda t: t[0], mesh=mesh,
                                in_specs=(list(st.placements),),
                                out_specs=[Replicate(), Partial()])(st)
        return _full(shard(part, "batch", "seq", None))


def _port_parts(h: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Each rank's local bf16 product, as the port computes it."""
    k = FF // RANKS
    return np.stack([
        (torch.from_numpy(h[..., r * k:(r + 1) * k]).to(torch.bfloat16)
         @ torch.from_numpy(w[r * k:(r + 1) * k]).to(torch.bfloat16))
        .float().numpy() for r in range(RANKS)])


@pytest.fixture(scope="module")
def row_parallel(cases):
    """Per seed: ``(h, w, JAX results {psum, gspmd, parts}, port's model
    path, port's parts)``."""
    a, out, _ = cases
    res = {}
    for i, seed in enumerate(SEEDS):
        h, w = a[f"h{i}"], a[f"w{i}"]
        res[seed] = (h, w, {k: out[f"{k}{i}"] for k in
                            ("psum", "gspmd", "parts")},
                     _port_row_parallel(h, w), _port_parts(h, w))
    return res


@pytest.mark.parametrize("seed", SEEDS)
def test_bf16_row_parallel_projection_bitwise_jax(seed, row_parallel):
    """Both JAX forms compile to the ranks' bf16 parts added in f32 and
    rounded once, and the port reduces alike: given JAX's parts, its
    `shard` is bitwise JAX's result.  Its model path is bitwise JAX's at
    every output whose ranks' local products round alike in the two
    packages' GEMMs.  Where one does not, each package's part is the
    exact product within its f32 accumulation's error and one bf16
    rounding: one of seed 0's 8,192 parts (rank 2's exact product lies
    7.7e-8 past a bf16 rounding midpoint, XLA's f32 sum falls short of
    it; that output is one ulp off) and one of seed 1's (a sum that
    cancels to 3.0e-6, two ulps apart; the output agrees)."""
    h, w, want, got, parts = row_parallel[seed]
    np.testing.assert_array_equal(want["gspmd"], want["psum"])
    np.testing.assert_array_equal(want["psum"],
                                  _bf16(_f32_sum(want["parts"])))
    np.testing.assert_array_equal(_port_reduce(want["parts"]), want["psum"])
    # the check can see the rounding: the result is not one device's
    # product rounded once
    one = _bf16(np.einsum("bsf,fd->bsd", h.astype(np.float64), w))
    assert (want["psum"] != one).any()
    apart = (parts != want["parts"]).any(axis=0)
    np.testing.assert_array_equal(got[~apart], want["psum"][~apart])
    assert int(apart.sum()) <= 2
    k = FF // RANKS
    for r, *i in np.argwhere(parts != want["parts"]):
        i = tuple(i)
        terms = (h[i[:2]][r * k:(r + 1) * k].astype(np.float64)
                 * w[r * k:(r + 1) * k, i[2]])
        # f32 accumulation of k terms errs by at most k 2^-24 sum|terms|
        bound = k * 2.0 ** -24 * np.abs(terms).sum()
        for part in (parts[(r, *i)], want["parts"][(r, *i)]):
            assert abs(part - terms.sum()) <= bound + _ulp(part) / 2


@pytest.mark.parametrize("seed", SEEDS)
def test_bf16_row_parallel_projection_distance_to_jax(seed, row_parallel):
    """The port is bitwise its ranks' bf16 parts added in f32 and rounded
    once; the bf16 rank-order chain it replaced differs from that in
    about a third of the outputs (by up to 2 bf16 ulps of the sum of the
    parts' magnitudes); and the port is JAX's result but where a part
    rounds apart (`test_bf16_row_parallel_projection_bitwise_jax`), one
    bf16 ulp off there."""
    h, w, want, got, parts = row_parallel[seed]
    np.testing.assert_array_equal(got, _bf16(_f32_sum(parts)))
    chain = _bf16_chain(list(parts))
    moved = np.abs(chain.astype(np.float64) - got)
    assert (moved <= 2 * _ulp(np.abs(parts).sum(axis=0))).all()
    assert 0.1 < float((moved > 0).mean()) < 0.5
    diff = np.abs(got.astype(np.float64) - want["psum"])
    assert (diff <= _ulp(want["psum"])).all()
    assert int((diff > 0).sum()) <= int(
        (parts != want["parts"]).any(axis=0).sum())


def test_bf16_expert_parallel_moe_bitwise_jax(cases):
    """`_moe_ep` in bf16 on a simulated (1, 4) mesh against the JAX
    package's ``_moe_ep_shardmap`` on 4 forced host devices: bitwise,
    and bitwise the port's per-rank outputs (`_moe_rows` over each
    rank's experts) added in f32 and rounded once, which the bf16 chain
    is not."""
    a, out, cfg = cases
    if "moe_error" in out:
        pytest.skip(f"_moe_ep_shardmap raises on this jax: "
                    f"{out['moe_error']}")
    bf = {k: torch.from_numpy(a[k]).to(torch.float32 if k == "router"
                                       else torch.bfloat16)
          for k in ("router", "w_gate", "w_up", "w_down", "moe_x")}
    x = bf.pop("moe_x")
    with simulated_mesh((1, RANKS), device="cpu") as mesh, \
            logical_mesh(mesh):
        specs = {"x": spec_of("batch", "seq", None),
                 "router": PartitionSpec(None, None),
                 **{k: PartitionSpec("model", None, None)
                    for k in ("w_gate", "w_up", "w_down")}}
        placed = place_tree({"x": x, **bf}, specs, mesh)
        y = TL.moe_layer(placed.pop("x"), placed, cfg)
        assert y.dtype == torch.bfloat16
        got = _full(y)
    np.testing.assert_array_equal(got, out["moe"])
    E_loc = cfg.n_experts // RANKS
    T = x.shape[0] * x.shape[1]
    cap = min(max(8, int(-(-T * cfg.experts_per_token
                           * cfg.capacity_factor // cfg.n_experts))),
              T * cfg.experts_per_token)
    parts = [TL._moe_rows(
        x.reshape(1, T, -1), bf["router"],
        *(bf[k][r * E_loc:(r + 1) * E_loc] for k in ("w_gate", "w_up",
                                                       "w_down")),
        cfg, cap, e_lo=torch.tensor(r * E_loc)).reshape(x.shape)
        .float().numpy() for r in range(RANKS)]
    np.testing.assert_array_equal(got, _bf16(_f32_sum(parts)))
    assert (_bf16_chain(parts) != got).any()


def _dp_f(name):
    """The port's ``f(param, x)`` of a data-parallel gradient case, in f32:
    a matmul weight, the training head's table (`logits_from_hidden`),
    a bias (the attention's ``q + bq``, `bias_add`)."""
    from types import SimpleNamespace
    from repro_torch.models.model import logits_from_hidden
    if name == "head":
        return lambda p, x: logits_from_hidden(SimpleNamespace(
            head_table=p), _head_config(), x)
    if name == "bias":
        return lambda p, x: TL.bias_add(x, p).float()
    return lambda p, x: (x @ p).float()


@pytest.mark.parametrize("name", list(DP_SHAPES))
def test_bf16_data_parallel_gradient_matches_jax_grad(name, cases):
    """A bf16 parameter's gradient over 4 'data' ranks, ``sum(f(param, x)
    * c)``, against JAX's jitted ``grad``.  Both reduce the ranks' parts
    in f32 and round once (the port in `_as_param`); the parts differ by
    kind.

    * weight: XLA rounds each rank's GEMM output to bf16, as autograd
      does; the port is JAX's but where a part rounds apart in the two
      GEMMs, by one ulp (measured: bitwise, none of the 8,192 outputs).
    * head (a bf16 operand of an f32 product): XLA reduces the f32 GEMM
      output unrounded, and so does the port (`widen`): bitwise JAX's,
      where parts rounded to bf16 first are not (measured: 26,345 of
      the 65,536 outputs apart).
    * bias: XLA's CPU program sums each rank's bf16 cotangent with a
      bf16 add, one rounding each (32 rows a rank: a chain in row-major
      order), then all-reduces in f32; so does the port (`bias_add`:
      `chain_sum` on each rank's rows, then `_as_param`'s f32
      reduction): bitwise JAX's, where each rank's sum taken in f32 and
      rounded once, autograd's, was 104 of the 128 outputs apart
      (ROADMAP 3.5, closed)."""
    a, out, _ = cases
    p = torch.from_numpy(a[f"{name}_p"]).to(torch.bfloat16)
    x = torch.from_numpy(a[f"{name}_x"]).to(torch.bfloat16)
    c = torch.from_numpy(a[f"{name}_c"])
    f = _dp_f(name)
    with simulated_mesh((RANKS, 1), device="cpu") as mesh, \
            logical_mesh(mesh):
        spec = PartitionSpec("data", None, None)
        placed = place_tree({"p": p, "x": x, "c": c},
                            {"p": PartitionSpec(*[None] * p.dim()),
                             "x": spec, "c": spec}, mesh)
        pp = placed["p"].requires_grad_(True)
        g = torch.autograd.grad((f(pp, placed["x"]) * placed["c"]).sum(),
                                [pp])[0]
        g = _as_param(g, pp)
        assert g.dtype == torch.bfloat16
        got = _full(g)
    n = x.shape[0] // RANKS
    rows = [slice(r * n, (r + 1) * n) for r in range(RANKS)]

    def parts(dtype):
        out = []
        for rr in rows:
            pr = p.to(dtype).requires_grad_(True)
            out.append(torch.autograd.grad(
                (f(pr, x[rr]) * c[rr]).sum(), [pr])[0].float().numpy())
        return out

    want = out[f"{name}_grad"]
    if name == "head":
        np.testing.assert_array_equal(got, _bf16(_f32_sum(parts(
            torch.float32))))
        np.testing.assert_array_equal(got, want)
        assert (_bf16(_f32_sum(parts(torch.bfloat16))) != want).any()
        return
    mine = parts(torch.bfloat16)
    np.testing.assert_array_equal(got, _bf16(_f32_sum(mine)))
    diff = np.abs(got.astype(np.float64) - want)
    if name == "weight":
        assert (diff <= _ulp(np.abs(np.stack(mine)).sum(axis=0))).all()
        assert float((diff > 0).mean()) < 0.02
        return
    cb = _bf16(c.numpy())
    chains = [_bf16_chain(list(cb[rr].reshape(-1, cb.shape[-1])))
              for rr in rows]
    np.testing.assert_array_equal(want, _bf16(_f32_sum(chains)))
    np.testing.assert_array_equal(got, want)
    # the check can see the rounding: each rank's rows summed in f32 and
    # rounded once are not JAX's result
    once = [_bf16(cb[rr].reshape(-1, cb.shape[-1]).astype(np.float64)
                  .sum(axis=0)) for rr in rows]
    assert (_bf16(_f32_sum(once)) != want).any()


def test_fan_out_sums_partial_and_whole_gradients_in_f32():
    """`fan_out`: one bf16 input of a product whose weight is split by
    columns over 'model' (its gradient a partial sum) and of one whose
    weight is whole (its gradient whole), as a query projection beside
    replicated key heads.  The input's gradient is the ranks' bf16 parts
    summed in f32, plus the whole one in f32, rounded once; its one
    reduction is an f32 all-reduce (DTensor alone may add the two by
    reducing the partial sum in bf16 first)."""
    rng = np.random.default_rng(3)
    a = {"x": _bf16(rng.normal(size=(2, 8, 64))),
         "wq": _bf16(0.1 * rng.normal(size=(64, 32))),
         "wk": _bf16(0.1 * rng.normal(size=(64, 16))),
         "cq": _bf16(rng.normal(size=(2, 8, 32))),
         "ck": _bf16(rng.normal(size=(2, 8, 16)))}
    t = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in a.items()}
    whole = PartitionSpec(None, None, None)
    with simulated_mesh((1, RANKS), device="cpu") as mesh, \
            logical_mesh(mesh):
        placed = place_tree(t, {"x": whole, "wq": PartitionSpec(None,
                                                                "model"),
                                "wk": PartitionSpec(None, None),
                                "cq": PartitionSpec(None, None, "model"),
                                "ck": whole}, mesh)
        x = placed["x"].requires_grad_(True)
        xq, xk = fan_out(x, 2)
        with TraceCounter() as tc:
            (g,) = torch.autograd.grad(
                [xq @ placed["wq"], xk @ placed["wk"]], [x],
                grad_outputs=[placed["cq"], placed["ck"]])
        assert g.dtype == torch.bfloat16
        got = _full(g)
    k = a["wq"].shape[1] // RANKS
    parts = [(t["cq"][..., r * k:(r + 1) * k]
              @ t["wq"][:, r * k:(r + 1) * k].T).float().numpy()
             for r in range(RANKS)]
    from_k = (t["ck"] @ t["wk"].T).float().numpy()
    np.testing.assert_array_equal(got, _bf16(_f32_sum(parts) + from_k))
    assert [k for k, _ in tc.collectives] == ["all-reduce"]
    assert tc.collectives[0][1].startswith("f32[")


@pytest.mark.parametrize("fsdp", [False, True], ids=["dp", "fsdp"])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-moe-30b-a3b",
                                  "qwen1.5-0.5b"])
def test_no_16_bit_reduction_in_a_bf16_step(arch, fsdp):
    """A bf16 smoke train step and decode step on a simulated (2, 2) mesh
    (the moe's experts on 'model', expert parallel; qwen1.5's embedding
    tied to its head, whose gradient meets the lookup's) make no
    all-reduce or reduce-scatter of a bf16 or f16 shape, with and
    without FSDP (the weights split over 'data' too, gathered inside
    `shard_map_compat` and their gradients reduce-scattered): every
    partial sum of theirs is reduced in f32."""
    cfg = dataclasses.replace(get_config(arch).smoke(), n_layers=1,
                              dtype="bfloat16", capacity_factor=16.0)
    model = build_model(cfg, device="cpu")
    g = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab, (4, 16), generator=g,
                              dtype=torch.int32)
             for k in ("tokens", "labels")}
    with simulated_mesh((2, 2), device="cpu") as mesh, logical_mesh(mesh):
        place_params(model, param_pspecs(
            cfg, dict(model.named_parameters()), mesh, fsdp=fsdp), mesh)
        b = place_tree(batch, batch_pspecs(mesh, 4, batch), mesh)
        opt = init_opt(dict(model.named_parameters()))
        with TraceCounter() as tc:
            train_step(model, opt, b, cfg, AdamWConfig())
            with torch.no_grad():
                _, caches = prefill_step(model, b["tokens"][:, :8], 16)
                decode_step(model, dataclasses.replace(cfg,
                                                       mips_mode="exact"),
                            caches, b["tokens"][:, 8:9], 8)
    reductions = [(k, s) for k, s in tc.collectives
                  if k in ("all-reduce", "reduce-scatter")]
    assert any(s.startswith("f32[") for _, s in reductions)
    assert not [r for r in reductions
                if r[1].startswith(("bf16[", "f16["))], reductions
