"""The port's AdamW (`repro_torch.optim.adamw`) against the JAX package's,
on the same numpy trees.

Parameters come from the JAX package's ``init_params`` of a smoke
config, through `repro_torch.convert.params_from_jax`; gradients are
numpy draws from fixed seeds, unstacked under the port's names; results
return to the JAX layout through `repro_torch.convert.to_jax_tree`.

Tolerances:

* the schedule and the bias corrections: rtol 1e-6 — both compute the
  same f32 ops, but ``cos`` and ``pow`` of the two libraries may differ
  in the last ulp;
* ``global_norm``: rtol 1e-5 — the JAX package sums squares per JAX
  leaf (a whole layer stack), the port per layer tensor, and each
  library adds a tensor's squares in its own order: f32 sums of some
  10^5 positive terms, 1.9e-6 apart on bf16 gradients;
* ``compress_grads``: bitwise (one f32 add and one round to bf16);
* ``apply_updates``, f32 parameters and moments: rtol 1e-5 with atol
  1e-6 * max|x| — the ulps above move the clip scale, the learning rate
  and the bias corrections, and through ``sqrt`` and a division each
  element's update; bf16 moments and parameters: rtol 2^-7 with atol
  2^-8 * max|x|, one bf16 step where those ulps flip a rounding.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.model import init_params
from repro.optim import adamw as JA
from repro_torch.configs import get_config
from repro_torch.convert import (_port_params, _stacks, opt_state_from_jax,
                                 params_from_jax, to_jax_tree)
from repro_torch.optim import adamw as TA


def _close(got, want, bf16: bool = False):
    a = np.asarray(got, np.float32)
    b = np.asarray(want).astype(np.float32)
    assert a.shape == b.shape
    scale = float(np.abs(b).max()) if b.size else 0.0
    if bf16:
        np.testing.assert_allclose(a, b, rtol=2 ** -7, atol=2 ** -8 * scale)
    else:
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6 * scale)


def _tree_close(got: dict, want, bf16: bool = False):
    """``got`` (`to_jax_tree`) leaf for leaf against the JAX tree."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for p in path:
            node = node[p.key]
        _close(node, leaf, bf16)


def _setup(arch: str, dtype: str = "float32", seed: int = 0):
    """``(JAX params, port model, port params dict)`` of ``arch``'s smoke
    config in ``dtype``."""
    jcfg = dataclasses.replace(jax_get_config(arch).smoke(), dtype=dtype)
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype=dtype)
    params = init_params(jcfg, jax.random.PRNGKey(seed))
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    return params, model, dict(model.named_parameters())


def _grads(params, seed: int):
    """Random gradients shaped as ``params``: ``(JAX tree, port dict)``."""
    rng = np.random.default_rng(seed)
    jg = jax.tree.map(
        lambda p: jnp.asarray(rng.normal(size=p.shape) * 0.1, p.dtype),
        params)
    return jg, {k: v for k, v in _port_params(jax.tree.map(np.asarray, jg))}


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 40), (3, 16)])
def test_cosine_schedule_matches_jax(warmup, total):
    jc = JA.AdamWConfig(lr=1e-3, warmup_steps=warmup, total_steps=total)
    tc = TA.AdamWConfig(lr=1e-3, warmup_steps=warmup, total_steps=total)
    steps = np.arange(total + 20, dtype=np.int32)
    want = np.array([float(JA.cosine_schedule(jc, jnp.int32(s)))
                     for s in steps])
    got = TA.cosine_schedule(tc, torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_global_norm_matches_jax():
    params, _, tparams = _setup("jamba-v0.1-52b")
    jg, tg = _grads(params, 3)
    got = TA.global_norm(tg)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(JA.global_norm(jg)),
                               rtol=1e-5)


def test_compress_grads_is_bitwise_the_jax_packages():
    rng = np.random.default_rng(4)
    g = {"a": rng.normal(size=(7, 33)).astype(np.float32),
         "b": (rng.normal(size=(65,)) * 1e-3).astype(np.float32)}
    err = {k: (rng.normal(size=v.shape) * 1e-6).astype(np.float32)
           for k, v in g.items()}
    jc, je = JA.compress_grads(jax.tree.map(jnp.asarray, g),
                               jax.tree.map(jnp.asarray, err))
    tc, te = TA.compress_grads({k: torch.from_numpy(v) for k, v in g.items()},
                               {k: torch.from_numpy(v)
                                for k, v in err.items()})
    for k in g:
        assert tc[k].dtype == te[k].dtype == torch.float32
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))
        np.testing.assert_array_equal(te[k].numpy(), np.asarray(je[k]))
    same, err2 = TA.compress_grads({"a": torch.ones(3)},
                                   {"a": torch.zeros(3)}, enabled=False)
    assert torch.equal(same["a"], torch.ones(3))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-moe-30b-a3b",
                                  "jamba-v0.1-52b", "whisper-medium"])
def test_jax_rank_is_the_jax_leafs_rank(arch):
    """`jax_rank` of each port parameter is the rank of the JAX leaf it
    is a slice of."""
    params, _, tparams = _setup(arch)
    n = 0
    for _, pattern, leaf in _stacks(params):
        lead = pattern.count("{}")
        for idx in np.ndindex(*leaf.shape[:lead]):
            name = pattern.format(*idx)
            assert TA.jax_rank(name, tparams[name]) == leaf.ndim, name
            n += 1
    assert n == len(tparams)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_init_opt_matches_jax(moments):
    params, _, tparams = _setup("qwen1.5-0.5b")
    js = JA.init_opt(params, moments_dtype=jnp.dtype(moments))
    ts = TA.init_opt(tparams, moments_dtype=getattr(torch, moments))
    assert ts.step.dtype == torch.int32 and int(ts.step) == 0
    assert ts.mu is not ts.nu
    for tree, jtree in ((ts.mu, js.mu), (ts.nu, js.nu), (ts.err, js.err)):
        assert set(tree) == set(tparams)
        for name, t in tree.items():
            assert t.shape == tparams[name].shape and not t.any()
        jdt = jax.tree.leaves(jtree)[0].dtype
        assert {t.dtype for t in tree.values()} == {
            torch.bfloat16 if jdt == jnp.bfloat16 else torch.float32}
    assert TA.init_opt(tparams, with_err=False).err is None


@pytest.mark.parametrize("arch,dtype,moments", [
    ("tinyllama-1.1b", "float32", "float32"),
    ("tinyllama-1.1b", "float32", "bfloat16"),
    ("qwen1.5-0.5b", "bfloat16", "float32"),
    ("jamba-v0.1-52b", "float32", "float32"),
    ("jamba-v0.1-52b", "bfloat16", "bfloat16")])
def test_apply_updates_matches_jax(arch, dtype, moments):
    """Three AdamW steps on the same gradients: parameters, moments, the
    step, ``grad_norm`` and ``lr``; the parameters and moments written in
    place."""
    params, model, tparams = _setup(arch, dtype)
    jc = JA.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    tc = TA.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    js = JA.init_opt(params, moments_dtype=jnp.dtype(moments))
    ts = opt_state_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    before = {k: v.data_ptr() for k, v in tparams.items()}
    bf16 = "bfloat16" in (dtype, moments)
    for i in range(3):
        jg, tg = _grads(params, 10 + i)
        params, js, jm = JA.apply_updates(params, jg, js, jc)
        out, ts, tm = TA.apply_updates(tparams, tg, ts, tc)
        assert out is tparams and int(ts.step) == int(js.step) == i + 1
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        like = jax.tree.map(np.asarray, params)
        _tree_close(to_jax_tree(tparams, like), params, bf16)
        _tree_close(to_jax_tree(ts.mu, like), js.mu, bf16)
        _tree_close(to_jax_tree(ts.nu, like), js.nu, bf16)
    assert {k: v.data_ptr() for k, v in model.named_parameters()} == before


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "jamba-v0.1-52b"])
def test_weight_decay_follows_the_jax_leafs_rank(arch, monkeypatch):
    """One step with weight decay 0.1: every rank-1 parameter the JAX
    package stacks (norm weights, biases, Mamba vectors) is decayed as
    JAX decays it; ``final_w`` is not.  A rule on the port tensor's own
    rank (``ndim >= 2``) misses them, and fails this comparison."""
    jc = JA.AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=10,
                        weight_decay=0.1)
    tc = TA.AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=10,
                        weight_decay=0.1)

    def one_step(rank_rule=None):
        params, _, tparams = _setup(arch)
        if rank_rule is not None:
            monkeypatch.setattr(TA, "jax_rank", rank_rule)
        jg, tg = _grads(params, 21)
        js = JA.init_opt(params)
        jp, _, _ = JA.apply_updates(params, jg, js, jc)
        TA.apply_updates(tparams, tg, TA.init_opt(tparams), tc)
        return jp, tparams

    jp, tparams = one_step()
    vectors = [n for n, t in tparams.items()
               if t.dim() == 1 and TA.jax_rank(n, t) >= 2]
    assert any(n.endswith("ln1_w") for n in vectors)
    if arch == "qwen1.5-0.5b":
        assert any(n.endswith(".bq") for n in vectors)
    else:
        assert any(n.endswith(".D") for n in vectors)
    got = to_jax_tree(tparams, jax.tree.map(np.asarray, jp))
    _tree_close(got, jp)           # final_w too: decayed it would be 1e-3 off

    jp, naive = one_step(lambda name, t: t.dim())
    got = to_jax_tree(naive, jax.tree.map(np.asarray, jp))
    with pytest.raises(AssertionError):
        _tree_close(got, jp)
    # the norm weights of one are off by the decay, lr * wd = 1e-3
    ln = got["layers"]["ln1_w"] if "layers" in got \
        else got["periods"]["norms"]["ln1_w"]
    want = np.asarray(jp["layers"]["ln1_w"] if "layers" in jp
                      else jp["periods"]["norms"]["ln1_w"])
    np.testing.assert_allclose(ln - want, 1e-3, rtol=1e-3)


def test_opt_state_from_jax_unstacks_the_moments():
    params, _, tparams = _setup("jamba-v0.1-52b")
    js = JA.init_opt(params, moments_dtype=jnp.bfloat16)
    js = js._replace(step=jnp.int32(5), mu=jax.tree.map(
        lambda p: jnp.full(p.shape, 0.5, jnp.bfloat16), params))
    ts = opt_state_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    assert int(ts.step) == 5 and ts.step.dtype == torch.int32
    assert set(ts.mu) == set(ts.nu) == set(ts.err) == set(tparams)
    assert ts.mu["periods.1.moe.0.w_up"].dtype == torch.bfloat16
    assert bool((ts.mu["periods.1.moe.0.w_up"] == 0.5).all())
    assert ts.err["embed"].dtype == torch.float32
    assert opt_state_from_jax(
        jax.tree.map(np.asarray, JA.init_opt(params, with_err=False)),
        device="cpu"
    ).err is None


def test_adamw_minimizes_a_quadratic_and_clips():
    """The JAX package's optimizer tests, in the port."""
    target = torch.from_numpy(
        np.random.default_rng(0).normal(size=(16,)).astype(np.float32))
    params = {"w": torch.zeros(16)}
    cfg = TA.AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=1,
                         total_steps=400)
    opt = TA.init_opt(params)
    loss0 = None
    for _ in range(300):
        params, opt, _ = TA.apply_updates(params, {"w": params["w"] - target},
                                          opt, cfg)
        if loss0 is None:
            loss0 = float(((params["w"] - target) ** 2).sum())
    assert float(((params["w"] - target) ** 2).sum()) < loss0 * 1e-3
    params = {"w": torch.zeros(4)}
    cfg = TA.AdamWConfig(lr=1.0, clip_norm=1e-3, weight_decay=0.0,
                         warmup_steps=0)
    _, _, m = TA.apply_updates(params, {"w": torch.full((4,), 1e6)},
                               TA.init_opt(params), cfg)
    assert float(m["grad_norm"]) > 1e5
    assert float(params["w"].abs().max()) < 10.0
