"""The port's dense model against the JAX package's, on the same weights.

Inputs are drawn with numpy from fixed seeds; weights reach the port
through `repro_torch.convert.params_from_jax` (or `tensor_from_jax` for
one layer's parameters), so both packages compute on the same values.

Tolerances:

* float32: rtol 1e-5 with atol 1e-5 * max|out| — both packages take
  the same f32 operations, but sums (matmuls, the RMS mean, softmax) run
  in another order and XLA fuses some of them;
* bfloat16: the outputs are bf16, which both packages round from f32
  intermediates that differ in the last f32 bits (a bf16 matmul's sums
  run in another order); one such difference flips one bf16 rounding, so
  a result agrees to one bf16 step (rtol 2^-7), and a flipped
  intermediate that feeds a product moves results by a step of the
  operands' scale, not of the result's (atol 2^-8 * max|out|);
* whole smoke models (f32): rtol 1e-4 with atol 1e-4 * max|out| —
  the per-layer differences above, carried through 2 to 4 layers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as JL
from repro.models.model import forward as jax_forward
from repro.models.model import init_params
from repro.models.model import logits_from_hidden as jax_logits
from repro.models.steps import prefill_step as jax_prefill
from repro_torch.configs import REGISTRY, get_config
from repro_torch.convert import params_from_jax, tensor_from_jax
from repro_torch.models import layers as TL
from repro_torch.models.model import DenseLM, masked_logits
from repro_torch.models.steps import prefill_step

ARCHS = ["qwen1.5-0.5b", "tinyllama-1.1b", "qwen2.5-3b"]
DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}


def _close(got: torch.Tensor, want, dtype: str, model: bool = False):
    a = got.float().numpy()
    b = np.asarray(want).astype(np.float32)
    assert a.shape == b.shape
    if dtype == "bfloat16":
        np.testing.assert_allclose(a, b, rtol=2 ** -7,
                                   atol=2 ** -8 * float(np.abs(b).max()))
    else:
        tol = 1e-4 if model else 1e-5
        np.testing.assert_allclose(a, b, rtol=tol,
                                   atol=tol * float(np.abs(b).max()))


def _both(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a.astype(DTYPES[dtype]))
    return j, tensor_from_jax(np.asarray(j))


def _layer_params(cfg, dtype: str, seed: int):
    """One dense layer's parameters (random biases) in both packages."""
    rng = np.random.default_rng(seed)
    d, H, KV, D, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                      cfg.head_dim, cfg.d_ff)
    shapes = {"wq": (d, H * D), "wk": (d, KV * D), "wv": (d, KV * D),
              "wo": (H * D, d), "w_gate": (d, f), "w_up": (d, f),
              "w_down": (f, d), "bq": (H * D,), "bk": (KV * D,),
              "bv": (KV * D,)}
    jp, tp = {}, {}
    for name, shape in shapes.items():
        a = rng.normal(size=shape).astype(np.float32) / np.sqrt(shape[0])
        jp[name], tp[name] = _both(a, dtype)
    return jp, tp


def _cfg(arch: str, dtype: str):
    return (dataclasses.replace(jax_get_config(arch).smoke(), dtype=dtype),
            dataclasses.replace(get_config(arch).smoke(), dtype=dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rms_norm_and_rope_match_jax(dtype):
    rng = np.random.default_rng(0)
    jx, tx = _both(rng.normal(size=(2, 5, 64)).astype(np.float32), dtype)
    w = rng.normal(size=(64,)).astype(np.float32)
    got = TL.rms_norm(tx, torch.from_numpy(w))
    assert got.dtype == tx.dtype
    _close(got, JL.rms_norm(jx, jnp.asarray(w)), dtype)
    jq, tq = _both(rng.normal(size=(2, 5, 4, 32)).astype(np.float32), dtype)
    pos = np.arange(5)[None].repeat(2, 0) + np.array([[3], [11]])
    for theta in (10_000.0, 1_000_000.0):
        got = TL.rope(tq, torch.from_numpy(pos), theta)
        assert got.dtype == tq.dtype
        _close(got, JL.rope(jq, jnp.asarray(pos), theta), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("Sq,Sk,causal,q_offset,chunk,branch", [
    (6, 6, True, 0, 512, "one chunk"),
    (6, 6, True, 0, 4, "one chunk (ragged)"),
    (8, 8, True, 0, 4, "static causal chunks"),
    (8, 8, False, 0, 4, "mapped chunks"),
    (8, 11, True, 3, 4, "mapped chunks, offset"),
    (1, 9, True, 5, 512, "decode row over a cache tail")])
def test_sdpa_chunked_branches_match_jax(dtype, Sq, Sk, causal, q_offset,
                                         chunk, branch):
    rng = np.random.default_rng(Sq * 31 + Sk)
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(rng.normal(size=(2, S, H, 32)).astype(np.float32), dtype)
        for S, H in ((Sq, 4), (Sk, 2), (Sk, 2)))
    got = TL._sdpa_chunked(tq, tk, tv, causal, q_offset, chunk)
    want = JL._sdpa_chunked(jq, jk, jv, causal, q_offset, chunk)
    assert got.dtype == tq.dtype, branch
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_attention_prefill_decode_and_mlp_match_jax(dtype, arch):
    jcfg, cfg = _cfg(arch, dtype)
    jp, tp = _layer_params(cfg, dtype, seed=1)
    rng = np.random.default_rng(2)
    B, S, cache_len = 2, 5, 9
    jx, tx = _both(rng.normal(size=(B, S, cfg.d_model)).astype(np.float32),
                   dtype)
    pos = np.arange(S)[None].repeat(B, 0)
    y_j, cache_j = JL.attention(jx, jp, jcfg, positions=jnp.asarray(pos),
                                cache_len=cache_len)
    y_t, cache_t = TL.attention(tx, tp, cfg, positions=torch.from_numpy(pos),
                                cache_len=cache_len)
    _close(y_t, y_j, dtype)
    for name in ("k", "v"):
        _close(cache_t[name], cache_j[name], dtype)
    # train mode: no cache
    y_j, _ = JL.attention(jx, jp, jcfg, positions=jnp.asarray(pos))
    y_t, none = TL.attention(tx, tp, cfg, positions=torch.from_numpy(pos))
    assert none is None
    _close(y_t, y_j, dtype)
    # two decode steps: the cache is written in place at pos
    for step in range(2):
        p = S + step
        jx1, tx1 = _both(rng.normal(size=(B, 1, cfg.d_model)).astype(
            np.float32), dtype)
        pp = np.full((B, 1), p)
        y_j, cache_j = JL.attention(jx1, jp, jcfg, positions=jnp.asarray(pp),
                                    cache=cache_j, pos=p)
        k_before = cache_t["k"]
        y_t, cache_t = TL.attention(tx1, tp, cfg,
                                    positions=torch.from_numpy(pp),
                                    cache=cache_t, pos=p)
        assert cache_t["k"] is k_before
        _close(y_t, y_j, dtype)
        for name in ("k", "v"):
            _close(cache_t[name], cache_j[name], dtype)
    got = TL.mlp(tx, tp, cfg)
    assert got.dtype == tx.dtype
    _close(got, JL.mlp(jx, jp, jcfg), dtype)


def _jax_model(arch: str, seed: int = 0):
    jcfg = jax_get_config(arch).smoke()
    params = init_params(jcfg, jax.random.PRNGKey(seed))
    model = params_from_jax(jax.tree.map(np.asarray, params),
                            get_config(arch).smoke(), device="cpu")
    return jcfg, params, model


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_logits_match_jax(arch):
    """MHA + QKV bias + tied (qwen1.5), GQA + untied (tinyllama), GQA +
    bias + rope_theta 1e6 (qwen2.5) smoke models on the JAX weights."""
    jcfg, params, model = _jax_model(arch)
    rng = np.random.default_rng(3)
    tok = rng.integers(0, jcfg.vocab, (2, 9))
    h_j, _ = jax_forward(params, jcfg, jnp.asarray(tok))
    h_t, none = model(torch.from_numpy(tok))
    assert none is None
    _close(h_t, h_j, "float32", model=True)
    last_j, caches_j = jax_prefill(params, jcfg, jnp.asarray(tok),
                                   cache_len=12)
    last_t, caches_t = prefill_step(model, torch.from_numpy(tok), 12)
    _close(last_t, last_j, "float32", model=True)
    assert len(caches_t) == jcfg.n_layers
    for i, c in enumerate(caches_t):
        for name in ("k", "v"):
            assert c[name].shape == caches_j[name][i].shape
            _close(c[name], caches_j[name][i], "float32", model=True)
    logits = masked_logits(model.cfg, model.head_table, last_t)
    want = np.asarray(jax_logits(params, jcfg, last_j[:, None]))[:, 0]
    np.testing.assert_array_equal(logits[:, jcfg.vocab:].numpy(),
                                  want[:, jcfg.vocab:])
    _close(logits[:, :jcfg.vocab], want[:, :jcfg.vocab], "float32",
           model=True)


def test_params_from_jax_keeps_types_and_checks_names():
    jcfg = dataclasses.replace(jax_get_config("tinyllama-1.1b").smoke(),
                               dtype="bfloat16")
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").smoke(),
                              dtype="bfloat16")
    params = jax.tree.map(np.asarray, init_params(jcfg,
                                                  jax.random.PRNGKey(1)))
    model = params_from_jax(params, cfg, device="cpu")
    assert model.embed.dtype == model.unembed.dtype == torch.bfloat16
    assert model.final_w.dtype == model.layers[0].ln1_w.dtype == \
        torch.float32
    np.testing.assert_array_equal(
        model.layers[1].w_up.float().numpy(),
        params["layers"]["w_up"][1].astype(np.float32))
    broken = dict(params, layers=dict(params["layers"]))
    del broken["layers"]["w_up"]
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(broken, cfg, device="cpu")
    with pytest.raises(ValueError, match="model has"):
        params_from_jax(params, dataclasses.replace(cfg, dtype="float32"),
                        device="cpu")


def test_dense_lm_init_shapes_scales_and_refusals():
    cfg = dataclasses.replace(get_config("qwen2.5-3b").smoke(),
                              dtype="bfloat16")
    a, b = (DenseLM(cfg, seed=5, device="cpu"),
            DenseLM(cfg, seed=5, device="cpu"))
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))
    jparams = init_params(dataclasses.replace(
        jax_get_config("qwen2.5-3b").smoke(), dtype="bfloat16"),
        jax.random.PRNGKey(0))
    for name, t in a.named_parameters():
        ref = (jparams[name] if "." not in name
               else jparams["layers"][name.split(".")[-1]][0])
        assert tuple(t.shape) == ref.shape and str(t.dtype)[6:] == str(
            ref.dtype), name
    assert abs(float(a.embed.float().std()) - 0.02) < 2e-3
    wq = a.layers[0].wq.float()
    assert abs(float(wq.std()) * np.sqrt(cfg.d_model) - 1.0) < 0.05
    # the other families are ported: every arch is registered, the moe
    # family builds on the dense class with the MoE FFN (f32 router),
    # and the ln norm is a layer norm with its bias
    assert set(ARCHS) < set(REGISTRY) and len(REGISTRY) == 10
    moe = DenseLM(dataclasses.replace(cfg, family="moe", n_experts=4,
                                      experts_per_token=2), device="cpu")
    assert moe.layers[0].router.dtype == torch.float32
    assert moe.layers[0].w_gate.shape == (4, cfg.d_model, cfg.d_ff)
    x = torch.arange(16, dtype=torch.float32).reshape(2, 8)
    ln = TL.norm(x, {"ln1_w": torch.ones(8), "ln1_b": torch.full((8,), 2.)},
                 dataclasses.replace(cfg, norm="ln"), "ln1")
    assert torch.allclose(ln.mean(-1), torch.full((2,), 2.0))
