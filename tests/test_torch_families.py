"""The port's moe, ssm, hybrid, encdec and vlm families (and command-r)
against the JAX package's, on the same weights.

Inputs are drawn with numpy from fixed seeds; weights reach the port
through `repro_torch.convert.params_from_jax` (or `tensor_from_jax` for
one layer's parameters), so both packages compute on the same values.

Tolerances (those of ``tests/test_torch_models.py``):

* float32: rtol 1e-5 with atol 1e-5 * max|out| — both packages take
  the same f32 operations, but sums (matmuls, the norms' means, softmax,
  the SSD scan's einsums and cumsum) run in another order and XLA fuses
  some of them; ``softplus`` is ``logaddexp(x, 0)`` in both;
* bfloat16: rtol 2^-7 with atol 2^-8 * max|out| — one flipped bf16
  rounding of an intermediate (a bf16 matmul's sums run in another
  order) moves a result by one bf16 step of the operands' scale;
* whole smoke models (f32): rtol 1e-4 with atol 1e-4 * max|out| — the
  per-layer differences above, carried through 2 to 4 layers (8 for the
  hybrid's two periods).

The MoE routing (top-k, capacity ranks, drops) is compared exactly: the
router's f32 logits of the same operands leave no near-tie in these
draws, so both packages route every token alike.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JAX_REGISTRY
from repro.configs import get_config as jax_get_config
from repro.models import layers as JL
from repro.models.model import forward as jax_forward
from repro.models.model import init_params
from repro.models.steps import prefill_step as jax_prefill
from repro_torch.configs import REGISTRY, get_config
from repro_torch.convert import (_port_params, params_from_jax,
                                 tensor_from_jax)
from repro_torch.models import layers as TL
from repro_torch.models.model import (DenseLM, EncDecLM, HybridLM, MambaLM,
                                      build_model)
from repro_torch.models.steps import prefill_step

NEW_ARCHS = ["qwen3-moe-30b-a3b", "grok-1-314b", "mamba2-130m",
             "jamba-v0.1-52b", "whisper-medium", "internvl2-26b",
             "command-r-35b"]
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
    j = jnp.asarray(np.asarray(a, np.float32).astype(DTYPES[dtype]))
    return j, tensor_from_jax(np.asarray(j))


def _cfgs(arch: str, dtype: str = "float32", **kw):
    return (dataclasses.replace(jax_get_config(arch).smoke(), dtype=dtype,
                                **kw),
            dataclasses.replace(get_config(arch).smoke(), dtype=dtype, **kw))


def _params(rng, shapes: dict, dtype: str, f32=()):
    """Random parameters of ``shapes`` (scaled by the first dim) in both
    packages, ``dtype`` but the names in ``f32``."""
    jp, tp = {}, {}
    for name, shape in shapes.items():
        a = rng.normal(size=shape) / np.sqrt(shape[-2] if len(shape) > 1
                                             else 1)
        jp[name], tp[name] = _both(a, "float32" if name in f32 else dtype)
    return jp, tp


def test_registry_and_smoke_configs_equal_the_jax_packages():
    assert sorted(REGISTRY) == sorted(JAX_REGISTRY)
    for name, cfg in REGISTRY.items():
        jcfg = JAX_REGISTRY[name]
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg), name
        assert dataclasses.asdict(cfg.smoke()) == \
            dataclasses.asdict(jcfg.smoke()), name
        for prop in ("head_dim", "padded_vocab", "d_inner", "ssm_heads"):
            assert getattr(cfg, prop) == getattr(jcfg, prop), (name, prop)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_layer_norm_and_gelu_mlp_match_jax(dtype):
    jcfg, cfg = _cfgs("whisper-medium", dtype)
    rng = np.random.default_rng(0)
    jx, tx = _both(3 + 2 * rng.normal(size=(2, 5, cfg.d_model)), dtype)
    w, b = (rng.normal(size=(cfg.d_model,)).astype(np.float32)
            for _ in range(2))
    got = TL.layer_norm(tx, torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == tx.dtype
    _close(got, JL.layer_norm(jx, jnp.asarray(w), jnp.asarray(b)), dtype)
    # eps 1e-6, not torch's 1e-5: visible on a row of tiny variance
    small = torch.full((1, cfg.d_model), 1.0)
    small[0, ::2] += 1e-3
    want = JL.layer_norm(jnp.asarray(small.numpy()), jnp.ones(cfg.d_model),
                         jnp.zeros(cfg.d_model))
    _close(TL.layer_norm(small, torch.ones(cfg.d_model),
                         torch.zeros(cfg.d_model)), want, "float32")
    torch_default = torch.nn.functional.layer_norm(small, (cfg.d_model,))
    assert not np.allclose(torch_default.numpy(), np.asarray(want),
                           rtol=1e-3)
    jn = {"ln1_w": jnp.asarray(w), "ln1_b": jnp.asarray(b)}
    tn = {"ln1_w": torch.from_numpy(w), "ln1_b": torch.from_numpy(b)}
    _close(TL.norm(tx, tn, cfg, "ln1"), JL.norm(jx, jn, jcfg, "ln1"), dtype)
    d, f = cfg.d_model, cfg.d_ff
    jp, tp = _params(rng, {"w_up": (d, f), "b_up": (f,), "w_down": (f, d),
                           "b_down": (d,)}, dtype)
    got = TL.mlp(tx, tp, cfg)
    assert got.dtype == tx.dtype
    _close(got, JL.mlp(jx, jp, jcfg), dtype)
    # GELU is the tanh approximation, as jax.nn.gelu's default, not the
    # erf form (1e-3 apart near |h| = 2)
    jh, th = _both(np.linspace(-4, 4, 101), dtype)
    want = jax.nn.gelu(jh)
    _close(TL._gelu(th), want, dtype)
    erf = torch.nn.functional.gelu(th.float()).numpy()
    assert np.abs(erf - np.asarray(want, np.float32)).max() > 4e-4


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cross_and_encoder_attention_match_jax(dtype):
    jcfg, cfg = _cfgs("whisper-medium", dtype)
    rng = np.random.default_rng(1)
    d, H, D = cfg.d_model, cfg.n_heads, cfg.head_dim
    B, S, S_e = 2, 3, 21
    jp, tp = _params(rng, {"cwq": (d, H * D), "cwo": (H * D, d),
                           "wq": (d, H * D), "wk": (d, H * D),
                           "wv": (d, H * D), "wo": (H * D, d),
                           "bq": (H * D,), "bk": (H * D,), "bv": (H * D,)},
                     dtype)
    jx, tx = _both(rng.normal(size=(B, S, d)), dtype)
    (jk, tk), (jv, tv) = (_both(rng.normal(size=(B, S_e, H, D)), dtype)
                          for _ in range(2))
    y_j, _ = JL.attention(jx, jp, jcfg, positions=None, kv_override=(jk, jv),
                          prefix="c")
    y_t, none = TL.attention(tx, tp, cfg, positions=None,
                             kv_override=(tk, tv), prefix="c")
    assert none is None and y_t.dtype == tx.dtype
    _close(y_t, y_j, dtype)
    # the encoder's self-attention: non-causal, RoPE on, bias
    je, te = _both(rng.normal(size=(B, S_e, d)), dtype)
    epos = np.arange(S_e)[None].repeat(B, 0)
    y_j, _ = JL.attention(je, jp, jcfg, positions=jnp.asarray(epos),
                          causal=False)
    y_t, _ = TL.attention(te, tp, cfg, positions=torch.from_numpy(epos),
                          causal=False)
    _close(y_t, y_j, dtype)


def _moe_params(cfg, dtype, rng):
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return _params(rng, {"router": (d, E), "w_gate": (E, d, f),
                         "w_up": (E, d, f), "w_down": (E, f, d)}, dtype,
                   f32=("router",))


def _drops(cfg, x: np.ndarray, router: np.ndarray) -> int:
    """Assignments past their expert's capacity, per the JAX routing."""
    B, S, _ = x.shape
    cap = TL.moe_capacity(cfg, S)
    logits = x.astype(np.float32) @ router
    _, eidx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), -1),
                            cfg.experts_per_token)
    counts = np.stack([np.bincount(np.asarray(eidx[b]).ravel(),
                                   minlength=cfg.n_experts)
                       for b in range(B)])
    return int(np.maximum(counts - cap, 0).sum())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("S,capacity_factor,drops", [
    (16, 1.25, True),          # the smoke prefill: cap 10 for 32 slots
    (16, 16.0, False),         # cap = S * k: nothing dropped
    (1, 1.25, False)])         # a decode step: cap = k
def test_moe_layer_matches_jax(dtype, S, capacity_factor, drops):
    jcfg, cfg = _cfgs("qwen3-moe-30b-a3b", dtype,
                      capacity_factor=capacity_factor)
    rng = np.random.default_rng(2)
    jp, tp = _moe_params(cfg, dtype, rng)
    # a skewed router sends most tokens to expert 0 (drops at cap 10)
    xs = rng.normal(size=(3, S, cfg.d_model)) + 0.5 * np.asarray(
        jp["router"])[:, 0] * np.sqrt(cfg.d_model)
    jx, tx = _both(xs, dtype)
    assert (_drops(cfg, np.asarray(jx.astype(jnp.float32)),
                   np.asarray(jp["router"])) > 0) == drops
    got = TL.moe_layer(tx, tp, cfg)
    want = JL._moe_gspmd(jx, jp, jcfg)
    assert got.dtype == tx.dtype
    _close(got, want, dtype)
    assert torch.equal(got, TL.moe_layer(tx, tp, cfg))       # deterministic


def test_moe_combine_is_bitwise_the_jax_scatter_add_in_bf16():
    """k = 4 of 8 experts on the drop-heavy S = 16 prefill, with integer
    weights and inputs that make every expert FFN product and sum exact
    in both packages (silu(g) = g at g >= 128): only the combine's bf16
    adds, one rounding each, differ by order, and the port's ascending
    expert order is bitwise the JAX package's scatter-add."""
    jcfg, cfg = _cfgs("qwen3-moe-30b-a3b", "bfloat16", n_experts=8,
                      experts_per_token=4)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    rng = np.random.default_rng(4)
    router = rng.normal(size=(d, E)) / np.sqrt(d)
    router[:, 0] += 0.05                    # most tokens to expert 0
    w = {"router": router.astype(np.float32),
         "w_gate": np.ones((E, d, f)),
         "w_up": rng.integers(-1, 2, (E, d, f)),
         "w_down": rng.integers(-1, 2, (E, f, d))}
    jp, tp = {}, {}
    for name, a in w.items():
        jp[name], tp[name] = _both(a, "float32" if name == "router"
                                   else "bfloat16")
    jx, tx = _both(rng.integers(1, 3, (3, 16, d)), "bfloat16")
    assert _drops(cfg, np.asarray(jx.astype(jnp.float32)), router) > 0
    got = TL.moe_layer(tx, tp, cfg)
    want = tensor_from_jax(np.asarray(JL._moe_gspmd(jx, jp, jcfg)))
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_moe_ties_route_to_the_lower_expert():
    jcfg, cfg = _cfgs("grok-1-314b")
    rng = np.random.default_rng(3)
    jp, tp = _moe_params(cfg, "float32", rng)
    zero = {"router": np.zeros_like(np.asarray(jp["router"]))}
    jp, tp = dict(jp, router=jnp.asarray(zero["router"])), dict(
        tp, router=torch.from_numpy(zero["router"]))
    jx, tx = _both(rng.normal(size=(2, 4, cfg.d_model)), "float32")
    # every prob ties: both take experts 0 and 1, with gates 1/2
    _close(TL.moe_layer(tx, tp, cfg), JL._moe_gspmd(jx, jp, jcfg),
           "float32")


@pytest.mark.parametrize("S,chunk", [(20, 16), (32, 16), (5, 16), (7, 7)])
def test_ssd_chunk_scan_matches_jax(S, chunk):
    rng = np.random.default_rng(S)
    B, H, P, Sd = 2, 3, 4, 5
    jxh, txh = _both(rng.normal(size=(B, S, H, P)), "float32")
    jdt, tdt = _both(np.log1p(np.exp(rng.normal(size=(B, S, H)))),
                     "float32")
    jA, tA = _both(-np.exp(rng.normal(size=(H,))), "float32")
    (jB, tB), (jC, tC) = (_both(rng.normal(size=(B, S, Sd)), "float32")
                          for _ in range(2))
    y, h = TL._ssd_chunk_scan(txh, tdt, tA, tB, tC, chunk)
    yj, hj = JL._ssd_chunk_scan(jxh, jdt, jA, jB, jC, chunk)
    _close(y, yj, "float32")
    _close(h, hj, "float32")


def _mamba_params(cfg, dtype, rng):
    d, di, H, Sd = cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_state
    jp, tp = _params(rng, {"wz": (d, di), "wx": (d, di), "wB": (d, Sd),
                           "wC": (d, Sd), "wdt": (d, H),
                           "out_proj": (di, d)}, dtype)
    for name, a in (("dt_bias", rng.normal(size=H)),
                    ("A_log", rng.normal(size=H)),
                    ("D", 1 + 0.1 * rng.normal(size=H)),
                    ("norm_w", 1 + 0.1 * rng.normal(size=di))):
        jp[name], tp[name] = _both(a, "float32")
    return jp, tp


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mamba2_layer_prefill_and_decode_match_jax(dtype):
    jcfg, cfg = _cfgs("mamba2-130m", dtype)
    rng = np.random.default_rng(4)
    jp, tp = _mamba_params(cfg, dtype, rng)
    B, S = 2, 21                                 # ragged: chunk 16
    jx, tx = _both(rng.normal(size=(B, S, cfg.d_model)), dtype)
    y_j, c_j = JL.mamba2_layer(jx, jp, jcfg, mode="prefill")
    y_t, c_t = TL.mamba2_layer(tx, tp, cfg, mode="prefill")
    assert y_t.dtype == tx.dtype and c_t["h"].dtype == torch.float32
    _close(y_t, y_j, dtype)
    _close(c_t["h"], c_j["h"], "float32" if dtype == "float32" else dtype)
    y_j, _ = JL.mamba2_layer(jx, jp, jcfg)
    y_t, none = TL.mamba2_layer(tx, tp, cfg)
    assert none is None
    _close(y_t, y_j, dtype)
    for step in range(2):                        # the recurrence
        jx1, tx1 = _both(rng.normal(size=(B, 1, cfg.d_model)), dtype)
        y_j, c_j = JL.mamba2_layer(jx1, jp, jcfg, cache=c_j, mode="decode")
        y_t, c_t = TL.mamba2_layer(tx1, tp, cfg, cache=c_t, mode="decode")
        _close(y_t, y_j, dtype)
        _close(c_t["h"], c_j["h"], "float32" if dtype == "float32"
               else dtype)
    # decode with no cache starts from zero state; several tokens at once
    y_j, _ = JL.mamba2_layer(jx[:, :3], jp, jcfg, mode="decode")
    y_t, _ = TL.mamba2_layer(tx[:, :3], tp, cfg, mode="decode")
    _close(y_t, y_j, dtype)


def _inputs(cfg, B: int, S: int, seed: int):
    """Tokens and the family's extra prefill input, as numpy."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (B, S))
    kw = {}
    if cfg.family == "vlm":
        kw["patch_embeds"] = rng.normal(
            size=(B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        kw["enc_frames"] = rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return tok, kw


def _cache_leaves(caches_t, caches_j, family):
    """``(port tensor, JAX array)`` of every cache entry."""
    out = []
    for i, c in enumerate(caches_t):
        for name, t in c.items():
            j = caches_j[name][i]
            if family == "hybrid" and name == "h":
                assert t.shape[0] == j.shape[0]
            out.append((t, j))
    return out


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_family_models_match_jax(arch):
    """Each new arch's smoke model on the JAX weights: train forward,
    prefill (caches included) and one decode step."""
    jcfg = jax_get_config(arch).smoke()
    params = init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, params),
                            get_config(arch).smoke(), device="cpu")
    cfg = model.cfg
    S = 20 if cfg.family == "vlm" else 21       # ssm: a ragged chunk
    tok, kw = _inputs(cfg, 2, S, seed=5)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    h_j, _ = jax_forward(params, jcfg, jnp.asarray(tok), **jkw)
    h_t, none = model(torch.from_numpy(tok), **tkw)
    assert none is None
    _close(h_t, h_j, "float32", model=True)
    last_j, caches_j = jax_prefill(params, jcfg, jnp.asarray(tok),
                                   cache_len=S + 3, **jkw)
    last_t, caches_t = prefill_step(model, torch.from_numpy(tok), S + 3,
                                    **tkw)
    _close(last_t, last_j, "float32", model=True)
    n = (cfg.n_layers // cfg.attn_period if cfg.family == "hybrid"
         else cfg.n_layers)
    assert len(caches_t) == n
    for t, j in _cache_leaves(caches_t, caches_j, cfg.family):
        assert tuple(t.shape) == j.shape
        _close(t, j, "float32", model=True)
    nxt = np.random.default_rng(6).integers(0, cfg.vocab, (2, 1))
    h_j, caches_j = jax_forward(params, jcfg, jnp.asarray(nxt),
                                caches=caches_j, pos=S)
    h_t, caches_t = model(torch.from_numpy(nxt), caches=caches_t, pos=S)
    _close(h_t, h_j, "float32", model=True)
    for t, j in _cache_leaves(caches_t, caches_j, cfg.family):
        _close(t, j, "float32", model=True)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", sorted(JAX_REGISTRY))
def test_init_params_shapes_and_types(arch, dtype):
    """`build_model`'s parameters are ``init_params``'s leaves, name for
    name, with their shapes and types (router, norms and the SSM's
    ``dt_bias`` / ``A_log`` / ``D`` f32; the rest the model's type), and
    its draws have ``init_params``' scales."""
    jcfg, cfg = _cfgs(arch, dtype)
    params = jax.tree.map(np.asarray, init_params(jcfg,
                                                  jax.random.PRNGKey(0)))
    want = {k: (tuple(t.shape), t.dtype) for k, t in _port_params(params)}
    model = build_model(cfg, seed=5, device="cpu")
    got = {k: (tuple(t.shape), t.dtype) for k, t in model.named_parameters()}
    assert got == want
    assert type(model) is {"ssm": MambaLM, "hybrid": HybridLM,
                           "encdec": EncDecLM}.get(cfg.family, DenseLM)
    again = build_model(cfg, seed=5, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 again.parameters()))
    p = dict(model.named_parameters())
    assert abs(float(model.embed.float().std()) - 0.02) < 2e-3
    for name, t in p.items():
        leaf = name.split(".")[-1]
        if leaf in ("A_log", "dt_bias") or leaf.startswith("b") \
                or leaf.endswith("_b"):
            assert not t.any(), name
        elif leaf in ("D", "norm_w") or leaf.endswith("_w"):
            assert bool((t == 1).all()), name
        elif leaf == "router":
            fan_in = t.shape[0]
            assert abs(float(t.std()) * np.sqrt(fan_in) - 1) < 0.15, name
    with pytest.raises(ValueError, match="use build_model"):
        (MambaLM if cfg.family != "ssm" else DenseLM)(cfg)


def test_params_from_jax_unstacks_periods_and_encoder():
    """Hybrid period stacks (then each period's own stacks) and the
    encoder's stack land slice by slice; missing or extra slices raise."""
    jcfg = jax_get_config("jamba-v0.1-52b").smoke()
    params = jax.tree.map(np.asarray, init_params(jcfg,
                                                  jax.random.PRNGKey(2)))
    model = params_from_jax(params, get_config("jamba-v0.1-52b").smoke(),
                            device="cpu")
    pp = params["periods"]
    np.testing.assert_array_equal(model.periods[1].moe[0].w_up.numpy(),
                                  pp["moe"]["w_up"][1, 0])
    np.testing.assert_array_equal(model.periods[1].attn.wq.numpy(),
                                  pp["attn"]["wq"][1])
    np.testing.assert_array_equal(model.periods[0].norms[1].ln2_w.numpy(),
                                  pp["norms"]["ln2_w"][0, 1])
    assert model.periods[0].moe[0].router.dtype == torch.float32
    broken = dict(params, periods=dict(pp, mlp=dict(pp["mlp"])))
    del broken["periods"]["mlp"]["w_up"]
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(broken, model.cfg, device="cpu")
    deeper = dict(params, periods=dict(pp, mamba={
        k: np.concatenate([v, v], axis=1) for k, v in pp["mamba"].items()}))
    with pytest.raises(ValueError, match="extra"):
        params_from_jax(deeper, model.cfg, device="cpu")
    jcfg = jax_get_config("whisper-medium").smoke()
    params = jax.tree.map(np.asarray, init_params(jcfg,
                                                  jax.random.PRNGKey(3)))
    model = params_from_jax(params, get_config("whisper-medium").smoke(),
                            device="cpu")
    np.testing.assert_array_equal(model.enc_layers[1].wq.numpy(),
                                  params["enc_layers"]["wq"][1])
    np.testing.assert_array_equal(model.layers[0].cwk.numpy(),
                                  params["layers"]["cwk"][0])
    np.testing.assert_array_equal(model.enc_pos.numpy(), params["enc_pos"])
    assert not hasattr(model.layers[0], "cbq")       # cross: no bias
