"""The port's bf16 gradients against the JAX package's program as its
source writes it: every op rounding to its type (`jax_per_op.per_op`).

* The reference: the default ``jax.jit`` of a bf16 model is not the
  program its source describes, since XLA's CPU compiler keeps bf16
  intermediates in f32 inside a fusion; compiled with that excess
  precision off it is the op-by-op program bitwise, and the port's
  forward follows that program, not the default jit's.
* The repaired elementwise backwards, bitwise: ``_silu`` (SwiGLU's
  activation, `_Silu`: the transpose of ``jax.nn.silu``'s JVP op for op)
  on 65,536 seeded inputs and where ``mlp`` and ``_moe_rows`` call it
  (the cotangent and input the layer hands it), ``_gelu`` (`_Gelu`), and
  in f32 the MoE's gate renormalization (`_Renorm`, XLA's fused
  multiply-adds as ``addcmul``).
* A 1-layer bf16 smoke model of tinyllama-1.1b and of mamba2-130m
  (the JAX weights, ``LMStream`` batch 0, B = 2, S = 64): each
  parameter's gradient against the per-op JAX gradient, every element
  within two bf16 steps of its leaf's largest, and each parameter's
  share of elements apart within `SHARE_APART`.  What is left apart is
  not elementwise op order: XLA's f32 ``exp``, ``log``, ``rsqrt`` and
  ``tanh`` are its own approximations and its products sum in an order
  of its own (ROADMAP "Not faults"; ``tools/torch_bf16_backward_ops.py``
  lists each site), and where one such rounding flips a bf16 result,
  every later product moves.  The counts are therefore those of these
  weights and this batch on the CPU, not a property of the port alone:
  on the same model's weights drawn eagerly rather than jitted, one flip
  in the head's product moves 12.5 % of wq's elements.  mamba2's mixer
  already differs in its forward (its in-projection's product, the f32
  softplus and the scan: ``--mamba2``), so its counts are held where
  they stand.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from jax_per_op import per_op
from repro.configs import get_config as jax_get_config
from repro.models.model import forward as jax_forward
from repro.models.model import init_params
from repro.models.steps import loss_fn as jax_loss
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, to_jax_tree
from repro_torch.data.synthetic import LMStream
from repro_torch.models import layers as TL
from repro_torch.models.steps import loss_fn

B, S = 2, 64

#: each parameter's share of elements apart from the per-op JAX gradient
#: at most: tinyllama-1.1b at 0.2 % (measured on the CPU: wq 19 of
#: 16,384, embed 7 of 65,536, w_gate 6 of 32,768, wv and w_down 1, the
#: rest 0; with autograd's silu backward 18,187 of w_gate's 32,768 and
#: 11,961 of wq's 16,384); mamba2-130m as measured, with room (out_proj
#: 382 of 32,768, wx 2,620, wz 2,459, wB 201 of 2,048, wC 122, wdt 203 of
#: 1,024; ``D`` bitwise)
SHARE_APART = {
    "tinyllama-1.1b": {k: 0.002 for k in ("w_gate", "w_up", "w_down", "wq",
                                          "wk", "wv", "wo", "embed")},
    "mamba2-130m": {"out_proj": 0.015, "wx": 0.1, "wz": 0.1, "wB": 0.12,
                    "wC": 0.08, "wdt": 0.25, "D": 0.0},
}


def _bf16(a) -> np.ndarray:
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(
        np.float32)


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _one_layer(arch: str):
    """``(jax cfg, port cfg, JAX params, numpy batch, port model)``:
    ``arch``'s smoke config at 1 layer in bf16 on the JAX weights, and
    `LMStream` batch 0 (built once for the module's tests)."""
    over = dict(n_layers=1, dtype="bfloat16")
    jcfg = dataclasses.replace(jax_get_config(arch).smoke(), **over)
    cfg = dataclasses.replace(get_config(arch).smoke(), **over)
    params = jax.jit(init_params, static_argnums=0)(jcfg,
                                                    jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    return jcfg, cfg, params, LMStream(cfg.vocab, batch=B, seq=S,
                                       seed=0).batch_at(0), model


def test_per_op_reference_is_the_op_by_op_program():
    """tinyllama-1.1b at 1 layer in bf16: the forward compiled by
    `per_op` is bitwise ``jax.disable_jit()``'s; the default jit is more
    than 1,000 of the 16,384 final hidden elements from it (measured
    10,656); the port's forward is within 16 of it."""
    jcfg, _, params, batch, model = _one_layer("tinyllama-1.1b")
    tok = jnp.asarray(batch["tokens"])

    def fwd(p, t):
        return jax_forward(p, jcfg, t)[0]
    ref = _f32(per_op(fwd)(params, tok))
    with jax.disable_jit():
        eager = _f32(fwd(params, tok))
    np.testing.assert_array_equal(ref, eager)
    assert int((_f32(jax.jit(fwd)(params, tok)) != ref).sum()) > 1000
    with torch.no_grad():
        h, _ = model(torch.from_numpy(batch["tokens"]))
    assert ref.size == 16_384
    assert int((h.float().numpy() != ref).sum()) <= 16


def _silu_spy(monkeypatch):
    """``TL._silu`` wrapped to keep, from its last call, its input ``g``,
    the cotangent of its output and ``g``'s gradient, and the name of
    its output's backward node."""
    seen, orig = {}, TL._silu

    def spy(g):
        y = orig(g)
        seen.update(g=g.detach().clone(), node=type(y.grad_fn).__name__)
        y.register_hook(lambda c: seen.__setitem__("cot", c))
        g.register_hook(lambda c: seen.__setitem__("grad", c))
        return y
    monkeypatch.setattr(TL, "_silu", spy)
    return seen


def _layer_through_silu(site: str, rng):
    """Run ``mlp`` (tinyllama-1.1b smoke) or ``_moe_rows`` (qwen3-moe
    smoke, both MoE forms' FFN) forward and backward in bf16 on seeded
    weights, inputs and cotangent."""
    arch = "tinyllama-1.1b" if site == "mlp" else "qwen3-moe-30b-a3b"
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="bfloat16")
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts

    def w(*shape):
        return torch.from_numpy(_bf16(0.05 * rng.normal(size=shape))).to(
            torch.bfloat16).requires_grad_(True)
    x = torch.from_numpy(_bf16(rng.normal(size=(B, S, d)))).to(
        torch.bfloat16).requires_grad_(True)
    if site == "mlp":
        out = TL.mlp(x, {"w_gate": w(d, f), "w_up": w(d, f),
                         "w_down": w(f, d)}, cfg)
    else:
        router = torch.from_numpy(rng.normal(size=(d, E)).astype(
            np.float32)).requires_grad_(True)
        out = TL._moe_rows(x, router, w(E, d, f), w(E, d, f), w(E, f, d),
                           cfg, TL.moe_capacity(cfg, S))
    cot = torch.from_numpy(_bf16(rng.normal(size=out.shape))).to(out.dtype)
    out.backward(cot)


def _renorm_case(rng):
    """``(jax function, a, c, port gradient)`` of the MoE's gate
    renormalization in f32 at k = 8 (qwen3-moe-30b-a3b's), some rows
    below the 1e-9 floor."""
    a = (0.3 * np.abs(rng.normal(size=(2, 4096, 8)))).astype(np.float32)
    a[0, :3] = 0
    c = rng.normal(size=a.shape).astype(np.float32)
    ta = torch.from_numpy(a).requires_grad_(True)
    y = TL._renorm(ta)
    assert type(y.grad_fn).__name__ == "_RenormBackward"
    (got,) = torch.autograd.grad(y, [ta], torch.from_numpy(c))
    return (lambda g: g / jnp.maximum(g.sum(-1, keepdims=True), 1e-9),
            a, c, got)


@pytest.mark.parametrize("site", ["silu", "gelu", "mlp", "moe_rows",
                                  "renorm"])
def test_repaired_backward_bitwise_per_op_jax(site, monkeypatch):
    """Bitwise the per-op ``jax.vjp``: in bf16 ``_silu`` and ``_gelu`` on
    65,536 seeded inputs and cotangents (forward bitwise too), and the
    silu inside ``mlp`` and ``_moe_rows`` on the input and cotangent the
    layer hands it, through `_Silu`; in f32 the MoE's gate
    renormalization (`_Renorm`), forward and backward."""
    rng = np.random.default_rng(7)
    if site == "renorm":
        jf, a, c, got = _renorm_case(rng)
        want = per_op(lambda x, t: jax.vjp(jf, x)[1](t)[0])(a, c)
        np.testing.assert_array_equal(
            TL._renorm(torch.from_numpy(a)).numpy(), _f32(per_op(jf)(a)))
        np.testing.assert_array_equal(got.numpy(), _f32(want))
        return
    if site in ("silu", "gelu"):
        jf, tf = ((jax.nn.silu, TL._silu) if site == "silu"
                  else (jax.nn.gelu, TL._gelu))
        a, c = (_bf16(s * rng.normal(size=(65_536,))) for s in (3, 1))
        ta = torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True)
        y = tf(ta)
        (got,) = torch.autograd.grad(y, [ta], torch.from_numpy(c).to(
            torch.bfloat16))
        np.testing.assert_array_equal(
            y.detach().float().numpy(),
            _f32(per_op(jf)(jnp.asarray(a, jnp.bfloat16))))
    else:
        seen = _silu_spy(monkeypatch)
        _layer_through_silu(site, rng)
        assert seen["node"] == "_SiluBackward"
        jf, a, c, got = (jax.nn.silu, seen["g"].float().numpy(),
                         seen["cot"].float().numpy(), seen["grad"])
    want = per_op(lambda x, t: jax.vjp(jf, x)[1](t)[0])(
        jnp.asarray(a, jnp.bfloat16), jnp.asarray(c, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), _f32(want))


@pytest.mark.parametrize("arch", sorted(SHARE_APART))
def test_one_layer_bf16_gradients_per_op_jax(arch):
    """The loss and every parameter's gradient of a 1-layer bf16 smoke
    model against the per-op JAX ``value_and_grad`` on the same weights
    and batch: the loss to rtol 1e-6, each listed parameter's share of
    elements apart within `SHARE_APART` (mamba2's ``D``, summed by the
    chain, bitwise), and every element within 2^-7 of its leaf's
    largest (two bf16 steps there)."""
    jcfg, cfg, params, batch, model = _one_layer(arch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, _), jg = per_op(lambda p, b: jax.value_and_grad(
        lambda q: jax_loss(q, jcfg, b), has_aux=True)(p))(params, jb)
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    loss, _ = loss_fn(model, cfg, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    got = to_jax_tree(dict(zip(named, torch.autograd.grad(
        loss, list(named.values())))), params)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    bounds = SHARE_APART[arch]
    for path, want in jax.tree_util.tree_flatten_with_path(jg)[0]:
        name = path[-1].key
        node = got
        for p in path:
            node = node[p.key]
        want = _f32(want)
        gap = np.abs(node - want)
        assert gap.max() <= 2.0 ** -7 * np.abs(want).max(), name
        if name in bounds:
            assert (gap > 0).mean() <= bounds[name], (
                name, int((gap > 0).sum()), want.size)
