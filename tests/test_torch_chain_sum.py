"""The gradient of a 16-bit bias, summed as the JAX package's program sums
it, against JAX.

XLA transposes the broadcast of a bf16 bias into a ``reduce`` with a bf16
init and a bf16 ``add``: one add and one rounding per element, where
autograd's sum of a bf16 tensor accumulates in f32 and rounds once.
XLA's CPU build adds in the order `repro_torch.kernels.chain_sum.passes`
states (a chain over the leading dimensions in row-major order; windows
of 32 where a dimension is longer, its tree reduction), and so does the
port's `chain_sum` (plain version here, the CUDA kernel on the card).

* `chain_sum_ref` bitwise the jitted bf16 ``reduce`` at rows 1, odd
  widths, (B, S, H, D) leading dimensions and shapes past the window (two
  and three passes).  f16 is refused: past the window, XLA's CPU f16
  ``reduce-window`` (which it does not run through f32 converts, as it
  does bf16) differs from a chain by an ulp in some windows (measured: 1
  of 2 outputs at (40, 40, 2)), and no model of the repository trains
  in f16, so an f16 bias keeps autograd's sum.
* A Python walk of the CUDA kernel's index arithmetic (its windows,
  odometer and skipped padding) equal to the plain version.
* `bias_add` in the layers against JAX's jitted ``grad`` of the same
  layer on the same inputs and cotangents: qwen1.5-0.5b's ``bq``,
  ``bk``, ``bv`` (`_qkv`) and whisper-medium's ``bq``, ``bk``, ``bv``,
  ``b_up`` and ``b_down`` (`mlp`; ``b_up``'s cotangent comes through the
  GELU, whose backward is the JAX package's op for op, `_Gelu`), and
  whisper's ``enc_pos`` over the batch, bitwise; an f32 or f16 bias
  unchanged.
* `scale_mul` in the JAX package's forms of mamba2's ``D`` skip and the
  MoE combine's gate weights, bitwise.
* The transposes of a bf16 embedding lookup and of the MoE's token
  gather (XLA's bf16 scatter-adds): the port's index backward on the CPU,
  bitwise.
* Under a simulated (2, 2) mesh a bias split over 'model' chains its
  ranks' local columns and rows: the ranks' chains summed in f32 and
  rounded once.
* SwiGLU's bf16 silu backward (`_Silu`, ROADMAP 3.7, found here and
  closed): bitwise the JAX package's program run op by op.
* The registered operator's fake implementation keeps shapes and type,
  and a bf16 train cell with biases still traces in the dry run.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax import lax

from jax_per_op import per_op
from repro.configs import get_config as jax_get_config
from repro.models import layers as JL
from repro_torch.configs import get_config
from repro_torch.configs.base import RunShape
from repro_torch.distributed.sharding import PartitionSpec, logical_mesh
from repro_torch.distributed.specs import place_tree
from repro_torch.kernels import chain_sum as cs
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import simulated_mesh
from repro_torch.models import layers as TL

#: (leading dims, W) against XLA's reduce: rows 1, a chain, odd widths,
#: (B, S, H, D) with D kept and with (H, D) kept, and XLA's windows
REDUCE_SHAPES = [((1,), 5), ((7,), 33), ((32,), 128), ((2, 16), 128),
                 ((2, 3, 4), 8), ((4, 16), 2 * 64), ((33,), 8),
                 ((8, 128), 64), ((3, 33, 35), 4), ((4096,), 3),
                 ((2, 1, 33), 3), ((0,), 4)]


def _bf16(a) -> np.ndarray:
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(
        np.float32)


def _xla_reduce(a: np.ndarray, lead: int, dtype) -> np.ndarray:
    """JAX's jitted 16-bit ``reduce`` of ``a`` over its first ``lead``
    dimensions, widened to f32."""
    x = jnp.asarray(a, dtype)
    out = jax.jit(lambda t: lax.reduce(t, jnp.zeros((), dtype), lax.add,
                                       tuple(range(lead))))(x)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("lead,W", REDUCE_SHAPES)
def test_chain_sum_ref_is_xlas_bf16_reduce(lead, W):
    a = np.random.default_rng(W + len(lead)).normal(
        size=(*lead, W)).astype(np.float32)
    got = ops.chain_sum(torch.from_numpy(a).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and got.shape == (W,)
    want = _xla_reduce(a, len(lead), jnp.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), want)
    if a.size and max(lead) > 1:       # the check can see the rounding
        once = _bf16(_bf16(a).reshape(-1, W).astype(np.float64).sum(0))
        assert (once != want).any()
    with pytest.raises(TypeError, match="bfloat16"):
        ops.chain_sum(torch.from_numpy(a).to(torch.float16))


def test_chain_sum_keeps_trailing_dims_and_passes():
    """``lead`` sums the first dimensions and keeps the rest, as XLA's
    reduce of ``enc_pos[None]``'s broadcast keeps (T, d); the passes of
    (8, 128) and of 33 rows are XLA's windows."""
    a = np.random.default_rng(0).normal(size=(3, 40, 5, 7)).astype(
        np.float32)
    got = ops.chain_sum(torch.from_numpy(a).to(torch.bfloat16), lead=2)
    assert got.shape == (5, 7)
    want = jax.jit(lambda t: lax.reduce(t, jnp.bfloat16(0), lax.add,
                                        (0, 1)))(jnp.asarray(a,
                                                             jnp.bfloat16))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    assert cs.passes((8, 128)) == (
        cs.Pass((8, 128), (8, 32), (0, 0), (1, 4)),
        cs.Pass((1, 4), (1, 4), (0, 0), (1, 1)))
    assert cs.passes((33,))[0] == cs.Pass((33,), (32,), (15,), (2,))
    assert len(cs.passes((4096,))) == 3 and len(cs.passes((32,))) == 1
    with pytest.raises(ValueError):
        ops.chain_sum(torch.zeros((2, 2, 2, 2, 2, 3), dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        ops.chain_sum(torch.zeros((4, 3)))


def _kernel_walk(g: np.ndarray) -> np.ndarray:
    """``csrc/chain_sum.cu``'s index arithmetic in Python: per pass, the
    leading dimensions made four by ones in front, each (window, column)
    thread's window ``J * w - pad`` clipped to the grid, the box walked
    row by row in row-major order (a row along the last dimension, at
    most 32 long), one bf16 rounding per add."""
    x, W = g, g.shape[-1]
    for ps in cs.passes(g.shape[:-1]):
        one = (1,) * (4 - len(ps.G))
        G, w = one + ps.G, one + ps.w
        pad, n = (0,) * len(one) + ps.pad, one + ps.n
        assert w[3] <= 32
        x = x.reshape(*G, W)
        out = np.zeros((*n, W), np.float32)
        for J in itertools.product(*(range(d) for d in n)):
            b = [J[i] * w[i] - pad[i] for i in range(4)]
            lo = [max(b[i], 0) for i in range(4)]
            hi = [min(b[i] + w[i], G[i]) for i in range(4)]
            acc = np.zeros(W, np.float32)
            for r in itertools.product(*(range(lo[i], hi[i])
                                         for i in range(3))):
                for t in range(lo[3], hi[3]):
                    acc = _bf16(acc + x[(*r, t)])
            out[J] = acc
        x = out
    return x.reshape(W)


@pytest.mark.parametrize("lead,W", [((33,), 6), ((70, 3), 2), ((5, 40), 3),
                                    ((2, 3, 4, 35), 2), ((3, 40, 70), 2)])
def test_kernel_index_walk_is_the_plain_version(lead, W):
    a = _bf16(np.random.default_rng(1).normal(size=(*lead, W)))
    got = ref.chain_sum_ref(torch.from_numpy(a).to(torch.bfloat16))
    np.testing.assert_array_equal(_kernel_walk(a), got.float().numpy())


def _layer_case(arch: str, B: int, S: int):
    """bf16 layer weights, input and f32 cotangents of ``_qkv`` (and
    ``mlp`` for ln archs) at ``arch``'s smoke widths."""
    jcfg = dataclasses.replace(jax_get_config(arch).smoke(),
                               dtype="bfloat16")
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="bfloat16")
    d, H, KV, Dh, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    shapes = {"wq": (d, H * Dh), "wk": (d, KV * Dh), "wv": (d, KV * Dh),
              "bq": (H * Dh,), "bk": (KV * Dh,), "bv": (KV * Dh,)}
    if cfg.norm == "ln":
        shapes.update(w_up=(d, F), b_up=(F,), w_down=(F, d), b_down=(d,))
    rng = np.random.default_rng(S)
    p = {k: _bf16(0.05 * rng.normal(size=s)) for k, s in shapes.items()}
    x = _bf16(rng.normal(size=(B, S, d)))
    outs = [(B, S, H, Dh), (B, S, KV, Dh), (B, S, KV, Dh)] + (
        [(B, S, d)] if cfg.norm == "ln" else [])
    cs_ = [rng.normal(size=s).astype(np.float32) for s in outs]
    return jcfg, cfg, p, x, cs_


@pytest.mark.parametrize("B,S", [(2, 16), (8, 128)])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "whisper-medium"])
def test_bias_gradients_bitwise_jax_grad(arch, B, S):
    """One device, bf16: every bias gradient of the attention's q, k, v
    projections (and whisper's MLP) bitwise JAX's jitted ``grad`` of the
    same layers; (8, 128) is the card's train step, where XLA's tree
    reduction takes two passes."""
    jcfg, cfg, p, x, cots = _layer_case(arch, B, S)

    def jloss(params, xx):
        outs = list(JL._qkv(xx, params, jcfg))
        if jcfg.norm == "ln":
            outs.append(JL.mlp(xx, params, jcfg))
        return sum(jnp.sum(o.astype(jnp.float32) * c)
                   for o, c in zip(outs, cots))

    want = jax.jit(jax.grad(jloss))(
        {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()},
        jnp.asarray(x, jnp.bfloat16))
    tp = {k: torch.from_numpy(v).to(torch.bfloat16).requires_grad_(True)
          for k, v in p.items()}
    tx = torch.from_numpy(x).to(torch.bfloat16)
    outs = list(TL._qkv(tx, tp, cfg))
    if cfg.norm == "ln":
        outs.append(TL.mlp(tx, tp, cfg))
    loss = sum((o.float() * torch.from_numpy(c)).sum()
               for o, c in zip(outs, cots))
    biases = [k for k in tp if k.startswith("b")]
    got = torch.autograd.grad(loss, [tp[k] for k in biases])
    assert len(biases) == (5 if arch == "whisper-medium" else 3)
    for k, g in zip(biases, got):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            g.float().numpy(), np.asarray(want[k].astype(jnp.float32)),
            err_msg=k)
    # the check can see the rounding: bq's cotangent summed in f32 and
    # rounded once (autograd's sum) is not JAX's
    c = _bf16(cots[0]).reshape(-1, p["bq"].shape[0])
    assert (_bf16(c.astype(np.float64).sum(0))
            != np.asarray(want["bq"].astype(jnp.float32))).any()


def test_enc_pos_gradient_bitwise_jax_grad():
    """whisper's ``enc_frames + enc_pos[None]`` (the JAX model's form):
    the gradient of ``enc_pos`` sums the batch in bf16, as `bias_add`
    with ``enc_pos`` whole does (one leading dimension kept (T, d))."""
    cfg = get_config("whisper-medium").smoke()
    T, d, B = cfg.encoder_seq, cfg.d_model, 40
    rng = np.random.default_rng(5)
    pos = _bf16(0.02 * rng.normal(size=(T, d)))
    fr = rng.normal(size=(B, T, d)).astype(np.float32)
    c = rng.normal(size=(B, T, d)).astype(np.float32)
    want = jax.jit(jax.grad(lambda p_: jnp.sum((
        jnp.asarray(fr).astype(jnp.bfloat16) + p_[None]).astype(
            jnp.float32) * c)))(jnp.asarray(pos, jnp.bfloat16))
    tp = torch.from_numpy(pos).to(torch.bfloat16).requires_grad_(True)
    y = TL.bias_add(torch.from_numpy(fr).to(torch.bfloat16), tp)
    (got,) = torch.autograd.grad((y.float() * torch.from_numpy(c)).sum(),
                                 [tp])
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("case", ["ssm_D", "moe_gate"])
def test_scale_gradient_bitwise_jax_grad(case):
    """`scale_mul` against JAX's jitted ``grad`` of the JAX package's two
    16-bit products whose scale's gradient XLA sums in bf16: mamba2's
    skip ``y + xh * D[None, None, :, None].astype(bf16)`` (a ``reduce``
    over (B, S, P), S = 40 past the window) and the MoE combine's ``vals
    * w[:, None].astype(bf16)`` (a ``reduce`` over d = 128, four windows
    of 32); f32 ``D`` and ``w`` behind the casts, bitwise."""
    rng = np.random.default_rng(6)
    if case == "ssm_D":
        xs, ss, expand = (2, 40, 8, 32), (8,), (None, None, slice(None),
                                               None)
    else:
        xs, ss, expand = (64, 128), (64,), (slice(None), None)
    x, y0 = (_bf16(rng.normal(size=xs)) for _ in range(2))
    s = rng.normal(size=ss).astype(np.float32)
    c = rng.normal(size=xs).astype(np.float32)
    want = jax.jit(jax.grad(lambda s_: jnp.sum((
        jnp.asarray(y0, jnp.bfloat16) + jnp.asarray(x, jnp.bfloat16)
        * s_[expand].astype(jnp.bfloat16)).astype(jnp.float32) * c)))(
            jnp.asarray(s))
    ts = torch.from_numpy(s).requires_grad_(True)
    out = torch.from_numpy(y0).to(torch.bfloat16) + TL.scale_mul(
        torch.from_numpy(x).to(torch.bfloat16), ts[expand].to(torch.bfloat16))
    (got,) = torch.autograd.grad((out.float() * torch.from_numpy(c)).sum(),
                                 [ts])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    plain = torch.from_numpy(s).requires_grad_(True)
    out = torch.from_numpy(y0).to(torch.bfloat16) + torch.from_numpy(x).to(
        torch.bfloat16) * plain[expand].to(torch.bfloat16)
    (once,) = torch.autograd.grad((out.float() * torch.from_numpy(c)).sum(),
                                  [plain])
    assert (once.numpy() != np.asarray(want)).any()


@pytest.mark.parametrize("rows,index", [(50, (8, 32)), (16, (64,))],
                         ids=["embed_lookup", "moe_token_gather"])
def test_gather_transposes_bitwise_jax_grad(rows, index):
    """The audit's bf16 scatter-adds of a gather's transpose: an embedding
    lookup ``embed[tokens]`` (``model.py:253``) and the MoE dispatch's
    token gather ``xr[token]`` (``layers.py:325``, each token k times,
    sorted): XLA adds the repeats in bf16 in index order, and so does
    the port's index backward on the CPU, bitwise."""
    rng = np.random.default_rng(rows)
    t = _bf16(rng.normal(size=(rows, 128)))
    idx = rng.integers(0, rows, index)
    if len(index) == 1:
        idx = np.sort(idx)
    c = rng.normal(size=(*index, 128)).astype(np.float32)
    want = jax.jit(jax.grad(lambda e: jnp.sum(e[idx].astype(jnp.float32)
                                              * c)))(
        jnp.asarray(t, jnp.bfloat16))
    tt = torch.from_numpy(t).to(torch.bfloat16).requires_grad_(True)
    (got,) = torch.autograd.grad((tt[torch.from_numpy(idx)].float()
                                  * torch.from_numpy(c)).sum(), [tt])
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    assert np.bincount(idx.ravel()).max() > 2      # repeats to round


def test_open_fault_silu_backward_is_autograds():
    """ROADMAP 3.7, found beside this file's audit and closed (the name
    is the one the open fault was recorded under): SwiGLU's ``_silu`` is
    bitwise ``jax.nn.silu`` in bf16, and so is its gradient (`_Silu`,
    the transpose of JAX's silu JVP op for op), against the JAX program
    compiled with each op rounding to bf16 (`jax_per_op.per_op`); with
    autograd's derivative of the written-out ops 1,202 of these 4,096
    bf16 gradients were apart, by up to 128 bf16 ulps where the
    derivative nears zero (measured)."""
    rng = np.random.default_rng(0)
    x, c = (_bf16(rng.normal(size=(4096,))) for _ in range(2))
    jx = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(per_op(jax.grad(lambda a: jnp.sum(jax.nn.silu(
        a).astype(jnp.float32) * c)))(jx).astype(jnp.float32))
    t = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    y = TL._silu(t)
    np.testing.assert_array_equal(
        y.detach().float().numpy(),
        np.asarray(per_op(jax.nn.silu)(jx).astype(jnp.float32)))
    (got,) = torch.autograd.grad((y.float() * torch.from_numpy(c)).sum(),
                                 [t])
    assert type(y.grad_fn).__name__ == "_SiluBackward"
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_f32_bias_keeps_autograds_path(monkeypatch):
    """An f32 or f16 bias (or a bias not being differentiated) is ``x +
    b`` as before: the same value and gradient, and no chain sum."""
    monkeypatch.setattr(TL, "chain_sum", lambda *a, **k: pytest.fail(
        "chain_sum on an f32 bias"))
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(3, 5, 16)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(16,)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(3, 5, 16)).astype(np.float32))
    bb = b.clone().requires_grad_(True)
    (got,) = torch.autograd.grad((TL.bias_add(x, bb) * c).sum(), [bb])
    b2 = b.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(((x + b2) * c).sum(), [b2])
    assert torch.equal(got, want)
    xh, ch = x.half(), c.half()
    bh = b.half().requires_grad_(True)
    (got,) = torch.autograd.grad((TL.bias_add(xh, bh) * ch).sum(), [bh])
    bh2 = b.half().requires_grad_(True)
    (want,) = torch.autograd.grad(((xh + bh2) * ch).sum(), [bh2])
    assert got.dtype == torch.float16 and torch.equal(got, want)
    xb, b16 = x.bfloat16(), b.bfloat16()
    assert torch.equal(TL.bias_add(xb, b16), xb + b16)


def test_bias_split_over_model_chains_local_columns():
    """A bias split over 'model' on a simulated (2, 2) mesh, its input
    split over 'data' by rows and over 'model' by columns: the gradient
    is each 'data' rank's chain of its rows, summed in f32 over 'data'
    and rounded once, each 'model' rank holding its own columns; the
    forward is ``x + b``."""
    from repro_torch.models.steps import _as_param
    rng = np.random.default_rng(4)
    x = _bf16(rng.normal(size=(4, 12, 64)))
    b = _bf16(0.1 * rng.normal(size=(64,)))
    c = rng.normal(size=(4, 12, 64)).astype(np.float32)
    t = {"x": torch.from_numpy(x).to(torch.bfloat16),
         "b": torch.from_numpy(b).to(torch.bfloat16),
         "c": torch.from_numpy(c)}
    xs = PartitionSpec("data", None, "model")
    with simulated_mesh((2, 2), device="cpu") as mesh, logical_mesh(mesh):
        pl = place_tree(t, {"x": xs, "c": xs,
                            "b": PartitionSpec("model")}, mesh)
        pb = pl["b"].requires_grad_(True)
        y = TL.bias_add(pl["x"], pb)
        (g,) = torch.autograd.grad((y.float() * pl["c"]).sum(), [pb])
        g = _as_param(g, pb)
        assert g.placements == pb.placements
        got = g.full_tensor()
        val = y.full_tensor()
        if hasattr(got, "reconcile"):
            got, val = got.reconcile(), val.reconcile()
    assert torch.equal(val, t["x"] + t["b"])
    cb = torch.from_numpy(_bf16(c)).to(torch.bfloat16)
    parts = [ref.chain_sum_ref(cb[r * 2:(r + 1) * 2]).float()
             for r in range(2)]
    assert torch.equal(got, (parts[0] + parts[1]).to(torch.bfloat16))


def test_fake_implementation_keeps_shapes_and_dtype():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        g = torch.empty((8, 128, 1024), dtype=torch.bfloat16)
        out = ops.chain_sum(g)
        assert out.shape == (1024,) and out.dtype == torch.bfloat16
        out = ops.chain_sum(torch.empty((2, 24, 64), dtype=torch.bfloat16),
                            lead=1)
        assert out.shape == (24, 64) and out.dtype == torch.bfloat16
        with pytest.raises(TypeError, match="bfloat16"):
            ops.chain_sum(torch.empty((2, 24), dtype=torch.float16))
    torch.library.opcheck(ops._chain_sum_op, (
        torch.randn(3, 5, 7).to(torch.bfloat16),))


def test_bf16_train_cell_with_biases_traces_in_dry_run(monkeypatch):
    """qwen1.5-0.5b's smoke config in bf16, a train cell on the dry run's
    fake (2, 4) mesh: ``ok``, each layer's three bias gradients through
    `_chain_grad` (the operator's fake implementation), no 16-bit
    all-reduce or reduce-scatter."""
    calls = []
    real = TL._chain_grad
    monkeypatch.setattr(TL, "_chain_grad", lambda g, dims: calls.append(
        (g.dtype, dims)) or real(g, dims))
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").smoke(),
                              dtype="bfloat16", n_layers=2)
    rec = D.run_cell(cfg, RunShape("train_tiny", 32, 8, "train"), "single",
                     save=False, mesh_shape=((2, 4), ("data", "model")))
    assert rec["ok"], rec.get("traceback")
    assert calls == [(torch.bfloat16, (0, 1))] * 3 * cfg.n_layers
    assert rec["reductions_16_bit"] == 0
