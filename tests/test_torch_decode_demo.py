"""The port's LM decode demo (``serve`` without ``--loop``) against the
JAX package's, and the bf16 vocab head it serves on.

* The whole demo — seeded prompts, prefill, 8 greedy decode steps — on
  the JAX package's smoke weights (`params_from_jax`) and its per-step
  block permutations (``permutation(fold_in(PRNGKey(i), 1), n_blocks)``,
  which its ``decode_step`` draws): exact head, and the bandit head on
  fp32, int8 and int4 tiles.  The tokens must be equal.
* The bandit head on a bf16 table and bf16 hidden states (the full-width
  model's types) against the JAX package's ``bounded_me_decode`` with
  ``use_pallas=True`` — kernel 1 on bf16 tiles, in interpret mode — and
  its jnp fallback, fp32 and int8: ids equal, scores to rtol 1e-5 with
  atol 1e-6 * max|score| (f32 sums in another order).
* int8 / int4 codes and scales of a bf16 table, and of bf16 query
  blocks, bytewise the JAX package's: the scales are bf16 quotients
  widened, not f32 quotients of the widened input (a cell is built
  where the two differ).
* The plain cascade on a bf16 table is bitwise the plain cascade on the
  table widened to f32; the serving table, the executor's tiled copy
  and a JAX bf16 serving table keep bf16.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import quantize as jq
from repro.core.boundedme_jax import bounded_me_decode as jax_decode
from repro.core.boundedme_jax import make_plan as jax_make_plan
from repro.models.model import init_params
from repro.models.steps import decode_step as jax_decode_step
from repro.models.steps import prefill_step as jax_prefill
from repro_torch.configs import get_config
from repro_torch.convert import (make_serving_table, params_from_jax,
                                 serving_table_from_jax, tensor_from_jax)
from repro_torch.core import quantize as tq
from repro_torch.core.boundedme_torch import (decode_operands, decode_tiled,
                                              make_plan, tile_table)
from repro_torch.kernels import ops, ref
from repro_torch.distributed.sharding import (Mesh,
                                              sharded_bounded_me_decode)
from repro_torch.launch import serve
from repro_torch.launch.engine import CascadeExecutor
from repro_torch.models.model import DenseLM

B, P, TOKENS = 2, 8, 8


def _jax_demo(jcfg, params, prompt):
    """The JAX package's decode demo loop (``_run_decode_demo``)."""
    _, caches = jax_prefill(params, jcfg, jnp.asarray(prompt),
                            cache_len=P + TOKENS)
    dfn = jax.jit(lambda p, c, t, pos, k: jax_decode_step(p, jcfg, c, t, pos,
                                                          key=k))
    tok, out = jnp.asarray(prompt)[:, -1:], []
    for i in range(TOKENS):
        nxt, caches = dfn(params, caches, tok, jnp.int32(P + i),
                          jax.random.PRNGKey(i))
        out.append(np.asarray(nxt))
        tok = nxt[:, None]
    return np.stack(out, axis=1)


def _jax_perm(i, n_blocks):
    key = jax.random.fold_in(jax.random.PRNGKey(i), 1)
    return torch.from_numpy(np.array(jax.random.permutation(key, n_blocks)))


@pytest.mark.parametrize("arch,mips,precision", [
    ("qwen1.5-0.5b", "exact", "fp32"),
    ("qwen1.5-0.5b", "boundedme", "fp32"),
    ("qwen1.5-0.5b", "boundedme", "int8"),
    ("qwen1.5-0.5b", "boundedme", "int4"),
    ("tinyllama-1.1b", "boundedme", "fp32")])
def test_decode_demo_tokens_match_jax(arch, mips, precision, capsys):
    args = serve.parse_args(["--arch", arch, "--smoke", "--device", "cpu",
                             "--mips", mips, "--precision", precision,
                             "--eps", "0.1", "--batch", str(B),
                             "--prompt-len", str(P), "--tokens",
                             str(TOKENS)])
    cfg = serve.decode_config(args)
    jcfg = dataclasses.replace(
        jax_get_config(arch).smoke(), mips_mode=mips, mips_eps=0.1,
        mips_delta=0.1, mips_precision=precision)
    params = init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (B, P))
    want = _jax_demo(jcfg, params, prompt)
    out = serve.run_decode_demo(args, model=model, perm_of=_jax_perm)
    np.testing.assert_array_equal(out["tokens"], want)
    assert out["tokens"].dtype == np.int32 and out["model"] is model
    text = capsys.readouterr().out
    assert f"mips={mips}" in text and "first sequences" in text
    if mips == "boundedme":
        assert f"precision={precision}" in text and "plain PyTorch" in text
        head = model._mips_head             # built once for the 8 steps
        assert head.V4.dtype == torch.float32 and head.n_valid == cfg.vocab
        assert (head.quantized is None) == (precision == "fp32")


def _bf16(a: np.ndarray):
    j = jnp.asarray(a.astype(ml_dtypes.bfloat16))
    return j, tensor_from_jax(np.asarray(j))


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_bf16_head_matches_jax_kernel_on_bf16_tiles(precision):
    rng = np.random.default_rng(11)
    n, N, n_valid = 256, 128, 250
    jV, V = _bf16(0.02 * rng.normal(size=(n, N)))
    jQ, Q = _bf16(rng.normal(size=(4, N)))
    kw = dict(K=2, eps=0.2, delta=0.1, value_range=4.0, block=32,
              precision=precision)
    jplan, plan = jax_make_plan(n, N, **kw), make_plan(n, N, **kw)
    key = jax.random.PRNGKey(3)
    perm = torch.from_numpy(np.array(jax.random.permutation(
        key, plan.n_blocks)))
    V4 = tile_table(V, plan, "cpu")
    assert V4.dtype == torch.bfloat16
    quant = tq.quantize_tiles(V4) if precision == "int8" else None
    ids, vals = decode_tiled(V4, Q, perm, plan=plan, n_valid=n_valid,
                             quantized=quant)
    for use_pallas in (True, False):
        jids, jvals = jax_decode(jV, jQ, key, plan=jplan, n_valid=n_valid,
                                 use_pallas=use_pallas)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        _close(vals.numpy(), jvals)


#: (JAX package's, port's) quantizer
QUANTIZERS = {"int8": (jq.quantize_tiles, tq.quantize_tiles),
              "int4": (jq.quantize_tiles_int4, tq.quantize_tiles_int4),
              "blocks": (jq.quantize_blocks, tq.quantize_blocks)}


@pytest.mark.parametrize("which", list(QUANTIZERS))
def test_bf16_quantizer_scales_are_bf16_quotients(which):
    jfn, tfn = QUANTIZERS[which]
    rng = np.random.default_rng(5)
    x = 0.02 * rng.normal(size=(6, 3, 8, 64))
    # cell (0, 0): max|x| = bf16(0.0123), whose bf16 quotient by 127 and
    # by 7 are not the f32 quotients rounded (9.7274780e-05 against
    # 9.7079537e-05 at 127): an upcast-first quantizer fails here
    x[0, 0] = np.clip(x[0, 0], -0.0123, 0.0123)
    x[0, 0, 0, 0] = 0.0123
    if which == "blocks":
        x = x.reshape(6, 3 * 8, 64)
        x[0, 0] = np.clip(x[0, 0], -0.0123, 0.0123)
        x[0, 0, 0] = 0.0123
    jx, tx = _bf16(x)
    got, want = tfn(tx), jfn(jx)
    for g, w in zip(got, want):
        assert g.dtype == torch.from_numpy(np.asarray(w)).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    upcast = tfn(tx.float())[1]
    assert got[1][0, 0] != upcast[0, 0]
    levels = 7 if which == "int4" else 127
    assert float(got[1][0, 0]) == float(torch.tensor(0.0123).bfloat16()
                                         / torch.tensor(levels).bfloat16())


def test_bf16_plain_cascade_is_the_widened_tables():
    rng = np.random.default_rng(9)
    n, N = 200, 96
    V = torch.from_numpy(0.02 * rng.normal(size=(n, N))).bfloat16()
    Q = torch.from_numpy(rng.normal(size=(3, N)).astype(np.float32))
    plan = make_plan(n, N, K=3, eps=0.2, value_range=4.0, block=32)
    V4 = tile_table(V, plan, "cpu")
    slotcode, rmeta, bpos, t_final, n_final, _ = decode_operands(
        plan, final_exact=True, adaptive=False, device=torch.device("cpu"))
    cols = torch.arange(plan.n_blocks)[bpos].to(torch.int32).expand(3, -1)
    Qb = torch.nn.functional.pad(Q, (0, plan.n_blocks * plan.block - N))
    Qb = Qb.reshape(3, plan.n_blocks, plan.block)
    kw = dict(n_arms=n, K=3, t_final=t_final, n_final=n_final, k_out=5)
    before = ops.launch_counts()
    got = ops.fused_cascade_batched(V4, Qb, slotcode, rmeta, cols, **kw)
    want = ref.fused_cascade_batched_ref(V4.float(), Qb, slotcode, rmeta,
                                         cols, **kw)
    assert ops.launch_counts() == before          # the plain version
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_serving_tables_keep_the_models_type():
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").smoke(),
                              dtype="bfloat16")
    table, n_valid = make_serving_table(cfg, seed=2, device="cpu")
    f32, _ = make_serving_table(dataclasses.replace(cfg, dtype="float32"),
                                seed=2, device="cpu")
    assert table.dtype == torch.bfloat16 and f32.dtype == torch.float32
    assert torch.equal(table, f32.bfloat16())     # the f32 draw, rounded
    ex = CascadeExecutor(table, K=2, block=64, n_valid=n_valid,
                         device="cpu")
    assert ex.tiled_table.dtype == torch.bfloat16
    ids, scores, _, _ = ex.dispatch(np.ones((2, cfg.d_model), np.float32),
                                    np.arange(ex.plan.n_blocks))
    assert ids.shape == (2, 2) and (ids < n_valid).all()
    exact = table[torch.from_numpy(ids.astype(np.int64))].double() \
        @ torch.ones(cfg.d_model, dtype=torch.float64) / cfg.d_model
    np.testing.assert_allclose(scores, exact.numpy(), rtol=1e-5)
    i8 = CascadeExecutor(table, K=2, block=64, precision="int8",
                         device="cpu")
    np.testing.assert_array_equal(i8.quantized[1].numpy(),
                                  tq.quantize_tiles(i8.tiled_table)[1]
                                  .numpy())
    jcfg = dataclasses.replace(jax_get_config("qwen1.5-0.5b").smoke(),
                               dtype="bfloat16")
    params = init_params(jcfg, jax.random.PRNGKey(0))
    carried, nv = serving_table_from_jax(
        {"embed": np.asarray(params["embed"])}, cfg)
    assert carried.dtype == torch.bfloat16 and nv == cfg.vocab
    np.testing.assert_array_equal(
        carried.float().numpy(), np.asarray(params["embed"], np.float32))


def test_decode_head_is_built_once_refuses_pq_and_shards_over_a_mesh():
    """The head is built once per parameter set and plan; pq has no table
    to calibrate on.  With ``mesh`` (refused before sharded serving was
    ported) the step runs the vocab-sharded head: its tokens are those of
    `sharded_bounded_me_decode` on the step's hidden states, K = 1, the
    padding rows masked, built once per parameter set and mesh."""
    from repro_torch.core.boundedme_torch import draw_perms
    from repro_torch.models.steps import (decode_step, make_mips_plan,
                                          mips_head, sharded_mips_head)
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").smoke(),
                              mips_mode="boundedme")
    model = DenseLM(cfg, seed=1, device="cpu")
    head = mips_head(model, cfg)
    assert mips_head(model, cfg) is head
    assert head.plan == make_mips_plan(cfg)
    assert head.plan.block == 128 and head.plan.tile == 8
    with torch.no_grad():
        model.embed.mul_(2)                       # an in-place write
    assert mips_head(model, cfg) is not head
    with pytest.raises(ValueError, match="pq"):
        make_mips_plan(dataclasses.replace(cfg, mips_precision="pq"))
    mesh = Mesh(["cpu"] * 3)
    tokens = torch.tensor([[5, 7, 9], [1, 2, 3]])
    perm = draw_perms(make_mips_plan(cfg).n_blocks)
    _, caches = model(tokens, cache_len=5)
    tok, _ = decode_step(model, cfg, caches, tokens[:, -1:], 3, perm=perm,
                         mesh=mesh)
    _, caches = model(tokens, cache_len=5)
    h, _ = model(tokens[:, -1:], caches=caches, pos=3)
    want = sharded_bounded_me_decode(
        model.head_table, h[:, -1], perm, mesh=mesh, K=1,
        n_valid=cfg.vocab, eps=cfg.mips_eps, delta=cfg.mips_delta,
        value_range=4.0, block=128)
    assert torch.equal(tok, want[0][:, 0]) and tok.dtype == torch.int32
    assert sharded_mips_head(model, cfg, mesh) is model._sharded_head
    assert len(model._sharded_head.shards) == 3
