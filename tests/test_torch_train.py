"""The port's training path against the JAX package's: `LMStream`,
`loss_fn` and its gradients for every family, `train_step`, 30 steps of
the tinyllama smoke model (``tests/test_system.py``'s run), resume, the
train CLI, and the bandit head serving the trained model.

Weights reach the port through `repro_torch.convert.params_from_jax`
and results return through `repro_torch.convert.to_jax_tree`, so both
packages compute on the same values.

Tolerances (f32 smoke models):

* loss: rtol 1e-5 — ``logsumexp`` and the mean over the batch, summed in
  another order, over a forward that agrees to ~1e-6;
* gradients: per JAX leaf, rtol 1e-4 with atol 1e-4 * max|g| — the
  forward's per-layer differences (rtol 1e-5, ``tests/test_torch_models
  .py``), carried back through 2 to 8 layers; the SSD scan's leaves
  are the widest apart, 2.7e-5 of max|g|;
* 30 training steps: losses rtol 1e-5 at every step — AdamW normalizes
  each update, so the gradients' last-bit differences stay in the last
  bits of the loss (the two packages' losses meet to 2e-7 here);
* with ``compress``, one step from a non-zero error buffer: a
  gradient's last bits differ by up to ~1e-6 of its leaf's largest, so
  where ``g + err`` nearly cancels its bf16 rounding, and its sign, may
  differ, and the update ``lr * g / (|g| + eps)`` with it (by up to 2
  lr).  So all but 0.1 % of the elements of the parameters and moments
  are held to rtol 1e-5 (parameters), 2^-7 (first moment, one bf16 step
  of the gradient) and 2^-6 (second); every parameter within 2 lr, every
  moment within 2^-6 of its leaf's largest.  The error buffer and later
  steps are held bitwise to the port's own `compress_grads` then
  `apply_updates` (`compress_grads` is bitwise the JAX package's,
  ``tests/test_torch_optim.py``).

The port against itself is bitwise: remat on and off, and a resume from
a checkpoint against the uninterrupted run.
"""

import copy
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.synthetic import LMStream as JaxStream
from repro.models import layers as JL
from repro.models.model import init_params
from repro.models.steps import loss_fn as jax_loss
from repro.models.steps import train_step as jax_train_step
from repro.optim import adamw as JA
from repro_torch.checkpoint.checkpointer import (restore_checkpoint,
                                                 save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.convert import (opt_state_from_jax, params_from_jax,
                                 tensor_from_jax, to_jax_tree)
from repro_torch.launch.engine import seeded_perm
from repro_torch.data.synthetic import LMStream
from repro_torch.launch import train as T
from repro_torch.launch.mesh import (local_mesh_shape, make_local_mesh,
                                     simulated_mesh)
from repro_torch.models import layers as TL
from repro_torch.models.model import build_model
from repro_torch.models.steps import (decode_step, loss_fn, mips_head,
                                      prefill_step, train_step)
from repro_torch.optim import adamw as TA

ARCHS = ["tinyllama-1.1b", "qwen1.5-0.5b", "qwen3-moe-30b-a3b",
         "mamba2-130m", "jamba-v0.1-52b", "whisper-medium",
         "internvl2-26b"]


def _batch(cfg, B: int, S: int, seed: int) -> dict:
    """A numpy batch: tokens, labels, and the family's extra input."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    b = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if cfg.family == "vlm":
        b["patch_embeds"] = rng.normal(
            size=(B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        b["enc_frames"] = rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return b


def _jax(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _grads(model, cfg, batch) -> dict:
    """The port's loss gradients by name."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    loss, _ = loss_fn(model, cfg, batch)
    return dict(zip(params, torch.autograd.grad(loss,
                                                list(params.values()))))


def _tree_close(got: dict, want, rtol: float = 1e-4):
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for p in path:
            node = node[p.key]
        b = np.asarray(leaf, np.float32)
        np.testing.assert_allclose(node, b, rtol=rtol,
                                   atol=rtol * float(np.abs(b).max()),
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("vocab,batch,seq,seed", [(512, 4, 32, 0),
                                                  (32_000, 8, 128, 0),
                                                  (100, 2, 9, 3)])
def test_lm_stream_is_bitwise_the_jax_packages(vocab, batch, seq, seed):
    ours = LMStream(vocab, batch=batch, seq=seq, seed=seed)
    ref = JaxStream(vocab, batch=batch, seq=seq, seed=seed)
    for step in (0, 1, 7, 1000):
        a, b = ours.batch_at(step), ref.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
    for a, b in zip(iter(ours), [ref.batch_at(i) for i in range(3)]):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch):
    """``loss_fn`` and its gradients (by ``torch.autograd``) against
    ``jax.value_and_grad`` of the JAX package's ``loss_fn``, on the same
    weights and batch (vlm with ``patch_embeds``, encdec with
    ``enc_frames``)."""
    jcfg, cfg = jax_get_config(arch).smoke(), get_config(arch).smoke()
    params = init_params(jcfg, jax.random.PRNGKey(0))
    like = jax.tree.map(np.asarray, params)
    model = params_from_jax(like, cfg, device="cpu")
    b = _batch(cfg, 2, 20, seed=1)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jax_loss(p, jcfg, _jax(b)), has_aux=True))(params)
    loss, metrics = loss_fn(model, cfg, _torch(b))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert float(metrics["acc"]) == float(jm["acc"])
    _tree_close(to_jax_tree(_grads(model, cfg, _torch(b)), like), jg)


def test_accuracy_takes_the_first_index_on_ties():
    cfg = get_config("tinyllama-1.1b").smoke()
    model = build_model(cfg, seed=0, device="cpu")
    with torch.no_grad():
        model.unembed.zero_()            # every logit 0: a tie everywhere
    b = {"tokens": torch.zeros((1, 4), dtype=torch.int32),
         "labels": torch.tensor([[0, 1, 0, 5]], dtype=torch.int32)}
    _, m = loss_fn(model, cfg, b)
    assert float(m["acc"]) == 0.5


def test_chunked_causal_attention_gradients_match_jax():
    """Past one 512-query chunk the causal path masks each chunk's
    diagonal block of the scores in place; its gradients against the JAX
    layer's (S = 1024, two chunks)."""
    jcfg, cfg = jax_get_config("tinyllama-1.1b").smoke(), \
        get_config("tinyllama-1.1b").smoke()
    params = init_params(jcfg, jax.random.PRNGKey(1))
    lp = {k: v[0] for k, v in params["layers"].items()
          if k in ("wq", "wk", "wv", "wo")}
    rng = np.random.default_rng(2)
    S = 1024
    x = rng.normal(size=(1, S, cfg.d_model)).astype(np.float32)
    w = rng.normal(size=(1, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S)[None]

    def jf(x_, p_):
        y, _ = JL.attention(x_, p_, jcfg, positions=jnp.asarray(pos))
        return jnp.sum(y * w)
    jgx, jgp = jax.jit(jax.grad(jf, argnums=(0, 1)))(jnp.asarray(x), lp)
    tx = torch.from_numpy(x).requires_grad_(True)
    tp = {k: tensor_from_jax(np.asarray(v)).requires_grad_(True)
          for k, v in lp.items()}
    y, _ = TL.attention(tx, tp, cfg, positions=torch.from_numpy(pos))
    (y * torch.from_numpy(w)).sum().backward()
    for got, want in [(tx.grad, jgx)] + [(tp[k].grad, jgp[k]) for k in tp]:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-130m",
                                  "jamba-v0.1-52b", "whisper-medium"])
def test_remat_gives_bitwise_equal_gradients(arch):
    """``cfg.remat`` (each layer, period and encoder layer under
    activation checkpointing) changes no gradient bit."""
    cfg = get_config(arch).smoke()
    b = _torch(_batch(cfg, 2, 20, seed=4))
    grads = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        grads[remat] = _grads(build_model(c, seed=0, device="cpu"), c, b)
    assert grads[False].keys() == grads[True].keys()
    for k in grads[False]:
        assert torch.equal(grads[False][k], grads[True][k]), k


def test_serving_builds_no_autograd_graph():
    """Prefill and decode run under ``no_grad`` even once the trainer has
    turned the parameters' gradients on; the train mode builds a graph
    only then."""
    cfg = get_config("tinyllama-1.1b").smoke()
    model = build_model(cfg, seed=0, device="cpu")
    tok = torch.zeros((2, 5), dtype=torch.int32)
    h, _ = model(tok)
    assert h.grad_fn is None
    train_step(model, TA.init_opt(dict(model.named_parameters())),
               _torch(_batch(cfg, 2, 5, seed=0)), cfg, TA.AdamWConfig())
    assert all(p.requires_grad for p in model.parameters())
    assert model(tok)[0].grad_fn is not None
    last, caches = prefill_step(model, tok, cache_len=8)
    assert last.grad_fn is None and all(
        t.grad_fn is None for c in caches for t in c.values())
    nxt, caches = decode_step(model, cfg, caches, tok[:, -1:], 5)
    assert not nxt.requires_grad and caches[0]["k"].grad_fn is None
    cfg_b = dataclasses.replace(cfg, mips_mode="boundedme")
    nxt, caches = decode_step(model, cfg_b, caches, nxt[:, None], 6)
    assert not nxt.requires_grad
    assert mips_head(model, cfg_b).V4.grad_fn is None
    with torch.no_grad():
        assert model(tok)[0].grad_fn is None


def test_train_step_with_compression_matches_jax():
    """One ``train_step`` with bf16 error-feedback compression from a
    non-zero error buffer, on the moe smoke model: the metrics, the
    parameters and both moments."""
    arch = "qwen3-moe-30b-a3b"
    jcfg, cfg = jax_get_config(arch).smoke(), get_config(arch).smoke()
    params = init_params(jcfg, jax.random.PRNGKey(0))
    like = jax.tree.map(np.asarray, params)
    model = params_from_jax(like, cfg, device="cpu")
    rng = np.random.default_rng(8)
    jo = JA.init_opt(params)
    jo = jo._replace(err=jax.tree.map(lambda e: jnp.asarray(
        rng.normal(size=e.shape) * 1e-4, jnp.float32), jo.err))
    to = opt_state_from_jax(jax.tree.map(np.asarray, jo), device="cpu")
    jc = JA.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    tc = TA.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    b = _batch(cfg, 2, 16, seed=10)
    params, jo, jm = jax.jit(lambda p, o, b_: jax_train_step(
        p, o, b_, jcfg, jc, compress=True))(params, jo, _jax(b))
    model, to, tm = train_step(model, to, _torch(b), cfg, tc, compress=True)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    off, n = 0, 0
    for mine, ref, rtol, bound in (
            (dict(model.named_parameters()), params, 1e-5, 2 * 1e-3),
            (to.mu, jo.mu, 2 ** -7, None), (to.nu, jo.nu, 2 ** -6, None)):
        got = to_jax_tree(mine, like)
        for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
            node = got
            for p in path:
                node = node[p.key]
            want = np.asarray(leaf)
            bad = np.abs(node - want) > rtol * np.abs(want)
            off, n = off + int(bad.sum()), n + bad.size
            if bound is not None:
                assert np.abs(node - want).max() <= bound
            else:
                gm = float(np.abs(want).max())
                assert (np.abs(node - want)[bad] <= 2 ** -6 * gm).all()
    assert off <= 1e-3 * n              # 922 of 5.7 M here


def test_train_step_compresses_then_applies():
    """``train_step(compress=True)`` is bitwise the loss gradients through
    `compress_grads`, then `apply_updates`, the new error buffer kept;
    without ``compress`` the error buffer passes through."""
    cfg = get_config("qwen3-moe-30b-a3b").smoke()
    tc = TA.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    b = _torch(_batch(cfg, 2, 16, seed=3))
    m1 = build_model(cfg, seed=0, device="cpu")
    m2 = copy.deepcopy(m1)
    o1 = TA.init_opt(dict(m1.named_parameters()))
    o2 = TA.init_opt(dict(m2.named_parameters()))
    for t in o1.err.values():
        t.fill_(1e-6)
    for t in o2.err.values():
        t.fill_(1e-6)
    m1, o1, _ = train_step(m1, o1, b, cfg, tc, compress=True)
    g, err = TA.compress_grads(_grads(m2, cfg, b), o2.err)
    p2, o2, _ = TA.apply_updates(dict(m2.named_parameters()), g, o2, tc)
    for name, p in m1.named_parameters():
        assert torch.equal(p, p2[name]), name
        assert torch.equal(o1.mu[name], o2.mu[name])
        assert torch.equal(o1.err[name], err[name])
    kept = {k: v.clone() for k, v in o1.err.items()}
    _, o3, _ = train_step(m1, o1, b, cfg, tc)
    assert all(torch.equal(o3.err[k], kept[k]) for k in kept)


@pytest.fixture(scope="module")
def trained():
    """``tests/test_system.py``'s 30 steps of the tinyllama smoke model
    (batch 4, seq 32, lr 1e-3, 5 warm-up steps of 100), in both packages
    from the same weights."""
    jcfg = jax_get_config("tinyllama-1.1b").smoke()
    cfg = get_config("tinyllama-1.1b").smoke()
    params = init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    jc = JA.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=100)
    tc = TA.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=100)
    jo, to = JA.init_opt(params), TA.init_opt(dict(model.named_parameters()))
    stream = LMStream(cfg.vocab, batch=4, seq=32, seed=0)
    fn = jax.jit(lambda p, o, b: jax_train_step(p, o, b, jcfg, jc))
    jl, tl = [], []
    for i in range(30):
        b = stream.batch_at(i)
        params, jo, jm = fn(params, jo, _jax(b))
        model, to, tm = train_step(model, to, _torch(b), cfg, tc)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    return cfg, model, to, tc, stream, np.array(jl), np.array(tl)


def test_training_loss_trajectory_matches_jax(trained):
    *_, jl, tl = trained
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0] - 0.3 and jl[-1] < jl[0] - 0.3


def test_checkpoint_resume_is_bitwise(trained, tmp_path):
    """Kill-and-restart at step 30 matches uninterrupted steps 30..35:
    parameters and moments bitwise."""
    cfg, model, opt, tc, stream, *_ = trained
    model = copy.deepcopy(model)
    params = dict(model.named_parameters())
    opt = TA.OptState(opt.step.clone(), *(
        None if t is None else {k: v.clone() for k, v in t.items()}
        for t in (opt.mu, opt.nu, opt.err)))
    save_checkpoint(str(tmp_path), 30, {"params": params, "opt": opt})
    mA, oA = copy.deepcopy(model), opt
    for i in range(30, 35):
        mA, oA, _ = train_step(mA, oA, _torch(stream.batch_at(i)), cfg, tc)
    restored, step = restore_checkpoint(
        str(tmp_path), {"params": params, "opt": TA.init_opt(params)})
    mB = build_model(cfg, device="meta")
    mB.load_state_dict(restored["params"], assign=True)
    oB = restored["opt"]
    for i in range(step, 35):
        mB, oB, _ = train_step(mB, oB, _torch(stream.batch_at(i)), cfg, tc)
    for (na, a), (nb, b_) in zip(mA.named_parameters(),
                                 mB.named_parameters()):
        assert na == nb and torch.equal(a, b_), na
    for k in oA.mu:
        assert torch.equal(oA.mu[k], oB.mu[k])
        assert torch.equal(oA.nu[k], oB.nu[k])
    assert int(oA.step) == int(oB.step) == 35


def test_bandit_decode_of_the_trained_model_matches_exact(trained):
    """``tests/test_system.py``'s rollout in the port: the trained model
    served by the bandit head (eps 0.05) agrees with the exact head on at
    least 5 of 6 greedy steps."""
    cfg, model, *_ = trained
    cfg_e = dataclasses.replace(cfg, mips_mode="exact")
    cfg_b = dataclasses.replace(cfg, mips_mode="boundedme", mips_eps=0.05)
    prompt = torch.from_numpy(
        np.random.default_rng(5).integers(0, cfg.vocab, (2, 8)))
    _, cache_e = prefill_step(model, prompt, cache_len=32)
    _, cache_b = prefill_step(model, prompt, cache_len=32)
    n_blocks = mips_head(model, cfg_b).plan.n_blocks
    te = tb = prompt[:, -1:]
    agree = []
    for step in range(6):
        ne, cache_e = decode_step(model, cfg_e, cache_e, te, 8 + step)
        nb, cache_b = decode_step(model, cfg_b, cache_b, tb, 8 + step,
                                  perm=seeded_perm(0, step, n_blocks))
        agree.append(torch.equal(ne, nb))
        te, tb = ne[:, None], nb[:, None]
    assert np.mean(agree) >= 5 / 6


def _args(*extra):
    return T.parse_args(["--arch", "tinyllama-1.1b", "--smoke", "--device",
                         "cpu", "--batch", "2", "--seq", "16", *extra])


def test_train_cli_runs_and_resumes(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    T.main(["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu",
            "--steps", "4", "--batch", "2", "--seq", "16", "--ckpt-dir",
            ckpt, "--log-every", "2"])
    out = capsys.readouterr().out
    assert "[train] step=0 loss=" in out and "[train] step=3 loss=" in out
    assert "[train] done: 4 steps" in out
    assert "resumed" not in out
    T.main(["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu",
            "--steps", "6", "--batch", "2", "--seq", "16", "--ckpt-dir",
            ckpt, "--log-every", "1"])
    out = capsys.readouterr().out
    assert "[train] resumed from step 4" in out
    assert "[train] step=4 loss=" in out and "[train] step=0" not in out
    assert "[train] done: 6 steps" in out


def test_trainer_resume_at_the_stream_step_is_bitwise(tmp_path):
    """`train` halted at step 3 (a checkpoint every 3 steps) and
    restarted reaches step 6 bitwise where an uninterrupted run does; the
    restart resumes at the stream's step 3."""
    base = ["--steps", "6", "--lr", "3e-3"]
    whole = T.train(_args(*base))
    ckpt = str(tmp_path / "ckpt")
    part = T.train(_args(*base, "--ckpt-dir", ckpt,
                         "--ckpt-every", "3"), halt_at=3)
    assert [h["step"] for h in part["history"]] == [0, 1, 2]
    rest = T.train(_args(*base, "--ckpt-dir", ckpt,
                         "--ckpt-every", "3"))
    assert rest["start"] == 3
    assert [h["step"] for h in rest["history"]] == [3, 4, 5]
    assert [h["loss"] for h in part["history"] + rest["history"]] == \
        [h["loss"] for h in whole["history"]]
    for (n, a), (_, b) in zip(whole["model"].named_parameters(),
                              rest["model"].named_parameters()):
        assert torch.equal(a, b), n
    for k in whole["opt"].mu:
        assert torch.equal(whole["opt"].mu[k], rest["opt"].mu[k])
        assert torch.equal(whole["opt"].nu[k], rest["opt"].nu[k])


def test_local_mesh_clamps_and_multi_card_training_raises(tmp_path,
                                                          monkeypatch):
    """The local mesh clamps to the ranks there are, as the JAX package's
    does: without a process group there is one, so ``--data-par 2
    --model-par 2`` trains on one device (multi-card training no longer
    raises); under a group of 4 ranks the clamped shapes, and a mesh
    that does not cover every rank raises."""
    assert local_mesh_shape(4, 2) == (1, 1)
    assert local_mesh_shape() == (1, 1)
    res = T.train(_args("--steps", "1", "--data-par", "2",
                        "--model-par", "2"))
    assert res["mesh"] is None and len(res["history"]) == 1
    with simulated_mesh((4, 1), device="cpu"):
        assert local_mesh_shape(4, 2) == (4, 1)
        assert local_mesh_shape(2, 2) == (2, 2)
        assert local_mesh_shape(3, 2) == (3, 1)
        mesh = make_local_mesh(2, 2, device="cpu")
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (2, 2)
        with pytest.raises(RuntimeError, match="process group of 3"):
            make_local_mesh(3, 2, device="cpu")


def test_step_deadline_raises_on_a_hung_step():
    with pytest.raises(TimeoutError):
        with T.StepDeadline(1):
            time.sleep(3)
    with T.StepDeadline(0):
        pass
