"""Training on the card against training on the CPU, and resume on the
card.

Every test is marked ``cuda`` and skips without a card.  This file
imports only the port.  Both models start from the same f32 smoke
weights (built on the CPU from a seed, copied to the card), TF32 off:

* the first step's gradients agree per parameter to rtol 1e-4 with atol
  1e-4 * max|g| (whole smoke models, ``tests/test_torch_models.py``;
  the card's embedding and MoE backward accumulate with atomics, in
  another order);
* over three `train_step`s the losses agree to rtol 1e-5 and the
  gradient norms to rtol 1e-4; an AdamW update keeps only about the
  sign of a gradient whose size is near ``eps`` or near the two
  devices' difference, so all but 0.1 % of the parameters agree to rtol
  1e-4 with atol lr / 100 (a hundredth of one update), and every one
  within 2 lr a step.

Resume: under ``torch.use_deterministic_algorithms(True)`` (with
``CUBLAS_WORKSPACE_CONFIG`` set, both set by the test) a run halted at
step 3 and restarted from its checkpoint is bitwise the uninterrupted
run, parameters and moments.
"""

import copy

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data.synthetic import LMStream
from repro_torch.launch import train as T
from repro_torch.models.model import build_model
from repro_torch.models.steps import loss_fn, train_step
from repro_torch.optim.adamw import AdamWConfig, init_opt

pytestmark = pytest.mark.cuda

TOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _batch(stream, step, dev):
    return {k: torch.from_numpy(v).to(dev)
            for k, v in stream.batch_at(step).items()}


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-moe-30b-a3b"])
def test_train_step_on_the_card_matches_the_cpu(arch, card):
    cfg = get_config(arch).smoke()
    host = build_model(cfg, seed=3, device="cpu")
    dev = copy.deepcopy(host).to(card)
    stream = LMStream(cfg.vocab, batch=4, seq=32, seed=0)
    grads = {}
    for name, m in (("cpu", host), ("card", dev)):
        params = dict(m.named_parameters())
        for p in params.values():
            p.requires_grad_(True)
        loss, _ = loss_fn(m, cfg, _batch(stream, 0, p.device))
        grads[name] = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
    for k, g in grads["cpu"].items():
        scale = float(g.abs().max())
        assert torch.allclose(grads["card"][k].cpu(), g, rtol=TOL,
                              atol=TOL * scale), k

    lr = 1e-3
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=1, total_steps=10)
    opts = {"cpu": init_opt(dict(host.named_parameters())),
            "card": init_opt(dict(dev.named_parameters()))}
    for step in range(3):
        ms = {}
        for name, m in (("cpu", host), ("card", dev)):
            _, opts[name], ms[name] = train_step(
                m, opts[name], _batch(stream, step, m.embed.device), cfg,
                opt_cfg)
        np.testing.assert_allclose(float(ms["card"]["loss"]),
                                   float(ms["cpu"]["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(ms["card"]["grad_norm"]),
                                   float(ms["cpu"]["grad_norm"]), rtol=TOL)
    off = n = 0
    for (k, a), (_, b) in zip(dev.named_parameters(), host.named_parameters()):
        d = (a.detach().cpu() - b.detach()).abs()
        assert float(d.max()) <= 2 * lr * 3, k
        off += int((d > TOL * b.detach().abs() + 1e-2 * lr).sum())
        n += d.numel()
    assert off <= 1e-3 * n, (off, n)


def test_resume_on_the_card_is_bitwise(card, tmp_path, monkeypatch):
    """The trainer on the card (its default device): 6 steps at once
    against 3 steps, a checkpoint, a restart at the stream's step 3 and 3
    more steps."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        argv = ["--arch", "qwen3-moe-30b-a3b", "--smoke", "--steps", "6",
                "--batch", "4", "--seq", "32"]
        whole = T.train(T.parse_args(argv))
        assert whole["model"].embed.device.type == "cuda"
        ckpt = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "3"]
        T.train(T.parse_args(argv + ckpt), halt_at=3)
        rest = T.train(T.parse_args(argv + ckpt))
    finally:
        torch.use_deterministic_algorithms(False)
    assert rest["start"] == 3
    assert [h["loss"] for h in rest["history"]] == \
        [h["loss"] for h in whole["history"][3:]]
    for (k, a), (_, b) in zip(whole["model"].named_parameters(),
                              rest["model"].named_parameters()):
        assert torch.equal(a, b), k
    for k in whole["opt"].mu:
        assert torch.equal(whole["opt"].mu[k], rest["opt"].mu[k]), k
        assert torch.equal(whole["opt"].nu[k], rest["opt"].nu[k]), k
