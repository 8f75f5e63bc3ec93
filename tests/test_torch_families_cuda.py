"""Each family's smoke model on the card against the same model on the
CPU.

Every test is marked ``cuda`` and skips without a card.  This file
imports only the port.  Both models hold the same f32 weights (one model
built on the CPU from a seed, copied to the card) with TF32 off, so the
card computes the same f32 operations in another order: hidden states
agree to rtol 1e-4 with atol 1e-4 * max|h| (the tolerance of whole smoke
models in ``tests/test_torch_models.py``), and the next tokens of the
exact head — and of the bandit head, the card's launch of the
fused-cascade kernel against the CPU's plain version on the same perm —
are equal.  The MoE combine is held bitwise in bf16 on an input whose
expert FFN sums are exact on both devices.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import layers as TL
from repro_torch.models.model import build_model, masked_logits
from repro_torch.models.steps import decode_step, prefill_step

pytestmark = pytest.mark.cuda

ARCHS = ["qwen3-moe-30b-a3b", "grok-1-314b", "mamba2-130m",
         "jamba-v0.1-52b", "whisper-medium", "internvl2-26b",
         "command-r-35b"]
TOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got: torch.Tensor, want: torch.Tensor):
    scale = float(want.abs().max())
    assert torch.allclose(got.cpu(), want, rtol=TOL, atol=TOL * scale), \
        float((got.cpu() - want).abs().max())


@pytest.mark.parametrize("arch", ARCHS)
def test_family_smoke_model_on_the_card_matches_the_cpu(arch, card):
    cfg = dataclasses.replace(get_config(arch).smoke(),
                              mips_mode="boundedme", mips_eps=0.1)
    host = build_model(cfg, seed=3, device="cpu")
    dev = copy.deepcopy(host).to(card)
    rng = np.random.default_rng(7)
    B, S = 2, 21
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
    kw = {}
    if cfg.family == "vlm":
        kw["patch_embeds"] = torch.from_numpy(rng.normal(
            size=(B, cfg.n_patches, cfg.d_model)).astype(np.float32))
    if cfg.family == "encdec":
        kw["enc_frames"] = torch.from_numpy(rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    out = {}
    for name, m, where in (("cpu", host, "cpu"), ("card", dev, card)):
        last, caches = prefill_step(m, tok.to(where), S + 2,
                                    **{k: v.to(where) for k, v in kw.items()})
        nxt = torch.argmax(masked_logits(cfg, m.head_table, last), -1)
        h, _ = m(nxt[:, None], caches=copy.deepcopy(caches), pos=S)
        bandit, _ = decode_step(m, cfg, caches, nxt[:, None], S)
        out[name] = (last, nxt, h[:, -1], bandit)
    for i, what in enumerate(("prefill hidden", "next tokens",
                              "decode hidden", "bandit tokens")):
        cpu, got = out["cpu"][i], out["card"][i]
        assert got.device.type == "cuda", what
        if what.endswith("tokens"):
            assert torch.equal(got.cpu(), cpu), what
        else:
            _close(got, cpu)


def test_moe_combine_on_the_card_is_bitwise_the_cpu_in_bf16(card):
    """k = 4 of 8 experts, bf16, S = 16 (cap 10 for 64 assignments): a
    zero router routes every token to experts 0-3 with gates 1/4 exactly,
    and integer weights and inputs make the expert FFN's products and
    sums exact (silu(g) = g at g >= 128, f32 accumulation).  Only the
    combine's bf16 adds round by order: the card's, in ascending expert
    id without atomics, are bitwise the CPU's."""
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b").smoke(),
                              dtype="bfloat16", n_experts=8,
                              experts_per_token=4)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    g = torch.Generator().manual_seed(4)
    p = {"router": torch.zeros((d, E)),
         "w_gate": torch.ones((E, d, f), dtype=torch.bfloat16),
         "w_up": torch.randint(-1, 2, (E, d, f), generator=g).bfloat16(),
         "w_down": torch.randint(-1, 2, (E, f, d), generator=g).bfloat16()}
    x = torch.randint(1, 3, (3, 16, d), generator=g).bfloat16()
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        got = TL.moe_layer(x.to(card), {k: v.to(card) for k, v in p.items()},
                           cfg)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            reduced
    assert TL.moe_capacity(cfg, 16) == 10
    assert torch.equal(got.cpu(), TL.moe_layer(x, p, cfg))
