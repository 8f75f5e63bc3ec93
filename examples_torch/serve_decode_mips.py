"""End-to-end serving example in PyTorch on a CUDA card: batched requests,
BoundedME logit search.

The port of ``examples/serve_decode_mips.py``: the same config, prompts
and printed lines.  Trains nothing; builds a randomly initialized small
model, prefills a batch of prompts, and decodes greedily with the
paper's bandit replacing the final (d x vocab) matvec, each bandit step
one launch of the fused-cascade kernel (``fused_cascade_batched[fp32]``)
on the card.  Compares against exact decode token-for-token.

    PYTHONPATH=src python examples_torch/serve_decode_mips.py [--device cpu]
"""

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import REGISTRY
from repro_torch.core.boundedme_torch import draw_perms, resolve_device
from repro_torch.models.model import build_model
from repro_torch.models.steps import decode_step, make_mips_plan, \
    prefill_step

#: the decode heads the example compares: (mips mode, eps or None)
MODES = (("exact", None), ("boundedme", 0.1), ("boundedme", 0.4))


def make_config(vocab: int = 151_936):
    """A small-but-real config: the qwen1.5 family at reduced width (d_model
    256, 8 heads of 32, 8 kv heads; the smoke depth, f32), full vocab."""
    return dataclasses.replace(
        REGISTRY["qwen1.5-0.5b"].smoke(),
        vocab=vocab, vocab_pad=2048, d_model=256, n_heads=8, d_head=32,
        n_kv_heads=8)


def decode(model, cfg, prompts: torch.Tensor, T: int, *, perm_of=None):
    """Prefill ``prompts (B, P)`` into a cache of ``P + T`` positions, then
    ``T`` greedy decode steps under ``cfg``'s head, feeding the prompts'
    last tokens first, as the JAX example does.  A bandit step ``i``
    takes the block permutation ``perm_of(i, n_blocks)`` when given (tests
    pass the JAX package's), else the next draw of a generator seeded 0.
    Returns ``(tokens (B, T) int32 array, seconds)``."""
    B, P = prompts.shape
    _, caches = prefill_step(model, prompts, cache_len=P + T)
    n_blocks = (make_mips_plan(cfg).n_blocks
                if cfg.mips_mode == "boundedme" else None)
    gen = torch.Generator().manual_seed(0)
    tok = prompts[:, -1:]
    toks = []
    t0 = time.time()
    for i in range(T):
        perm = None
        if n_blocks is not None:
            perm = (perm_of(i, n_blocks) if perm_of is not None
                    else draw_perms(n_blocks, generator=gen))
        nxt, caches = decode_step(model, cfg, caches, tok, P + i, perm=perm)
        toks.append(nxt)
        tok = nxt[:, None]
    out = torch.stack(toks, 1).cpu().numpy()      # waits for the device
    return out, time.time() - t0


def run(cfg, *, B: int = 8, P: int = 12, T: int = 20, device="cuda",
        model=None, perm_of=None, log=print) -> dict:
    """The example's work: ``B`` prompts of ``P`` tokens from
    ``default_rng(0)``, decoded ``T`` tokens by each head of `MODES`
    on ``model`` (default `build_model` of ``cfg`` from seed 0), the
    lines printed through ``log`` as the JAX example prints them.

    Returns ``{"tokens": {tag: (B, T) array}, "seconds": {tag: s},
    "agreement": {tag: share equal to exact}, "padded_rows", "model"}``.
    """
    dev = resolve_device(device)
    if model is None:
        model = build_model(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (B, P))).to(dev)

    results, seconds = {}, {}
    for mode, eps in MODES:
        c = dataclasses.replace(cfg, mips_mode=mode,
                                mips_eps=eps or cfg.mips_eps)
        toks, dt = decode(model, c, prompts, T, perm_of=perm_of)
        tag = mode if eps is None else f"{mode}(eps={eps})"
        results[tag], seconds[tag] = toks, dt
        log(f"{tag:22s}: {T} tokens x {B} requests in {dt:.2f}s")

    ref = results["exact"]
    agreement = {}
    for tag, toks in results.items():
        if tag == "exact":
            continue
        agreement[tag] = float((toks == ref).mean())
        log(f"{tag:22s}: token agreement with exact = "
            f"{agreement[tag]:.3f}")
    log(f"vocab = {cfg.vocab} | the bandit searched {cfg.padded_vocab} "
        f"padded rows with zero preprocessing")
    return {"tokens": results, "seconds": seconds, "agreement": agreement,
            "padded_rows": cfg.padded_vocab, "model": model}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run(make_config(), B=8, P=12, T=20, device=args.device)


if __name__ == "__main__":
    main()
