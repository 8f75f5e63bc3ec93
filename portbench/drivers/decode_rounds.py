"""Greedy decode rounds of a dense model through the port's
``prefill_step`` and ``decode_step``, with the bandit head.

Set-up makes the weights and every session's context ids on the card
from the seed and hands them to the port's model (built on the meta
device, so it draws none of its own), prefills every context into caches
that hold the context and one round, and serves each session's first
token from the prefill's last hidden state with the model's head.  The
window then decodes rounds of ``tokens_per_round`` greedy tokens for the
whole batch, one ``decode_step`` per token, each round starting again
at the context's end with the same first tokens, so every round does the
same work.  A traced run then decodes ``trace_steps`` more steps under
``torch.profiler``.

``correct`` takes a seeded sample of the sessions, one from each
``check_sessions``-th part of the batch, and the last whole round they
decoded; the plain reference runs the context and the served tokens
through the model in float32 (TF32 off) and reads ``logit_gap``: the
widest gap by which a served token's logit lies below the reference's
best at its position.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from portbench import counts, devtrace, reference, weights


def widths_of(cfg: dict) -> dict:
    """The reference's widths from a configuration file's keys."""
    return {"d": cfg["hidden_size"], "n_heads": cfg["num_attention_heads"],
            "n_kv_heads": cfg["num_key_value_heads"],
            "head_dim": cfg["hidden_size"] // cfg["num_attention_heads"],
            "d_ff": cfg["intermediate_size"],
            "n_layers": cfg["num_hidden_layers"],
            "vocab_rows": cfg["vocab_size"], "vocab": cfg["vocab_size"],
            "norm_eps": cfg["layer_norm_eps"],
            "rope_theta": cfg["rope_theta"],
            "tied": cfg["tie_word_embeddings"]}


def port_config(cfg: dict):
    """The port's `ArchConfig` the configuration file names, with its
    overrides, checked against the file's widths."""
    from repro_torch.configs import get_config
    arch = dataclasses.replace(get_config(cfg["port"]["arch"]),
                               **cfg["port"]["overrides"])
    w = widths_of(cfg)
    have = {"d": arch.d_model, "n_heads": arch.n_heads,
            "n_kv_heads": arch.n_kv_heads, "head_dim": arch.head_dim,
            "d_ff": arch.d_ff, "n_layers": arch.n_layers,
            "vocab_rows": arch.padded_vocab, "vocab": arch.vocab,
            "rope_theta": arch.rope_theta, "tied": arch.tie_embeddings}
    bad = {k: (v, w[k]) for k, v in have.items() if v != w[k]}
    if bad or arch.norm != "rms":
        raise ValueError(f"the port's {arch.name} departs from the "
                         f"configuration file: {bad}")
    return arch


def gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token's logit lies below its position's best:
    ``logits (..., vocab)``, ``tokens (...)``; inf for an id outside the
    vocabulary."""
    V = logits.shape[-1]
    ok = (tokens >= 0) & (tokens < V)
    got = torch.gather(logits, -1, tokens.clamp(0, V - 1)[..., None])[..., 0]
    gap = logits.amax(-1) - got
    return torch.where(ok, gap, torch.full_like(gap, float("inf")))


def check(w, widths, ctx, first, steps, rows, *, fp8_control=False):
    """``{"logit_gap"}`` of the served tokens of sessions ``rows``:
    ``first (B,)`` from the prefill and ``steps`` (list of ``(B,)``) from
    the decode steps, after contexts ``ctx (B, S)``; with
    ``fp8_control`` also ``control``, the widest gap of the tokens that
    the reference computed through float8 e4m3 puts first."""
    served = torch.stack([first] + list(steps), dim=1)[rows].long()
    toks = torch.cat([ctx[rows], served[:, :-1]], dim=1)
    S = ctx.shape[1]
    h = reference.dense_hidden(w, widths, toks)[:, S - 1:]
    del toks
    table = weights.head_table(w)
    lg = reference.head_logits(h, table, widths["vocab"])
    out = {"logit_gap": float(gaps(lg, served).max())}
    if fp8_control:
        toks = torch.cat([ctx[rows], served[:, :-1]], dim=1)
        h8 = reference.dense_hidden(w, widths, toks, fp8=True)[:, S - 1:]
        pick = reference.head_logits(h8, table, widths["vocab"],
                                     fp8=True).argmax(-1)
        out["control"] = {"logit_gap": float(gaps(lg, pick).max())}
    return out


def run(run, control: bool = False) -> dict:
    marks = [("start", time.perf_counter())]
    from repro_torch.core.boundedme_torch import draw_perms
    from repro_torch.models.model import build_model
    from repro_torch.models.steps import decode_step, mips_head, prefill_step
    marks.append(("import", time.perf_counter()))
    cfg, tr = run.cell.config, run.cell.traffic
    dev = torch.device(run.device)

    def mark(name):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        marks.append((name, time.perf_counter()))

    arch = port_config(cfg)
    widths = widths_of(cfg)
    B, S, G = tr["sessions"], tr["context"], tr["tokens_per_round"]
    w = weights.dense_weights(widths, run.seed, dev,
                              getattr(torch, cfg["dtype"]))
    model = build_model(arch, device="meta")
    model.load_state_dict(w, strict=True, assign=True)
    ctx = weights.token_ids((B, S), arch.vocab, run.seed, dev, 1)
    mark("weights")

    parts, hids = [], []
    for g0 in range(0, B, tr["prefill_group"]):
        hid, c = prefill_step(model, ctx[g0:g0 + tr["prefill_group"]],
                              cache_len=S + G)
        parts.append(c)
        hids.append(hid)
    del c
    # one layer's cache joined at a time, its parts freed as it goes
    caches = []
    for i in range(len(parts[0])):
        caches.append({k: torch.cat([p[i][k] for p in parts])
                       for k in parts[0][i]})
        for p in parts:
            p[i] = None
    del parts
    mark("prefill")
    head = mips_head(model, arch)
    gen = torch.Generator().manual_seed(weights.derive(run.seed, 9))
    perm0 = draw_perms(head.plan.n_blocks, generator=gen)
    first = head(torch.cat(hids), perm0)[0][:, 0].to(torch.int32)
    del hids, hid
    perms = [draw_perms(head.plan.n_blocks, generator=gen) for _ in range(G)]
    mark("head")

    def step(tok, j):
        nxt, _ = decode_step(model, arch, caches, tok[:, None], S + j,
                             perm=perms[j])
        return nxt

    tok = first
    for j in range(tr["warmup_steps"]):
        tok = step(tok, j)
    mark("warmup")

    rounds, cur = [], []
    tok, j, n_steps = first, 0, 0
    t0 = time.perf_counter()
    t_end = t0 + run.seconds

    def advance():
        nonlocal tok, j, cur, n_steps
        tok = step(tok, j)
        cur.append(tok)
        n_steps += 1
        j += 1
        if j == G:
            rounds.append(cur)
            cur, tok, j = [], first, 0

    flops = 0
    while time.perf_counter() < t_end:
        flops += B * counts.decode_token_flops(
            d=widths["d"], n_heads=widths["n_heads"],
            n_kv_heads=widths["n_kv_heads"], head_dim=widths["head_dim"],
            d_ff=widths["d_ff"], n_layers=widths["n_layers"],
            vocab=widths["vocab"], context=S + j + 1)
        advance()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_stop = time.perf_counter()
    window_steps = n_steps
    summary = None
    if run.trace:
        with devtrace.traced() as prof:
            with devtrace.window():
                for _ in range(tr["trace_steps"]):
                    advance()
                torch.cuda.synchronize(dev)
        summary = devtrace.summarize(prof)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    plan = head.plan
    done = rounds[-1] if rounds else cur
    del model, caches, head, tok
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    rng = np.random.default_rng(weights.derive(run.seed, 8))
    n_check = tr["check_sessions"]
    part = B // n_check
    rows = torch.as_tensor([i * part + int(rng.integers(part))
                            for i in range(n_check)], device=dev)
    got = check(w, widths, ctx, first, done, rows, fp8_control=control)
    t_ref = time.perf_counter() - t_ref
    out = {
        "metrics": {"decode_tok_s": window_steps * B / (t_stop - t0)},
        "attempted": window_steps * B, "failed": 0,
        "checks": {"logit_gap": {"value": got["logit_gap"],
                                 "limit": run.cell.limits["logit_gap"]
                                 ["limit"]}},
        "memory_peak_bytes": peak, "window_start": t0, "trace": summary,
        "info": {"rounds": len(rounds), "steps": window_steps,
                 "checked_tokens": n_check * (len(done) + 1),
                 "reference_s": t_ref,
                 "setup": {b[0]: round(b[1] - a[1], 3)
                           for a, b in zip(marks, marks[1:])}},
        "reading": {"kind": "decode", "trace": summary, "plan": plan,
                    "lanes": B, "table_itemsize":
                        weights.head_table(w).element_size(),
                    "traced_steps": tr["trace_steps"] if run.trace else 0,
                    "window_flops": flops, "window_s": t_stop - t0,
                    "peaks": counts.H100_SXM},
    }
    if run.trace:
        out["card"] = devtrace.card()
    if control:
        out["control"] = got["control"]
    return out
