"""Inputs made from ``--seed``: derived seeds, a seeded item table, the
dense model's weights and token ids, all drawn on the device in a few
large calls in the type they are served in.

The benchmark makes these and hands the same tensors to the program and
to the reference; neither side makes its own.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch


def derive(seed: int, *path: int) -> int:
    """A 63-bit seed for one use of ``seed`` (``path`` names the use)."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), *map(int, path)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, device, *path: int) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(
        derive(seed, *path))


def seeded_table(rows: int, dim: int, std: float, dtype: torch.dtype,
                 seed: int, device) -> torch.Tensor:
    """``(rows, dim)`` of N(0, std^2) in ``dtype``, one draw."""
    g = generator(seed, device, 1)
    return torch.randn((rows, dim), generator=g, device=device,
                       dtype=dtype).mul_(std)


# (name, shape as a function of the widths, fan-in) of one dense layer's
# matrices, in the order they are drawn
def _layer_mats(d: int, H: int, KV: int, D: int, f: int):
    return (("wq", (d, H * D), d), ("wk", (d, KV * D), d),
            ("wv", (d, KV * D), d), ("wo", (H * D, d), H * D),
            ("w_gate", (d, f), d), ("w_up", (d, f), d),
            ("w_down", (f, d), f))


def dense_weights(widths: dict, seed: int, device,
                  dtype: torch.dtype = torch.bfloat16
                  ) -> Dict[str, torch.Tensor]:
    """Weights of a dense decoder under the names ``embed``, ``unembed``
    (left out where ``widths["tied"]``: the head reads ``embed``),
    ``final_w`` and ``layers.{i}.{wq,wk,wv,wo,w_gate,w_up,w_down,ln1_w,
    ln2_w}``; the matrices ``(d_in, d_out)``, applied as ``x @ w``.

    Each layer's matrices are one N(0, 1) draw in ``dtype``, each part
    scaled by 1 / sqrt(its fan-in); the embedding and unembedding are
    N(0, 0.02^2) draws; norm weights are f32 ones.  ``widths`` holds
    ``d, n_heads, n_kv_heads, head_dim, d_ff, n_layers, vocab_rows,
    tied``.
    """
    d, H, KV, D = (widths[k] for k in ("d", "n_heads", "n_kv_heads",
                                       "head_dim"))
    f, L, V = widths["d_ff"], widths["n_layers"], widths["vocab_rows"]
    dev = torch.device(device)
    w: Dict[str, torch.Tensor] = {}
    tables = ("embed",) if widths["tied"] else ("embed", "unembed")
    for j, name in enumerate(tables):
        g = generator(seed, dev, 2, j)
        w[name] = torch.randn((V, d), generator=g, device=dev,
                              dtype=dtype).mul_(0.02)
    w["final_w"] = torch.ones((d,), device=dev)
    mats = _layer_mats(d, H, KV, D, f)
    total = sum(math.prod(s) for _, s, _ in mats)
    for i in range(L):
        g = generator(seed, dev, 3, i)
        flat = torch.randn((total,), generator=g, device=dev, dtype=dtype)
        off = 0
        for name, shape, fan_in in mats:
            n = math.prod(shape)
            w[f"layers.{i}.{name}"] = (flat[off:off + n].view(shape)
                                       .mul_(1.0 / math.sqrt(fan_in)))
            off += n
        for name in ("ln1_w", "ln2_w"):
            w[f"layers.{i}.{name}"] = torch.ones((d,), device=dev)
    return w


def head_table(w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The table of the logits: ``unembed``, or the tied ``embed``."""
    return w.get("unembed", w["embed"])


def token_ids(shape: Tuple[int, ...], vocab: int, seed: int, device,
              *path: int) -> torch.Tensor:
    """Uniform ids in ``[0, vocab)``, int64, drawn on ``device``."""
    g = generator(seed, device, 4, *path)
    return torch.randint(0, vocab, shape, generator=g, device=device)
