"""The plain reference at tiny sizes on the CPU against NumPy brute force:
exact top-K, the dense decoder's forward pass and its head, and the
lower precisions the controls use."""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import reference, weights


def test_exact_topk_against_numpy():
    g = torch.Generator().manual_seed(5)
    V = torch.randn((1000, 48), generator=g).to(torch.bfloat16)
    Q = torch.randn((9, 48), generator=g)
    ids, s = reference.exact_topk(Q, V, 7, block_rows=128)
    full = Q.double().numpy() @ V.double().numpy().T
    want = np.argsort(-full, axis=1, kind="stable")[:, :7]
    assert (ids.numpy() == want).all()
    np.testing.assert_allclose(s.numpy(),
                               np.take_along_axis(full, want, 1), rtol=1e-12)
    np.testing.assert_allclose(
        reference.scores_of(Q, V, ids).numpy(),
        np.take_along_axis(full, want, 1), rtol=1e-12)
    tid, ts = reference.exact_topk(Q, V, 7, tf32=True)
    assert (tid.numpy()[:, 0] == want[:, 0]).all()
    err = np.abs(ts.double().numpy() - np.take_along_axis(full, want, 1))
    assert 0 < err.max() < 1e-2


def test_lower_precisions():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -12, -3.0 - 2 ** -9,
                      1.0 + 3 * 2 ** -11])
    assert reference.round_tf32(x).tolist() == [
        1.0, 1.0 + 2 ** -10, 1.0, -3.0 - 2 ** -9, 1.0 + 2 * 2 ** -10]
    y = torch.randn(4, 1000, generator=torch.Generator().manual_seed(1))
    r = reference.round_fp8(y, -1)
    rel = ((r - y).abs() / y.abs()).masked_fill(y.abs() < 1e-2, 0)
    assert 0 < rel.max() <= 2 ** -4 + 1e-6
    assert (r.abs().amax(-1) == y.abs().amax(-1)).all()


def _numpy_decoder(w, widths, tokens):
    """The same decoder, one position and one head at a time, float64."""
    H, KV, D = widths["n_heads"], widths["n_kv_heads"], widths["head_dim"]
    eps, G = widths["norm_eps"], H // KV
    W = {k: v.double().numpy() for k, v in w.items()}

    def rms(x, g):
        return x / np.sqrt((x * x).mean() + eps) * g

    S = len(tokens)
    xs = [W["embed"][t].copy() for t in tokens]
    half = D // 2
    inv = np.exp(-math.log(widths["rope_theta"]) * np.arange(half) / half)

    def rope(v, p):
        a = p * inv
        return np.concatenate([v[:half] * np.cos(a) - v[half:] * np.sin(a),
                               v[:half] * np.sin(a) + v[half:] * np.cos(a)])

    for i in range(widths["n_layers"]):
        L = {n: W[f"layers.{i}.{n}"] for n in ("wq", "wk", "wv", "wo",
                                              "w_gate", "w_up", "w_down",
                                              "ln1_w", "ln2_w")}
        hs = [rms(x, L["ln1_w"]) for x in xs]
        q = [[rope((h @ L["wq"])[j * D:(j + 1) * D], p) for j in range(H)]
             for p, h in enumerate(hs)]
        k = [[rope((h @ L["wk"])[j * D:(j + 1) * D], p) for j in range(KV)]
             for p, h in enumerate(hs)]
        v = [[(h @ L["wv"])[j * D:(j + 1) * D] for j in range(KV)]
             for h in hs]
        new = []
        for p in range(S):
            o = []
            for j in range(H):
                sc = np.array([q[p][j] @ k[t][j // G] / math.sqrt(D)
                               for t in range(p + 1)])
                a = np.exp(sc - sc.max())
                a /= a.sum()
                o.append(sum(a[t] * v[t][j // G] for t in range(p + 1)))
            x = xs[p] + np.concatenate(o) @ L["wo"]
            h = rms(x, L["ln2_w"])
            g = h @ L["w_gate"]
            new.append(x + (g / (1 + np.exp(-g)) * (h @ L["w_up"]))
                       @ L["w_down"])
        xs = new
    return np.stack([rms(x, W["final_w"]) for x in xs])


def test_dense_decoder_against_numpy():
    widths = {"d": 32, "n_heads": 4, "n_kv_heads": 2, "head_dim": 8,
              "d_ff": 48, "n_layers": 2, "vocab_rows": 64, "vocab": 60,
              "norm_eps": 1e-6, "rope_theta": 1e4, "tied": False}
    w = weights.dense_weights(widths, 11, "cpu", torch.float32)
    tokens = weights.token_ids((2, 9), 60, 11, "cpu")
    h = reference.dense_hidden(w, widths, tokens, chunk=4)
    for b in range(2):
        want = _numpy_decoder(w, widths, tokens[b].tolist())
        np.testing.assert_allclose(h[b].double().numpy(), want, rtol=2e-5,
                                   atol=2e-5)
    lg = reference.head_logits(h, w["unembed"], 60, block_rows=16)
    assert lg.shape == (2, 9, 60)
    np.testing.assert_allclose(
        lg.numpy(), h.numpy() @ w["unembed"][:60].numpy().T, rtol=1e-5,
        atol=1e-5)
    h8 = reference.dense_hidden(w, widths, tokens, fp8=True)
    gap = (h8 - h).norm() / h.norm()
    assert 1e-3 < gap < 0.5
