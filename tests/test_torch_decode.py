"""The port's `bounded_me_decode` against the JAX package's, end to end.

Both get the same table, queries, plan and block permutation: the port
takes ``perm = jax.random.permutation(key, n_blocks)`` explicitly, the
JAX package draws it from ``key``.  The JAX side runs its jnp fallback
and its Pallas kernel (interpret mode); the port runs on the CPU, i.e.
its plain PyTorch cascade, with ``final_exact=True`` as the serving
engine calls it.  Ids must be equal; scores agree to rtol 1e-5 and atol
1e-6 * max|score| (fp32 sums in another order — the JAX package's own
fallback sums final scores in one exact rescore, its kernel by coverage
pulls).
"""

import jax
import numpy as np
import pytest
import torch

from repro.core.boundedme_jax import bounded_me_decode as jax_decode
from repro.core.boundedme_jax import make_plan as jax_make_plan
from repro_torch.core.boundedme_torch import bounded_me_decode, make_plan


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    scale = float(np.abs(want[fin]).max())
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5,
                               atol=1e-6 * scale)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("mode,n,N,K,n_valid", [
    ("row", 301, 700, 4, 290),
    ("coord", 301, 700, 4, 290),
    ("row", 1024, 256, 8, 1024),
    ("coord", 517, 384, 3, 500),
])
def test_decode_matches_jax(mode, n, N, K, n_valid, use_pallas):
    rng = np.random.default_rng(n + N)
    V = (0.02 * rng.normal(size=(n, N))).astype(np.float32)
    Q = rng.normal(size=(4, N)).astype(np.float32)
    kw = dict(K=K, eps=0.3, delta=0.1, value_range=2.0 * float(
        np.abs(V).max()), block=128, pull_mode=mode, coord_block=64)
    jplan, plan = jax_make_plan(n, N, **kw), make_plan(n, N, **kw)
    key = jax.random.PRNGKey(7)
    perm = np.array(jax.random.permutation(key, plan.n_blocks))
    jids, jvals = jax_decode(V, Q, key, plan=jplan, use_pallas=use_pallas,
                             n_valid=n_valid)
    ids, vals = bounded_me_decode(V, Q, torch.from_numpy(perm), plan=plan,
                                  n_valid=n_valid, device="cpu")
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(vals.numpy(), jvals)
    # final_exact: the scores are the exact mean products of the ids
    exact = np.einsum("bkn,bn->bk", V[ids.numpy()].astype(np.float64),
                      Q.astype(np.float64)) / N
    np.testing.assert_allclose(vals.numpy(), exact, rtol=1e-4, atol=1e-7)
