"""The paper's reference algorithms in the port (`repro_torch.core`'s
`boundedme`, `median_elim`, `bounded_se`) against the JAX package's
(``repro.core``), on the CPU and on the same reward matrices.

Permutations are drawn with numpy and handed to both packages.
Tolerances:

* float64 Gaussian R (n <= 300, N <= 4000), K in {1, 3): ids and their
  order equal, means to rtol 1e-12 (float64 sums in another order),
  ``total_pulls`` and ``rounds`` exactly equal;
* float32 R (a MIPS reward matrix): means to rtol 1e-6 (each round's
  float32 sum is taken in another order than numpy's pairwise one), ids
  equal wherever the reference's own gap at every cut exceeds 1e-5 of the
  largest |mean| there;
* Fig. 1's adversarial R (400 x 4000): ``total_pulls`` and ``rounds``
  equal, each returned arm's mean exact (every partial sum is an integer
  below 2^24), and the guarantee over seeds as ``tests/test_boundedme.py``
  checks it.  Ties are everywhere there and both packages may return
  different arms (the port keeps the lowest index, numpy's
  ``argpartition`` an unspecified one), so ids are not compared.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import bounded_me as jax_bounded_me
from repro.core import median_elimination as jax_median_elimination
from repro.core import reward_matrix as jax_reward_matrix
from repro.core import successive_elimination as jax_successive_elimination
from repro.core.bounded_se import bounded_se as jax_bounded_se
from repro_torch.core.bounded_se import bounded_se
from repro_torch.core.boundedme import bounded_me, reward_matrix, top_order
from repro_torch.core.median_elim import (median_elimination,
                                          successive_elimination)
from repro_torch.core.schedule import make_schedule
from repro_torch.data.synthetic import adversarial_dataset, gaussian_dataset

ALGOS = {
    "bounded_me": (jax_bounded_me, bounded_me),
    "median_elimination": (jax_median_elimination, median_elimination),
    "successive_elimination": (jax_successive_elimination,
                               successive_elimination),
    "bounded_se": (jax_bounded_se, bounded_se),
}


def _gauss(n, N, seed, dtype=np.float64):
    return np.random.default_rng(seed).normal(size=(n, N)).astype(dtype)


def _run(name, R, **kw):
    ref, port = ALGOS[name]
    return ref(R, **kw), port(R, device="cpu", **kw)


@pytest.mark.parametrize("name", list(ALGOS))
@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("n,N,eps,seed", [(300, 4000, 0.3, 0),
                                          (200, 1500, 0.15, 1),
                                          (57, 999, 0.6, 2)])
def test_float64_gaussian_equal(name, K, n, N, eps, seed):
    R = _gauss(n, N, seed)
    a, b = _run(name, R, K=K, eps=eps, delta=0.1, value_range=8.0)
    np.testing.assert_array_equal(b.topk.numpy(), a.topk)
    assert b.means.dtype == torch.float64
    np.testing.assert_allclose(b.means.numpy(), a.means, rtol=1e-12, atol=0)
    assert (b.total_pulls, b.rounds) == (a.total_pulls, a.rounds)
    assert isinstance(b.total_pulls, int) and isinstance(b.rounds, int)
    assert ([dataclasses.astuple(r) for r in b.schedule.rounds]
            == [dataclasses.astuple(r) for r in a.schedule.rounds])
    if name == "bounded_me":
        sched = make_schedule(n, N, K=K, eps=eps, delta=0.1, value_range=8.0)
        assert b.total_pulls == sched.total_pulls
        assert b.rounds == len(sched.rounds)


def _reference_cut_gaps(R, sched):
    """The reference's trajectory in numpy (its float64 sums, its cut),
    with the smallest gap across each cut, relative to the largest
    |mean| there; returns (final ids, smallest relative gap)."""
    n = R.shape[0]
    alive, sums, t_prev, gap = np.arange(n), np.zeros(n), 0, np.inf
    for rnd in sched.rounds:
        if rnd.t_new > 0:
            sums[alive] += R[alive, t_prev:rnd.t_cum].sum(axis=1)
        t_prev = rnd.t_cum
        means = sums[alive] / max(1, t_prev)
        srt = np.sort(means)[::-1]
        if rnd.n_keep < srt.size:
            gap = min(gap, (srt[rnd.n_keep - 1] - srt[rnd.n_keep])
                      / np.abs(srt).max())
        alive = alive[np.argpartition(-means, rnd.n_keep - 1)[:rnd.n_keep]]
    final = sums[alive] / max(1, t_prev)
    return alive[np.argsort(-final)[:sched.K]], gap


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("seed", range(4))
def test_float32_reward_matrix(K, seed):
    V, q = gaussian_dataset(300, 2048, seed=seed)
    perm = np.random.default_rng(seed).permutation(V.shape[1])
    R = reward_matrix(V, q, perm, device="cpu").numpy()
    assert R.dtype == np.float32
    vr = float(2 * np.abs(R).max())
    a, b = _run("bounded_me", R, K=K, eps=0.05 * vr, delta=0.1,
                value_range=vr)
    np.testing.assert_allclose(b.means.numpy(), a.means, rtol=1e-6, atol=0)
    assert (b.total_pulls, b.rounds) == (a.total_pulls, a.rounds)
    ids, gap = _reference_cut_gaps(R, a.schedule)
    np.testing.assert_array_equal(ids, a.topk)
    if gap > 1e-5:
        np.testing.assert_array_equal(b.topk.numpy(), a.topk)


@pytest.mark.parametrize("name", list(ALGOS))
def test_float32_means_and_counts(name):
    R = _gauss(200, 3000, 5, np.float32) + np.float32(0.5)
    a, b = _run(name, R, K=3, eps=0.4, delta=0.1, value_range=8.0)
    np.testing.assert_allclose(b.means.numpy(), a.means, rtol=1e-6, atol=0)
    assert (b.total_pulls, b.rounds) == (a.total_pulls, a.rounds)


@pytest.mark.parametrize("name", ["bounded_me", "median_elimination",
                                  "successive_elimination"])
@pytest.mark.parametrize("seed", [0, 7])
def test_adversarial_counts_and_exact_means(name, seed):
    R = adversarial_dataset(400, 4000, seed=seed)
    a, b = _run(name, R, K=1, eps=0.15, delta=0.2)
    assert (b.total_pulls, b.rounds) == (a.total_pulls, a.rounds)
    # every partial sum is an integer: the returned means are exact
    if name == "bounded_me":
        t = a.schedule.final_pulls
        want = R[b.topk.numpy(), :t].astype(np.float64).sum(axis=1) / t
        np.testing.assert_array_equal(b.means.numpy(), want)


def test_adversarial_bounded_se_counts():
    """BoundedSE under a uniform pull order (its model) on Fig. 1's
    values: the counts are equal."""
    rng = np.random.default_rng(9)
    R = rng.permuted(adversarial_dataset(400, 4000, seed=9), axis=1)
    a, b = _run("bounded_se", R, K=1, eps=0.05, delta=0.1)
    assert (b.total_pulls, b.rounds) == (a.total_pulls, a.rounds)
    np.testing.assert_array_equal(b.means.numpy(), a.means)


def test_guarantee_adversarial():
    """Paper Fig. 1 in miniature, as ``tests/test_boundedme.py``:
    suboptimality < eps at >= 1 - delta rate."""
    n, N = 400, 4000
    eps, delta = 0.15, 0.2
    fails, trials = 0, 25
    for t in range(trials):
        R = adversarial_dataset(n, N, seed=t)
        means = R.mean(axis=1)
        res = bounded_me(R, K=1, eps=eps, delta=delta, value_range=1.0,
                         device="cpu")
        sched = make_schedule(n, N, K=1, eps=eps, delta=delta)
        assert (res.total_pulls, res.rounds) == (sched.total_pulls,
                                                 len(sched.rounds))
        if means.max() - means[int(res.topk[0])] >= eps:
            fails += 1
    assert fails / trials <= delta + 0.12


def test_adversarial_ties_keep_the_lowest_index():
    """Every arm with at least t ones has mean 1.0 after t pulls: among
    the ties of each cut the port keeps the lowest arm index."""
    R = np.zeros((64, 256), np.float32)
    R[:, :200] = 1.0                     # every arm ties throughout
    res = bounded_me(R, K=3, eps=0.5, delta=0.2, device="cpu")
    np.testing.assert_array_equal(res.topk.numpy(), [0, 1, 2])
    np.testing.assert_array_equal(top_order(torch.tensor([1., 2., 2., 0.]),
                                            3).numpy(), [1, 2, 0])


@pytest.mark.parametrize("name", ["bounded_me", "bounded_se"])
@pytest.mark.parametrize("K", [5, 7])
def test_k_at_least_n_returns_everything(name, K):
    R = _gauss(5, 300, 3)
    a, b = _run(name, R, K=K, eps=0.2, delta=0.1)
    np.testing.assert_array_equal(b.topk.numpy(), a.topk)
    np.testing.assert_allclose(b.means.numpy(), a.means, rtol=1e-12, atol=0)
    assert (b.total_pulls, b.rounds) == (a.total_pulls, a.rounds) == (0, 0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_reward_matrix_with_perm_is_numpys(dtype):
    rng = np.random.default_rng(4)
    V = rng.normal(size=(33, 517)).astype(dtype)
    q = rng.normal(size=517).astype(dtype)
    want = jax_reward_matrix(V, q, np.random.default_rng(11))
    perm = np.random.default_rng(11).permutation(517)
    got = reward_matrix(V, q, perm, device="cpu")
    assert got.dtype == torch.from_numpy(want).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    # a tensor operand is worked on its own device
    got_t = reward_matrix(torch.from_numpy(V), torch.from_numpy(q), perm)
    assert got_t.device.type == "cpu"
    np.testing.assert_array_equal(got_t.numpy(), want)


def test_reward_matrix_generator_draws_a_permutation():
    V = np.arange(12.0).reshape(2, 6)
    q = np.ones(6)
    a = reward_matrix(V, q, device="cpu")
    b = reward_matrix(V, q, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    assert torch.equal(a, b)
    assert sorted(a[0].tolist()) == V[0].tolist()


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    R = _gauss(20, 100, 0)
    for name, (_, port) in ALGOS.items():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port(R)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port(torch.from_numpy(R), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        reward_matrix(R, R[0], np.arange(100))
