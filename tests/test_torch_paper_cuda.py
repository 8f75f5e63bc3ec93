"""The paper's algorithms and baselines on the card, against the port's
own CPU run of the same calls.

Every test is marked ``cuda`` and skips without a card.  This file
imports only the port, so it runs where JAX is not installed.  The
tolerances are those of ``tests/test_torch_paper_algos.py`` and
``tests/test_torch_baselines.py``: float64 ids equal and means to rtol
1e-12, float32 means to rtol 1e-6 and ids wherever the CPU run's gap at
every cut exceeds 1e-5 of the largest |mean| there, Fig. 1's counts
equal and its means exact; exact scores to rtol 1e-12, LSH planes, codes
and buckets bitwise, GREEDY's index and candidate list equal, PCA
components equal up to a per-row sign (atol 1e-8) with equal leaves and
answers on a table whose every split is even.  And `bounded_me` on an R
that lives on the card moves nothing to the host: every op it runs
leaves its output on the card.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro_torch.baselines as port
from repro_torch.baselines.greedy_mips import _screen
from repro_torch.baselines.lsh_mips import _codes, _transform_data
from repro_torch.core.bounded_se import bounded_se
from repro_torch.core.boundedme import bounded_me, reward_matrix
from repro_torch.core.median_elim import (median_elimination,
                                          successive_elimination)
from repro_torch.data.synthetic import adversarial_dataset, gaussian_dataset

pytestmark = pytest.mark.cuda

ALGOS = [bounded_me, median_elimination, successive_elimination, bounded_se]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


class _OutputDevices(TorchDispatchMode):
    """Records the device of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.devices = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.devices.add(t.device.type)
        return out


@pytest.mark.parametrize("algo", ALGOS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("K", [1, 3])
def test_float64_card_equals_cpu(card, algo, K):
    R = np.random.default_rng(K).normal(size=(300, 4000))
    a = algo(R, K=K, eps=0.3, delta=0.1, value_range=8.0, device="cpu")
    b = algo(R, K=K, eps=0.3, delta=0.1, value_range=8.0)
    assert b.topk.device.type == "cuda"
    np.testing.assert_array_equal(b.topk.cpu().numpy(), a.topk.numpy())
    np.testing.assert_allclose(b.means.cpu().numpy(), a.means.numpy(),
                               rtol=1e-12, atol=0)
    assert (b.total_pulls, b.rounds) == (a.total_pulls, a.rounds)


def _cut_gap(R: torch.Tensor, sched) -> float:
    """The smallest gap across a cut of the CPU run's trajectory,
    relative to the largest |mean| there."""
    n = R.shape[0]
    alive, sums, t_prev, gap = torch.arange(n), torch.zeros(
        n, dtype=torch.float64), 0, float("inf")
    for rnd in sched.rounds:
        if rnd.t_new > 0:
            sums[alive] += R[alive, t_prev:rnd.t_cum].sum(dim=1)
        t_prev = rnd.t_cum
        means = sums[alive] / max(1, t_prev)
        srt = torch.sort(means, descending=True, stable=True)
        if rnd.n_keep < means.numel():
            gap = min(gap, float((srt.values[rnd.n_keep - 1]
                                  - srt.values[rnd.n_keep])
                                 / srt.values.abs().max()))
        alive = alive[srt.indices[:rnd.n_keep]].sort().values
    return gap


@pytest.mark.parametrize("algo", ALGOS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("seed", [0, 1])
def test_float32_card_equals_cpu(card, algo, seed):
    V, q = gaussian_dataset(300, 2048, seed=seed)
    perm = np.random.default_rng(seed).permutation(V.shape[1])
    R = reward_matrix(V, q, perm, device="cpu")
    Rd = reward_matrix(V, q, perm)
    assert torch.equal(Rd.cpu(), R)
    vr = float(2 * R.abs().max())
    kw = dict(K=3, eps=0.05 * vr, delta=0.1, value_range=vr)
    a, b = algo(R, **kw), algo(Rd, **kw)
    np.testing.assert_allclose(b.means.cpu().numpy(), a.means.numpy(),
                               rtol=1e-6, atol=0)
    assert (b.total_pulls, b.rounds) == (a.total_pulls, a.rounds)
    if algo is bounded_me and _cut_gap(R, a.schedule) > 1e-5:
        assert torch.equal(b.topk.cpu(), a.topk)


@pytest.mark.parametrize("algo", ALGOS[:3], ids=lambda f: f.__name__)
def test_adversarial_card_equals_cpu(card, algo):
    """Fig. 1's R: every partial sum an integer, so both runs take the
    same cuts (ties keep the lowest index on both) and means are exact."""
    R = adversarial_dataset(400, 4000, seed=3)
    a = algo(R, K=1, eps=0.15, delta=0.2, device="cpu")
    b = algo(R, K=1, eps=0.15, delta=0.2)
    assert (b.total_pulls, b.rounds) == (a.total_pulls, a.rounds)
    assert torch.equal(b.topk.cpu(), a.topk)
    assert torch.equal(b.means.cpu(), a.means)


def test_bounded_me_keeps_everything_on_the_card(card):
    V, q = gaussian_dataset(500, 4096, seed=2)
    R = reward_matrix(torch.from_numpy(V).to(card), torch.from_numpy(q).to(
        card), np.random.default_rng(0).permutation(4096))
    watch = _OutputDevices()
    with watch:
        res = bounded_me(R, K=4, eps=0.5, delta=0.1,
                         value_range=float(2 * R.abs().max()))
    assert watch.devices == {"cuda"}
    assert res.topk.device == R.device and res.means.device == R.device
    ref = bounded_me(R.cpu(), K=4, eps=0.5, delta=0.1,
                     value_range=float(2 * R.abs().max()))
    np.testing.assert_allclose(res.means.cpu().numpy(), ref.means.numpy(),
                               rtol=1e-6, atol=0)


@pytest.fixture
def data():
    rng = np.random.default_rng(0)
    return rng.normal(size=(1500, 96)), rng.normal(size=96)


def _same_result(a, b):
    assert b.topk.device.type == "cuda"
    assert torch.equal(b.topk.cpu(), a.topk)
    np.testing.assert_allclose(b.scores.cpu().numpy(), a.scores.numpy(),
                               rtol=1e-12, atol=0)
    assert (b.query_multiplies, b.preprocess_multiplies, b.candidates) == (
        a.query_multiplies, a.preprocess_multiplies, a.candidates)


def test_exact_card_equals_cpu(card, data):
    V, q = data
    _same_result(port.exact_mips(V, q, K=5, device="cpu"),
                 port.exact_mips(V, q, K=5))


@pytest.mark.parametrize("a_bits,b_tables", [(4, 48), (12, 8)])
def test_lsh_card_equals_cpu(card, data, a_bits, b_tables):
    V, q = data
    ci = port.build_lsh(V, a=a_bits, b=b_tables, seed=1, device="cpu")
    di = port.build_lsh(V, a=a_bits, b=b_tables, seed=1)
    assert torch.equal(di.planes.cpu(), ci.planes)
    Vt, _ = _transform_data(torch.from_numpy(V))
    assert torch.equal(_codes(di.planes, Vt.to(card)).cpu(),
                       _codes(ci.planes, Vt))
    assert torch.equal(di.codes.cpu(), ci.codes)
    assert torch.equal(di.ids.cpu(), ci.ids)
    for qq in [q, *np.random.default_rng(1).normal(size=(4, 96))]:
        _same_result(port.lsh_mips(ci, qq, K=5), port.lsh_mips(di, qq, K=5))


@pytest.mark.parametrize("budget", [10, 400, 1500])
def test_greedy_card_equals_cpu(card, data, budget):
    V, q = data
    ci, di = port.build_greedy(V, device="cpu"), port.build_greedy(V)
    assert torch.equal(di.order_desc.cpu(), ci.order_desc)
    assert _screen(di, q, budget) == _screen(ci, q, budget)
    _same_result(port.greedy_mips(ci, q, K=5, budget=budget),
                 port.greedy_mips(di, q, K=5, budget=budget))


def _leaves(node, out):
    if node.ids is not None:
        out.add(frozenset(node.ids.tolist()))
    else:
        _leaves(node.left, out)
        _leaves(node.right, out)
    return out


def test_pca_card_equals_cpu(card, data):
    V, _ = data
    ct = port.build_pca_tree(V, depth=6, device="cpu")
    dt = port.build_pca_tree(V, depth=6)
    got, want = dt.components.cpu().numpy(), ct.components.numpy()
    sign = np.sign((got * want).sum(axis=1))
    np.testing.assert_allclose(got * sign[:, None], want, rtol=0, atol=1e-8)
    assert dt.preprocess_multiplies == ct.preprocess_multiplies
    # every split even: a flipped component mirrors its splits exactly
    W = np.random.default_rng(3).normal(size=(1024, 64))
    ct, dt = (port.build_pca_tree(W, depth=4, device=d)
              for d in ("cpu", "cuda"))
    assert _leaves(dt.root, set()) == _leaves(ct.root, set())
    for spill in (0.0, 1e9):
        for qq in np.random.default_rng(4).normal(size=(5, 64)):
            a = port.pca_mips(ct, qq, K=5, spill=spill)
            b = port.pca_mips(dt, qq, K=5, spill=spill)
            assert b.candidates == a.candidates
            _same_result(a, b)
