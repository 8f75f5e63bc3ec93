"""The port's MIPS baselines (`repro_torch.baselines`) against the JAX
package's (``repro.baselines``), on the CPU, at the fixture of
``tests/test_baselines.py`` (1500 x 96, float64).

Tolerances:

* exact: ids equal, scores to rtol 1e-12 (a float64 product summed in
  another order);
* LSH: the planes and every code bitwise (the planes are the same numpy
  draw; a code is a pattern of signs), each table's buckets equal, the
  candidate set, the top K and every counter equal;
* GREEDY: the candidate list in order, the top K and the cost equal (the
  screening is the reference's heap walk over the same index);
* PCA: components equal up to a per-row sign (atol 1e-8); leaf
  partitions equal as sets on a 1024-row table at depth 4, where every
  split is even (so a flipped component mirrors a split exactly);
  candidates and top K equal at spill 0 and 1e9; the preprocessing
  counters equal.
"""

import importlib

import numpy as np
import pytest
import torch

import repro.baselines as ref
import repro_torch.baselines as port
from repro_torch.baselines.lsh_mips import _codes, _transform_query

# the modules (each package's namespace exports a function of that name)
ref_greedy = importlib.import_module("repro.baselines.greedy_mips")
ref_lsh = importlib.import_module("repro.baselines.lsh_mips")
port_greedy = importlib.import_module("repro_torch.baselines.greedy_mips")
port_pca = importlib.import_module("repro_torch.baselines.pca_mips")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    V = rng.normal(size=(1500, 96)).astype(np.float64)
    q = rng.normal(size=96)
    return V, q


def _queries(n, dim=96, seed=1):
    return np.random.default_rng(seed).normal(size=(n, dim))


def _same_result(a, b, rtol=1e-12):
    np.testing.assert_array_equal(b.topk.numpy(), a.topk)
    np.testing.assert_allclose(b.scores.numpy(), a.scores, rtol=rtol, atol=0)
    assert (b.query_multiplies, b.preprocess_multiplies, b.candidates) == (
        a.query_multiplies, a.preprocess_multiplies, a.candidates)
    for c in (b.query_multiplies, b.preprocess_multiplies, b.candidates):
        assert isinstance(c, int)


@pytest.mark.parametrize("K", [1, 5, 1500])
def test_exact(data, K):
    V, q = data
    a = ref.exact_mips(V, q, K=K)
    b = port.exact_mips(V, q, K=K, device="cpu")
    _same_result(a, b)


def test_exact_promotes_like_numpy():
    """A float32 table against a float64 query: a float64 product."""
    rng = np.random.default_rng(2)
    V = rng.normal(size=(300, 40)).astype(np.float32)
    q = rng.normal(size=40)
    a = ref.exact_mips(V, q, K=4)
    b = port.exact_mips(V, q, K=4, device="cpu")
    assert b.scores.dtype == torch.float64
    _same_result(a, b)


@pytest.mark.parametrize("a_bits,b_tables", [(4, 48), (8, 16), (12, 8)])
def test_lsh_index_bitwise(data, a_bits, b_tables):
    V, _ = data
    ji = ref.build_lsh(V, a=a_bits, b=b_tables, seed=1)
    ti = port.build_lsh(V, a=a_bits, b=b_tables, seed=1, device="cpu")
    np.testing.assert_array_equal(ti.planes.numpy(), ji.planes)
    Vt, _ = ref_lsh._transform_data(V)
    want = ref_lsh._codes(ji.planes, Vt)
    got = _codes(ti.planes, torch.from_numpy(Vt))
    np.testing.assert_array_equal(got.numpy(), want)
    assert ti.preprocess_multiplies == ji.preprocess_multiplies
    # each table's CSR row is the reference's dict: the same buckets, each
    # listing its rows in the same (index) order
    for t, table in enumerate(ji.tables):
        codes, ids = ti.codes[t].numpy(), ti.ids[t].numpy()
        assert (np.diff(codes) >= 0).all()
        assert np.unique(codes).tolist() == sorted(table)
        for code, rows in table.items():
            np.testing.assert_array_equal(ids[codes == code], rows)


@pytest.mark.parametrize("a_bits,b_tables", [(4, 48), (8, 16), (12, 8),
                                             (16, 2)])
def test_lsh_query_equal(data, a_bits, b_tables):
    V, q = data
    ji = ref.build_lsh(V, a=a_bits, b=b_tables, seed=1)
    ti = port.build_lsh(V, a=a_bits, b=b_tables, seed=1, device="cpu")
    for qq in [q, *_queries(6)]:
        qcode = ref_lsh._codes(ji.planes,
                               ref_lsh._transform_query(qq)[None, :])[0]
        tcode = _codes(ti.planes, _transform_query(torch.from_numpy(qq))[
            None, :])[0]
        np.testing.assert_array_equal(tcode.numpy(), qcode)
        _same_result(ref.lsh_mips(ji, qq, K=5), port.lsh_mips(ti, qq, K=5))


def test_lsh_no_candidates():
    """A query whose buckets are all empty: no candidates, in both."""
    rng = np.random.default_rng(5)
    V = rng.normal(size=(4, 8))
    q = rng.normal(size=8)
    ji = ref.build_lsh(V, a=16, b=1, seed=3)
    ti = port.build_lsh(V, a=16, b=1, seed=3, device="cpu")
    a, b = ref.lsh_mips(ji, q, K=2), port.lsh_mips(ti, q, K=2)
    assert a.candidates == b.candidates == 0
    assert b.topk.numel() == 0 and b.scores.numel() == 0
    assert b.topk.dtype == torch.int64
    assert a.query_multiplies == b.query_multiplies


@pytest.mark.parametrize("budget", [1, 10, 100, 1000, 1500])
def test_greedy_equal(data, budget):
    V, q = data
    ji = ref.build_greedy(V)
    ti = port.build_greedy(V, device="cpu")
    np.testing.assert_array_equal(ti.order_desc.numpy(), ji.order_desc)
    assert ti.preprocess_multiplies == ji.preprocess_multiplies
    for qq in [q, *_queries(3, seed=budget)]:
        a = ref.greedy_mips(ji, qq, K=5, budget=budget)
        b = port.greedy_mips(ti, qq, K=5, budget=budget)
        _same_result(a, b)


class _NumpySpy:
    """Stands in for the reference module's ``np``: records the
    candidate list its screening hands to ``np.asarray``."""

    def __init__(self):
        self.lists = []

    def __getattr__(self, name):
        return getattr(np, name)

    def asarray(self, x, *args, **kw):
        self.lists.append(list(x))
        return np.asarray(x, *args, **kw)


@pytest.mark.parametrize("budget", [7, 64, 400])
def test_greedy_candidate_list_in_order(data, monkeypatch, budget):
    V, q = data
    ji, ti = ref.build_greedy(V), port.build_greedy(V, device="cpu")
    spy = _NumpySpy()
    monkeypatch.setattr(ref_greedy, "np", spy)
    a = ref.greedy_mips(ji, q, K=3, budget=budget)
    monkeypatch.undo()
    cand, cost = port_greedy._screen(ti, q, budget)
    assert cand == spy.lists[-1] and len(cand) == budget
    assert cost + len(cand) * V.shape[1] == a.query_multiplies


def test_pca_components_up_to_sign(data):
    V, _ = data
    ji = ref.build_pca_tree(V, depth=6)
    ti = port.build_pca_tree(V, depth=6, device="cpu")
    got = ti.components.numpy()
    assert got.shape == ji.components.shape
    sign = np.sign((got * ji.components).sum(axis=1))
    np.testing.assert_allclose(got * sign[:, None], ji.components, rtol=0,
                               atol=1e-8)
    assert ti.preprocess_multiplies == ji.preprocess_multiplies
    assert ti.depth == ji.depth


def _leaves(node, out):
    if node.ids is not None:
        out.append(frozenset(np.asarray(node.ids).tolist()))
    else:
        _leaves(node.left, out)
        _leaves(node.right, out)
    return out


def test_pca_leaf_partitions_even_splits():
    V = np.random.default_rng(3).normal(size=(1024, 64))
    ji = ref.build_pca_tree(V, depth=4)
    ti = port.build_pca_tree(V, depth=4, device="cpu")
    a = set(_leaves(ji.root, []))
    b = set(_leaves(ti.root, []))
    assert len(a) == 16 and all(len(x) == 64 for x in a)
    assert a == b


@pytest.mark.parametrize("depth", [4, 6])
@pytest.mark.parametrize("spill", [0.0, 1e9])
def test_pca_query_equal(data, depth, spill):
    V, q = data
    ji = ref.build_pca_tree(V, depth=depth)
    ti = port.build_pca_tree(V, depth=depth, device="cpu")
    for qq in [q, *_queries(4, seed=depth)]:
        _same_result(ref.pca_mips(ji, qq, K=5, spill=spill),
                     port.pca_mips(ti, qq, K=5, spill=spill))


def test_pca_median_is_numpys():
    median = port_pca._median
    for vals in ([3.0, 1.0, 2.0], [4.0, 1.0, 3.0, 2.0], [0.1, 0.7]):
        assert median(torch.tensor(vals, dtype=torch.float64)) == float(
            np.median(vals))
    v32 = np.array([0.1, 0.7, 0.3, 0.9], np.float32)
    assert median(torch.from_numpy(v32)) == float(np.median(v32))


def test_tensor_operands_stay_on_their_device(data):
    V, q = data
    Vt = torch.from_numpy(V)
    for res in (port.exact_mips(Vt, q, K=2),
                port.lsh_mips(port.build_lsh(Vt, a=4, b=4), q),
                port.greedy_mips(port.build_greedy(Vt), q),
                port.pca_mips(port.build_pca_tree(Vt, depth=3), q)):
        assert res.topk.device.type == "cpu"


def test_entry_points_raise_without_cuda(monkeypatch, data):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    V, q = data
    for call in (lambda: port.exact_mips(V, q),
                 lambda: port.build_lsh(V),
                 lambda: port.build_greedy(V),
                 lambda: port.build_pca_tree(V),
                 lambda: port.exact_mips(torch.from_numpy(V), q,
                                         device="cuda")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
