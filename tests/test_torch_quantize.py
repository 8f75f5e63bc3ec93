"""The port's codecs (`repro_torch.core.quantize`) against the JAX
package's (`repro.core.quantize`), on the same numpy inputs.

* int8 and int4 codes and scales, and blocked query codes and scales,
  are bitwise equal: both round half to even after a true division.
* `pack_int4`/`unpack_int4` round-trip, and the packed bytes are equal
  (half-split layout).
* `pq_encode` gives equal codes when the reference codebook is injected
  through `quantized_from_jax`; `pq_train` codebooks agree to rtol 1e-5
  and atol 1e-6 (the distance products sum in another order);
  `pq_decode`, `pq_tile_dot` and `measured_quant_err` on the same
  injected codes and queries agree to rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import boundedme_jax as bj
from repro.core import quantize as jq
from repro_torch.convert import quantized_from_jax
from repro_torch.core import boundedme_torch as bt
from repro_torch.core import quantize as tq

# (n_tiles, n_blocks, R, C): ragged widths, one or several blocks
SHAPES = [(13, 3, 8, 64), (5, 1, 4, 96), (40, 2, 8, 128)]


def _table(shape, seed, zero_cell=True):
    rng = np.random.default_rng(seed)
    V4 = rng.normal(size=shape).astype(np.float32)
    V4[0, 0, 0, 0] = 5.0                 # one large entry coarsens one cell
    if zero_cell:
        V4[1, -1] = 0.0                  # all-zero cell: scale 1, codes 0
    return V4


def _np(t):
    return np.asarray(t)


@pytest.mark.parametrize("shape", SHAPES)
def test_int8_codes_and_scales_bitwise(shape):
    V4 = _table(shape, seed=shape[0])
    V8, vs = tq.quantize_tiles(torch.from_numpy(V4))
    jV8, jvs = jq.quantize_tiles(jnp.asarray(V4))
    assert V8.dtype == torch.int8 and vs.dtype == torch.float32
    np.testing.assert_array_equal(V8.numpy(), _np(jV8))
    np.testing.assert_array_equal(vs.numpy(), _np(jvs))


@pytest.mark.parametrize("shape", SHAPES)
def test_int4_codes_and_scales_bitwise(shape):
    V4 = _table(shape, seed=shape[0] + 1)
    P4, vs = tq.quantize_tiles_int4(torch.from_numpy(V4))
    jP4, jvs = jq.quantize_tiles_int4(jnp.asarray(V4))
    assert P4.shape == shape[:3] + (shape[3] // 2,)
    np.testing.assert_array_equal(P4.numpy(), _np(jP4))
    np.testing.assert_array_equal(vs.numpy(), _np(jvs))
    np.testing.assert_array_equal(
        tq.dequantize_tiles_int4(P4, vs).numpy(),
        _np(jq.dequantize_tiles_int4(jP4, jvs)))


@pytest.mark.parametrize("batched", [False, True])
def test_query_blocks_bitwise(batched):
    rng = np.random.default_rng(7)
    shape = (5, 3, 64) if batched else (3, 64)
    qb = rng.normal(size=shape).astype(np.float32)
    qb[..., 1, :] = 0.0                               # all-zero block
    q8, qs = tq.quantize_blocks(torch.from_numpy(qb))
    jq8, jqs = jq.quantize_blocks(jnp.asarray(qb))
    assert qs.shape == shape[:-1]
    np.testing.assert_array_equal(q8.numpy(), _np(jq8))
    np.testing.assert_array_equal(qs.numpy(), _np(jqs))


def test_pack_unpack_roundtrip_and_layout():
    rng = np.random.default_rng(3)
    x = rng.integers(-8, 8, size=(6, 4, 32)).astype(np.int8)
    packed = tq.pack_int4(torch.from_numpy(x))
    np.testing.assert_array_equal(packed.numpy(),
                                  _np(jq.pack_int4(jnp.asarray(x))))
    np.testing.assert_array_equal(tq.unpack_int4(packed).numpy(), x)
    # byte k: column k in the low nibble, column k + C/2 in the high one
    p = packed.numpy().astype(np.uint8)
    np.testing.assert_array_equal((p & 0x0F).astype(np.int8),
                                  (x[..., :16] & 0x0F).astype(np.int8))
    np.testing.assert_array_equal(p >> 4, (x[..., 16:] & 0x0F).astype(
        np.uint8))


@pytest.mark.parametrize("shape,subdims,n_codes", [
    ((13, 3, 8, 64), 8, 16), ((40, 2, 8, 128), 4, 32),
    ((5, 1, 4, 96), 8, 256)])
def test_pq_encode_with_injected_codebook_and_train(shape, subdims, n_codes):
    V4 = _table(shape, seed=shape[0] + 2, zero_cell=False)
    jcb = jq.pq_train(jnp.asarray(V4), n_codes=n_codes, subdims=subdims)
    jcodes = jq.pq_encode(jnp.asarray(V4), jcb)
    codes, cb = quantized_from_jax((_np(jcodes), _np(jcb)), "pq")
    got = tq.pq_encode(torch.from_numpy(V4), cb)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), _np(jcodes))
    np.testing.assert_allclose(tq.pq_decode(codes, cb).numpy(),
                               _np(jq.pq_decode(jcodes, jcb)), rtol=1e-6)
    own = tq.pq_train(torch.from_numpy(V4), n_codes=n_codes,
                      subdims=subdims)
    assert own.shape == jcb.shape
    np.testing.assert_allclose(own.numpy(), _np(jcb), rtol=1e-5, atol=1e-6)
    # a pull of one (tile, block) cell: LUT build + lookups
    qcol = np.random.default_rng(1).normal(size=shape[3]).astype(np.float32)
    np.testing.assert_allclose(
        tq.pq_tile_dot(codes[2, 0], torch.from_numpy(qcol), cb[0]).numpy(),
        _np(jq.pq_tile_dot(jcodes[2, 0], jnp.asarray(qcol), jcb[0])),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("precision", ["int8", "int4", "pq"])
def test_measured_quant_err_on_the_same_queries(precision):
    V4 = _table((20, 2, 8, 64), seed=11, zero_cell=False)
    quant = {"int8": jq.quantize_tiles, "int4": jq.quantize_tiles_int4,
             "pq": lambda v: (jq.pq_encode(v, jq.pq_train(v)),
                              jq.pq_train(v))}[precision](jnp.asarray(V4))
    qs = np.random.default_rng(2).normal(size=(6, 2, 64)).astype(np.float32)
    want = jq.measured_quant_err(jnp.asarray(V4), quant,
                                 precision=precision,
                                 queries=jnp.asarray(qs))
    got = tq.measured_quant_err(
        torch.from_numpy(V4),
        quantized_from_jax(tuple(_np(a) for a in quant), precision),
        precision=precision, queries=torch.from_numpy(qs))
    assert got > 0
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # the port's own default draw is seeded and reproducible
    again = [tq.measured_quant_err(torch.from_numpy(V4), quantized_from_jax(
        tuple(_np(a) for a in quant), precision), precision=precision,
        n_queries=4, seed=5) for _ in range(2)]
    assert again[0] == again[1]


def test_measured_plan_matches_reference_geometry():
    rng = np.random.default_rng(4)
    V = (0.02 * rng.normal(size=(203, 300))).astype(np.float32)
    # the port pads and tiles as the JAX package does, then measures
    kw = dict(tile=8, block=64, pq_subdims=4, pq_codes=16)
    jplan = bj.make_plan(203, 300, block=64, precision="fp32")
    Vp, _ = bj._pad_operands(jnp.asarray(V), jnp.zeros((300,)), jplan)
    V4 = bj._tile_major(Vp, jplan)
    qs = rng.normal(size=(5, jplan.n_blocks, 64)).astype(np.float32)
    cb = jq.pq_train(V4, n_codes=16, subdims=4)
    want = jq.measured_quant_err(V4, (jq.pq_encode(V4, cb), cb),
                                 precision="pq", queries=jnp.asarray(qs))
    got = bt.measured_plan_quant_err(V, precision="pq", queries=qs,
                                     device="cpu", **kw)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    plan = bt.make_measured_plan(V, K=3, eps=0.5, value_range=1.0,
                                 block=64, pull_mode="hybrid",
                                 coord_block=32, pq_subdims=4,
                                 device="cpu")
    assert plan.precision == "pq" and plan.quant_err > 0
    assert plan.pull_mode in ("row", "coord")
    with pytest.raises(ValueError, match="fp32"):
        bt.make_measured_plan(V, precision="fp32", device="cpu")


def test_quantized_from_jax_checks_its_input():
    V8 = np.zeros((2, 1, 8, 16), np.int8)
    vs = np.ones((2, 1), np.float32)
    a, b = quantized_from_jax((V8, vs), "int8")
    assert a.dtype == torch.int8 and b.dtype == torch.float32
    with pytest.raises(TypeError, match="uint8"):
        quantized_from_jax((V8, vs), "pq")
    with pytest.raises(ValueError, match="shapes"):
        quantized_from_jax((V8, vs[None, None]), "int4")
    with pytest.raises(ValueError, match="precision"):
        quantized_from_jax((V8, vs), "fp32")
