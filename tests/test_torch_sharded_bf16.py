"""The rounding of a bf16 row-parallel projection split over 'model'.

The MLP's down projection ``y = h @ w_down`` with ``h (B, S, ff)`` split
over 'ff' and ``w_down (ff, d)`` split over its rows is a row-parallel
product: each rank multiplies its slice and the partial sums are
reduced.  The JAX package's form is ``shard_map`` of the local bf16
``einsum`` and a ``psum`` over 'model', run here on 4 forced host
devices in a subprocess (this process keeps its one device).  The
port's is its model code's own path: DTensors placed by the specs'
``w_down`` rule and the logical 'ff' axis, the product a partial sum and
`shard` to ``("batch", "seq", None)``, its ranks simulated on the CPU
(`simulated_mesh`).

Both round each rank's partial product to bf16, but they reduce the
partials differently: the JAX psum adds them in f32 and rounds once, the
port's all-reduce adds them in bf16, rounding after each add.  So the
bitwise hold fails (an open fault, ROADMAP queue 3, 3.4; marked
``xfail(strict=True)``), and a second test records the distance: about a
third of the outputs differ, each by at most 2 bf16 ulps of the sum of
the partials' magnitudes (the three adds' half ulps and JAX's one),
measured at 1 ulp; where the partials cancel the port can give 0 where
JAX keeps 2.4e-4.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from repro_torch.distributed.sharding import (PartitionSpec, logical_mesh,
                                              shard, spec_of)
from repro_torch.distributed.specs import place_tree
from repro_torch.launch.mesh import simulated_mesh

ROOT = Path(__file__).resolve().parent.parent
B, S, FF, D = 2, 8, 512, 128
SEEDS = (0, 1)

JAX_ROW_PARALLEL = textwrap.dedent("""
    import sys
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.distributed.sharding import shard_map_compat

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 4), ("data", "model"))
    f = jax.jit(shard_map_compat(
        lambda h, w: jax.lax.psum(jnp.einsum("bsf,fd->bsd", h, w), "model"),
        mesh=mesh, in_specs=(P(None, None, "model"), P("model", None)),
        out_specs=P(None, None, None)))
    for case in sys.argv[1:]:
        h, w = np.load(case + "h.npy"), np.load(case + "w.npy")
        y = f(jnp.asarray(h, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
        assert y.dtype == jnp.bfloat16
        np.save(case + "y.npy", np.asarray(y.astype(jnp.float32)))
""")


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16, held exactly in f32."""
    return a.astype(ml_dtypes.bfloat16).astype(np.float32)


def _jax_row_parallel(cases, tmp: Path) -> list:
    """The JAX results of ``cases``, a list of ``(h, w)``, in one
    subprocess."""
    stems = [str(tmp / f"case{i}_") for i in range(len(cases))]
    for stem, (h, w) in zip(stems, cases):
        np.save(stem + "h.npy", h)
        np.save(stem + "w.npy", w)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src")] + ([os.environ["PYTHONPATH"]]
                                          if os.environ.get("PYTHONPATH")
                                          else [])))
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=4")
    proc = subprocess.run(
        [sys.executable, "-c", JAX_ROW_PARALLEL, *stems],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return [np.load(stem + "y.npy") for stem in stems]


def _port_row_parallel(h: np.ndarray, w: np.ndarray) -> torch.Tensor:
    ht = torch.from_numpy(h).to(torch.bfloat16)
    wt = torch.from_numpy(w).to(torch.bfloat16)
    with simulated_mesh((1, 4), device="cpu") as mesh, logical_mesh(mesh):
        placed = place_tree({"h": ht, "w_down": wt},
                            {"h": spec_of("batch", "seq", "ff"),
                             "w_down": PartitionSpec("model", None)}, mesh)
        y = shard(placed["h"] @ placed["w_down"], "batch", "seq", None)
        assert y.dtype == torch.bfloat16
        y = y.full_tensor()
        if hasattr(y, "reconcile"):
            y = y.reconcile()
    return y.float()


def _ulp(a: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each value of ``a`` (2^-7 of its binade)."""
    e = np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126)))
    return np.ldexp(1.0, (e - 7).astype(int))


@pytest.fixture(scope="module")
def row_parallel(tmp_path_factory):
    """Per seed: ``(h, w, JAX result, port result)``."""
    cases = []
    for seed in SEEDS:
        rng = np.random.default_rng(seed)
        cases.append((_bf16(rng.normal(size=(B, S, FF))),
                      _bf16(0.02 * rng.normal(size=(FF, D)))))
    want = _jax_row_parallel(cases, tmp_path_factory.mktemp("row_parallel"))
    return {seed: (h, w, y, _port_row_parallel(h, w).numpy())
            for seed, (h, w), y in zip(SEEDS, cases, want)}



@pytest.mark.xfail(strict=True, reason=(
    "open (ROADMAP queue 3, 3.4): the port's all-reduce adds the bf16 "
    "partial sums in bf16, rounding after each add; the JAX psum adds "
    "them in f32 and rounds once: about a third of the outputs differ, "
    "by up to 0.0078125"))
@pytest.mark.parametrize("seed", SEEDS)
def test_bf16_row_parallel_projection_bitwise_jax(seed, row_parallel):
    h, w, want, got = row_parallel[seed]
    one = _bf16(np.einsum("bsf,fd->bsd", h.astype(np.float64), w))
    # the check can see the rounding: the sharded result is not the one
    # device's product rounded once
    assert (want != one).any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_bf16_row_parallel_projection_distance_to_jax(seed, row_parallel):
    """What 3.4 records: the port is its ranks' bf16 partial products
    added in bf16 in rank order, bitwise; it differs from the JAX result
    in about a third of the outputs, each within 2 bf16 ulps of the sum
    of the partials' magnitudes."""
    h, w, want, got = row_parallel[seed]
    k = FF // 4
    parts = [_bf16(np.einsum("bsf,fd->bsd", h[..., r * k:(r + 1) * k]
                             .astype(np.float64), w[r * k:(r + 1) * k]))
             for r in range(4)]
    acc = parts[0]
    for p in parts[1:]:
        acc = _bf16(acc + p)
    np.testing.assert_array_equal(got, acc)
    diff = np.abs(got.astype(np.float64) - want)
    size = np.abs(np.stack(parts)).sum(axis=0)
    assert (diff <= 2 * _ulp(size)).all()
    assert 0.1 < float((diff > 0).mean()) < 0.5
