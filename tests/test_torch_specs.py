"""The port's partition specs and logical axes against the JAX
package's: `param_pspecs` leaf for leaf for all ten archs (smoke and
full) on the (1, 1), (2, 4), (16, 16) and (2, 16, 16) meshes with FSDP
on and off (JAX gets a ``jax.sharding.AbstractMesh``, the port its
`AbstractMesh`); `batch_pspecs`, `cache_pspecs` and `batch_axes`;
`spec_of`'s first-come rule, `logical_mesh`'s filtering, `shard` as the
identity without a mesh; placements split row-major, as JAX splits; the
dry run's `cells`; and the device default of the model constructors.

The port keeps one tensor per layer where the JAX package stacks a leaf
over the layers, so a port tensor's spec is its JAX leaf's without the
leading stack entries.  Those entries are None but for the attention
biases under FSDP (their JAX leaves are rank 2 and the rule splits the
layer axis over 'data'), which the port keeps whole.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro.configs import REGISTRY as JAX_REGISTRY
from repro.configs import cells as jax_cells
from repro.configs import get_shape as jax_get_shape
from repro.distributed import sharding as JS
from repro.distributed import specs as JP
from repro.models.model import forward as jax_forward
from repro.models.model import init_params
from repro_torch.configs import (REGISTRY, SHAPES, cells, get_config,
                                 get_shape)
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.distributed.sharding import (LOGICAL_RULES, AbstractMesh,
                                              P, current_mesh, logical_mesh,
                                              named_sharding, placements,
                                              rebinder, shard, spec_of)
from repro_torch.distributed.specs import (_split_name, batch_axes,
                                           batch_pspecs, cache_pspecs,
                                           param_pspecs, place_tree,
                                           tree_pspecs)
from repro_torch.launch.dryrun import _meta_caches
from repro_torch.launch.mesh import simulated_mesh
from repro_torch.models.model import DenseLM, build_model

MESHES = [((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


def _meshes(shape, names):
    return JaxAbstractMesh(shape, names), AbstractMesh(shape, names)


def _jax_leaf(tree, key):
    for k in key.split("/"):
        tree = tree[k]
    return tree


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_param_pspecs_match_jax_leaf_for_leaf(arch):
    n_cmp = 0
    for smoke in (True, False):
        jcfg = JAX_REGISTRY[arch].smoke() if smoke else JAX_REGISTRY[arch]
        cfg = REGISTRY[arch].smoke() if smoke else REGISTRY[arch]
        abstract = jax.eval_shape(functools.partial(init_params, jcfg),
                                  jax.random.PRNGKey(0))
        named = dict(build_model(cfg, device="meta").named_parameters())
        keys = {_split_name(n)[0] for n in named}
        leaves = {jax.tree_util.keystr(p, simple=True, separator="/")
                  for p, _ in jax.tree_util.tree_flatten_with_path(
                      abstract)[0]}
        assert keys == leaves
        for shape, names in MESHES:
            for fsdp in (False, True):
                jm, tm = _meshes(shape, names)
                want = JP.param_pspecs(jcfg, abstract, jm, fsdp=fsdp)
                got = param_pspecs(cfg, named, tm, fsdp=fsdp)
                for name, spec in got.items():
                    key, stack = _split_name(name)
                    ref = tuple(_jax_leaf(want, key))
                    assert tuple(spec) == ref[stack:], (name, spec, ref)
                    lead = set(ref[:stack])
                    biases = key.split("/")[-1] in ("bq", "bk", "bv")
                    assert lead <= ({None, "data"} if fsdp and biases
                                    else {None}), (name, ref)
                    n_cmp += 1
    assert n_cmp > 0


@pytest.mark.parametrize("shape,names", MESHES)
def test_batch_pspecs_and_batch_axes_match_jax(shape, names):
    jm, tm = _meshes(shape, names)
    for gb in (256, 128, 32, 16, 7, 1):
        assert batch_axes(tm, gb) == JP.batch_axes(jm, gb)
    for arch in ("tinyllama-1.1b", "whisper-medium", "internvl2-26b"):
        cfg = get_config(arch).smoke()
        b = {"tokens": torch.empty((32, 16), dtype=torch.int32),
             "labels": torch.empty((32, 16), dtype=torch.int32)}
        if cfg.family == "vlm":
            b["patch_embeds"] = torch.empty((32, cfg.n_patches,
                                             cfg.d_model))
        if cfg.family == "encdec":
            b["enc_frames"] = torch.empty((32, cfg.encoder_seq,
                                           cfg.d_model))
        jb = {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.float32)
              for k, v in b.items()}
        want = JP.batch_pspecs(jm, 32, jb)
        got = batch_pspecs(tm, 32, b)
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_cache_pspecs_match_jax(arch):
    """Each layer's cache spec is the JAX stacked leaf's spec without its
    layer entry, for both the default and the long-context sequence
    axes."""
    jcfg, cfg = JAX_REGISTRY[arch].smoke(), REGISTRY[arch].smoke()
    shape = dataclasses.replace(get_shape("decode_32k"), seq_len=64,
                                global_batch=8)
    B, S = shape.global_batch, shape.seq_len
    abstract = jax.eval_shape(functools.partial(init_params, jcfg),
                              jax.random.PRNGKey(0))
    kw = {}
    if jcfg.family == "encdec":
        kw["enc_frames"] = jax.ShapeDtypeStruct(
            (B, jcfg.encoder_seq, jcfg.d_model), jnp.float32)
    _, jcaches = jax.eval_shape(
        functools.partial(jax_forward, cfg=jcfg, cache_len=S), abstract,
        tokens=jax.ShapeDtypeStruct((B, S), jnp.int32), **kw)
    caches = _meta_caches(build_model(cfg, device="meta"), cfg, shape)
    for shp, names in MESHES:
        jm, tm = _meshes(shp, names)
        for seq_axes in (None, ("data", "model")):
            want = JP.cache_pspecs(jm, B, jcaches, seq_axes=seq_axes)
            got = cache_pspecs(tm, B, caches, seq_axes=seq_axes)
            assert len(got) == len(caches)
            for layer, c in zip(got, caches):
                assert set(layer) == set(want)
                for k, spec in layer.items():
                    assert tuple(spec) == tuple(want[k])[1:], (k, spec)
                    assert len(spec) == c[k].dim()


def test_spec_of_first_come_and_logical_mesh_filtering():
    jm, tm = _meshes((2, 4), ("data", "model"))
    assert current_mesh() is None
    with logical_mesh(tm), JS.logical_mesh(jm):
        assert current_mesh() is tm
        for axes in [("experts", "ff"), ("ff", "experts"),
                     ("batch", "seq", "heads", None),
                     ("batch", "kvseq", "kv_heads", None),
                     ("vocab", "heads"), (None, "dinner", "embed")]:
            assert tuple(spec_of(*axes)) == tuple(JS.spec_of(*axes)), axes
        assert spec_of("experts", "ff") == P("model", None)
        assert spec_of("batch", None) == P("data", None)   # no 'pod'
        with logical_mesh(tm, {"batch": None, "seq": "data"}):
            assert spec_of("batch", "seq") == P(None, "data")
        assert spec_of("batch", "seq") == P("data", None)
    assert current_mesh() is None
    pm = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    with logical_mesh(pm):
        assert spec_of("batch") == P(("pod", "data"))
    assert LOGICAL_RULES == JS.LOGICAL_RULES


def test_rebinder_binds_the_mesh_again_in_another_thread():
    """Activation checkpointing recomputes a block in the autograd
    engine's thread on the card, where this thread's binding is not."""
    import threading
    mesh = AbstractMesh((2, 4), ("data", "model"))
    seen = []
    with logical_mesh(mesh, {"seq": "data", "vocab": None}):
        again = rebinder()
        t = threading.Thread(target=lambda: seen.append(current_mesh()))
        t.start()
        t.join(timeout=10)

        def bound():
            with again():
                seen.append((current_mesh(), spec_of("batch", "seq")))
                assert spec_of("vocab") == P(None)
        t = threading.Thread(target=bound)
        t.start()
        t.join(timeout=10)
    assert not t.is_alive()
    assert seen == [None, (mesh, P("data", None))]      # 'data' once
    with rebinder()():
        assert current_mesh() is None


def test_shard_is_the_identity_without_a_mesh_and_checks_rank():
    x = torch.arange(6.0).reshape(2, 3)
    assert shard(x, "batch", None) is x
    assert shard(x, "batch") is x            # no mesh: nothing checked
    with logical_mesh(AbstractMesh((2, 4), ("data", "model"))):
        with pytest.raises(ValueError, match="1 axes for rank-2"):
            shard(x, "batch")
        assert shard(x, "batch", None) is x  # a plain tensor stays


def test_partition_spec_normalizes_as_jax_does():
    from jax.sharding import PartitionSpec as JaxP
    for parts in [(("data",), None), ((), "model"), (("pod", "data"),),
                  (None, None)]:
        assert tuple(P(*parts)) == tuple(JaxP(*parts))
    assert tree_pspecs({"a": torch.zeros(2, 3), "b": [torch.zeros(4)],
                        "c": 1.0}) == {"a": P(None, None), "b": [P(None)],
                                       "c": P()}


def test_named_sharding_is_the_bound_mesh_and_its_placements():
    from torch.distributed.tensor import Replicate, Shard
    with pytest.raises(RuntimeError, match="no mesh bound"):
        named_sharding("batch", None)
    with simulated_mesh((2, 2), device="cpu") as mesh, logical_mesh(mesh):
        got, pl = named_sharding("batch", "vocab")
        assert got is mesh and pl == (Shard(0), Shard(1))
        assert named_sharding("kv_heads")[1] == (Replicate(), Replicate())


def test_placements_split_row_major_as_jax_and_refuse_the_rest():
    """A dimension split over ('data', 'model') on a (2, 2) mesh: rank
    (i, j) holds block i * 2 + j, JAX's row-major order."""
    from torch.distributed.tensor import Replicate, Shard
    with simulated_mesh((2, 2), device="cpu") as mesh:
        assert placements(mesh, P(("data", "model"), None)) == \
            (Shard(0), Shard(0))
        assert placements(mesh, P(None, "model")) == (Replicate(),
                                                      Shard(1))
        t = place_tree({"t": torch.arange(8.0)},
                       {"t": P(("data", "model"))}, mesh)["t"]
        local = t.to_local()._local_tensors
        for rank in range(4):
            assert local[rank].tolist() == [2.0 * rank, 2.0 * rank + 1]
        with pytest.raises(ValueError, match="mesh's order"):
            placements(mesh, P(("model", "data")))
        with pytest.raises(ValueError, match="twice"):
            placements(mesh, P("model", "model"))
        with pytest.raises(ValueError, match="names axis 'pod'"):
            placements(mesh, P("pod"))
        with pytest.raises(ValueError, match="does not divide"):
            place_tree({"t": torch.zeros(6)}, {"t": P(("data", "model"))},
                       mesh)


def test_cells_and_shapes_are_the_jax_packages():
    mine = [(c.name, s.name, s.seq_len, s.global_batch, s.kind, k)
            for c, s, k in cells()]
    ref = [(c.name, s.name, s.seq_len, s.global_batch, s.kind, k)
           for c, s, k in jax_cells()]
    assert mine == ref and len(mine) == 40
    assert sum(k is not None for *_, k in mine) == 8
    for s in SHAPES:
        assert dataclasses.asdict(get_shape(s.name)) == \
            dataclasses.asdict(jax_get_shape(s.name))
    for name in REGISTRY:
        assert REGISTRY[name].n_params() == JAX_REGISTRY[name].n_params()
        assert REGISTRY[name].active_params() == \
            JAX_REGISTRY[name].active_params()
    with pytest.raises(KeyError):
        get_shape("train_1k")


def test_models_run_on_the_card_unless_the_cpu_is_asked_for():
    """No device means the card: without one, the constructors and
    `params_from_jax` / `opt_state_from_jax` raise; ``"meta"`` and
    ``"cpu"`` build."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would use it")
    cfg = get_config("tinyllama-1.1b").smoke()
    for make in (lambda: build_model(cfg), lambda: DenseLM(cfg)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert build_model(cfg, device="meta").embed.device.type == "meta"
    assert build_model(cfg, device="cpu").embed.device.type == "cpu"
    params = jax.tree.map(np.asarray, init_params(
        JAX_REGISTRY["tinyllama-1.1b"].smoke(), jax.random.PRNGKey(0)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax(params, cfg)
    from repro.optim import adamw as JA
    state = jax.tree.map(np.asarray, JA.init_opt(params))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        opt_state_from_jax(state)
