"""The port's dry run against the JAX package's: `collective_bytes` on a
DTensor program counted by hand (ranks simulated under
``LocalTensorMode``), the HLO type table and shape parser of
``repro.launch.hlo_analysis``, one smoke cell of each kind (train,
prefill, decode) traced on a fake (2, 4) mesh — its record keys the JAX
record's (plus each device's bytes by kind), its per-device parameter
bytes those the JAX package's specs imply — and the CLI's selection,
caching and failure records.
"""

import dataclasses
import functools
import json
import os
import re

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro.configs import REGISTRY as JAX_REGISTRY
from repro.distributed import specs as JP
from repro.launch import hlo_analysis as JH
from repro.models.model import init_params
from repro_torch.configs import get_config
from repro_torch.configs.base import RunShape
from repro_torch.launch import comm_analysis as C
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import simulated_mesh

MESH = ((2, 4), ("data", "model"))
#: each device's bytes by kind and the count of 16-bit reductions, which
#: the port's record adds
EXTRA = {"param_bytes", "moment_bytes", "batch_bytes", "cache_bytes",
         "reductions_16_bit"}


def _jax_record_keys() -> set:
    """The keys ``repro.launch.dryrun.run_cell`` writes into a successful
    record (read from its source: the JAX dry run itself needs 512 host
    devices)."""
    path = os.path.join(os.path.dirname(__file__), "..", "src", "repro",
                        "launch", "dryrun.py")
    src = open(path).read()
    body = src[src.index("def run_cell"):src.index("def main")]
    keys = set(re.findall(r'rec\["(\w+)"\]', body))
    keys |= set(re.findall(r'"(\w+)": ', body[body.index("rec: Dict"):
                                              body.index("rec[\"unrolled")]))
    attrs = body[body.index("for attr in ("):body.index("rec[attr]")]
    keys |= set(re.findall(r'"(\w+)"', attrs))
    keys.update(["fsdp", "rules"])                # lower_cell's meta
    return keys - {"error", "traceback"}


def test_hlo_tables_and_shape_bytes_are_the_jax_packages():
    assert C.DTYPE_BYTES == JH.DTYPE_BYTES
    for s in ("bf16[256,4096]", "(f32[8], f32[8])", "s32[]", "pred[3,3]",
              "u8[0]", "f64[2,2,2]"):
        assert C.shape_bytes(s) == JH.shape_bytes(s)
    assert C.shape_str(torch.zeros((2, 3), dtype=torch.bfloat16)) == \
        "bf16[2,3]"
    empty = C.collective_bytes([])
    assert set(empty) == set(JH.collective_bytes(""))
    with pytest.raises(ValueError, match="unknown collective"):
        C.collective_bytes([("broadcast", "f32[1]")])


def test_collective_bytes_of_a_hand_counted_program():
    """On a (2, 2) mesh: an all-gather over 'data' of an (8, 16) f32
    tensor split in rows (output 512 bytes), the all-reduce of a (4, 4)
    f32 partial sum (64 bytes) and its reduce-scatter into rows over
    'model' (output (2, 4), 32 bytes); and a matmul's local FLOPs."""
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)
    with simulated_mesh((2, 2), device="cpu") as mesh:
        x = distribute_tensor(torch.arange(128.0).reshape(8, 16), mesh,
                              [Shard(0), Replicate()])
        p = DTensor.from_local(torch.ones(4, 4), mesh,
                               [Replicate(), Partial()])
        w = distribute_tensor(torch.ones(16, 6), mesh,
                              [Replicate(), Shard(1)])
        with C.TraceCounter() as tc:
            x.redistribute(mesh, [Replicate(), Replicate()])
            p.redistribute(mesh, [Replicate(), Replicate()])
            p.redistribute(mesh, [Replicate(), Shard(0)])
            x @ w
    rec = C.collective_bytes(tc.collectives)
    assert rec["all-gather_count"] == 1 and rec["all-gather_bytes"] == 512
    assert rec["all-reduce_count"] == 1 and rec["all-reduce_bytes"] == 64
    assert rec["reduce-scatter_count"] == 1 \
        and rec["reduce-scatter_bytes"] == 32
    assert rec["all-to-all_count"] == rec["collective-permute_count"] == 0
    assert rec["total_bytes"] == 608
    assert tc.flops == 2 * 4 * 16 * 3            # one rank's (4, 16) x (16, 3)


def _jax_param_bytes(arch: str) -> int:
    """One device's parameter bytes under the JAX package's specs on the
    (2, 4) mesh."""
    jcfg = JAX_REGISTRY[arch].smoke()
    abstract = jax.eval_shape(functools.partial(init_params, jcfg),
                              jax.random.PRNGKey(0))
    mesh = JaxAbstractMesh(*MESH)
    specs = JP.param_pspecs(jcfg, abstract, mesh)
    total = 0
    for leaf, spec in zip(jax.tree.leaves(abstract), jax.tree.leaves(
            specs, is_leaf=lambda s: isinstance(s, jax.sharding
                                                .PartitionSpec))):
        shape = list(leaf.shape)
        for d, entry in enumerate(spec):
            axes = (entry,) if isinstance(entry, str) else (entry or ())
            for a in axes:
                shape[d] //= dict(zip(*MESH[::-1]))[a]
        total += int(np.prod(shape)) * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("arch,kind", [("tinyllama-1.1b", "train"),
                                       ("qwen3-moe-30b-a3b", "prefill"),
                                       ("mamba2-130m", "decode"),
                                       ("whisper-medium", "decode")])
def test_smoke_cells_trace_with_the_jax_record(arch, kind):
    cfg = get_config(arch).smoke()
    shape = RunShape(f"{kind}_tiny", 32, 8, kind)
    rec = D.run_cell(cfg, shape, "single", save=False, mesh_shape=MESH)
    assert rec["ok"], rec.get("traceback")
    assert set(rec) == _jax_record_keys() | EXTRA
    assert rec["n_devices"] == 8 and rec["kind"] == kind
    assert rec["param_bytes"] == _jax_param_bytes(arch)
    assert rec["flops"] > 0
    assert rec["reductions_16_bit"] == 0
    coll = rec["collectives"]
    assert coll["total_bytes"] == sum(v for k, v in coll.items()
                                      if k.endswith("_bytes")
                                      and k != "total_bytes")
    if kind == "train":
        assert rec["moment_bytes"] == 2 * rec["param_bytes"]   # f32 model
        assert coll["all-reduce_count"] > 0
    if kind == "decode":
        assert rec["cache_bytes"] > 0


def test_cli_selects_caches_and_never_caches_failures(tmp_path, monkeypatch,
                                                      capsys):
    monkeypatch.setattr(D, "RESULTS_DIR", str(tmp_path))
    with pytest.raises(SystemExit):
        D.main([])
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").smoke())
    shape = RunShape("train_tiny", 16, 8, "train")
    monkeypatch.setattr(D, "trace_cell", lambda *a, **k: 1 / 0)
    rec = D.run_cell(cfg, shape, "single", mesh_shape=MESH)
    assert not rec["ok"] and rec["error"].startswith("ZeroDivisionError")
    assert "traceback" in rec and not os.listdir(tmp_path)
    monkeypatch.setattr(D, "trace_cell", lambda *a, **k: {"flops": 1.0})
    rec = D.run_cell(cfg, shape, "single", mesh_shape=MESH)
    path = tmp_path / "tinyllama-1.1b_train_tiny_single.json"
    assert rec["ok"] and json.loads(path.read_text())["flops"] == 1.0
    monkeypatch.setattr(D, "trace_cell", lambda *a, **k: 1 / 0)
    assert D.run_cell(cfg, shape, "single", mesh_shape=MESH)["ok"]
    seen = []
    monkeypatch.setattr(D, "run_cell", lambda c, s, m, **k: seen.append(
        (c.name, s.name, m)) or {"ok": True, "flops": 1.0, "param_bytes": 0,
                                  "collectives": {"total_bytes": 0}})
    assert D.main(["--arch", "mamba2-130m", "--mesh", "both"]) == 0
    out = capsys.readouterr().out
    assert len(seen) == 8 and "done: ok=8 fail=0 skip=0" in out
    seen.clear()
    assert D.main(["--shape", "long_500k"]) == 0
    assert "skip=8" in capsys.readouterr().out and len(seen) == 2
