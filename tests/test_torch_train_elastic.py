"""The expert-parallel MoE, elastic checkpoints and real ``gloo`` ranks
of the port's sharded training.

* The EP MoE (`repro_torch.models.layers._moe_ep`) on a simulated (2, 4)
  mesh against the JAX package's ``_moe_ep_shardmap`` on 8 forced host
  devices, run in a subprocess (as ``tests/test_distributed.py`` does),
  to 2e-5 of the output's largest value: at capacity factor 16 and at
  0.5, where tokens drop (there the per-shard capacity makes it another
  function than the per-row dispatch, and both packages drop alike).
* Elastic re-meshing: a trainer run on a simulated (2, 2) mesh halted at
  step 2 with a checkpoint resumes on (2, 2) bitwise the uninterrupted
  run (parameters, moments, losses), and on (1, 2) and on one device
  (the checkpoint re-sharded onto the mesh it is given) within the
  card-vs-CPU rule (``sharded_util``).
* ``train.main`` as two real ``gloo`` processes under ``torchrun`` on a
  (1, 2) mesh against the same run simulated under ``LocalTensorMode``:
  losses to rtol 1e-5, the parameters of its checkpoint by the rule.
"""

import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.checkpointer import latest_step
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import logical_mesh
from repro_torch.distributed.specs import place_tree
from repro_torch.launch import train as T
from repro_torch.launch.mesh import simulated_mesh
from repro_torch.models import layers as TL
from sharded_util import full, hold

_EP_JAX = r"""
import os, sys, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import REGISTRY
from repro.distributed.sharding import logical_mesh
from repro.models import layers as L
cf, out = float(sys.argv[1]), sys.argv[2]
cfg = dataclasses.replace(REGISTRY["qwen3-moe-30b-a3b"].smoke(),
                          capacity_factor=cf)
rng = np.random.default_rng(3)
d, E, f = cfg.d_model, cfg.n_experts, cfg.d_ff
lp = {k: (rng.normal(size=s) / np.sqrt(s[-2])).astype(np.float32)
      for k, s in (("router", (d, E)), ("w_gate", (E, d, f)),
                   ("w_up", (E, d, f)), ("w_down", (E, f, d)))}
x = rng.normal(size=(4, 32, d)).astype(np.float32)
mesh = jax.make_mesh((2, 4), ("data", "model"))
with logical_mesh(mesh):
    y = jax.jit(lambda x, lp: L.moe_layer(x, lp, cfg))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in lp.items()})
y_row = L.moe_layer(jnp.asarray(x), {k: jnp.asarray(v)
                                     for k, v in lp.items()}, cfg)
np.savez(out, x=x, y=np.asarray(y), y_row=np.asarray(y_row), **lp)
print("OK")
"""


@pytest.mark.parametrize("cf", [16.0, 0.5])
def test_expert_parallel_moe_matches_the_jax_shard_map(cf, tmp_path):
    """The port's EP MoE on a simulated (2, 4) mesh against the JAX
    package's ``_moe_ep_shardmap`` on 8 forced host devices, at capacity
    factor 16 and at 0.5, where tokens drop (and the per-shard capacity
    makes it another function than the per-row dispatch)."""
    out = str(tmp_path / "ep.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    r = subprocess.run([sys.executable, "-c", _EP_JAX, str(cf), out],
                       env=env, capture_output=True, text=True, timeout=300)
    assert "OK" in r.stdout, r.stdout + r.stderr
    ref = np.load(out)
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b").smoke(),
                              capacity_factor=cf)
    lp = {k: torch.from_numpy(ref[k]) for k in ("router", "w_gate", "w_up",
                                                 "w_down")}
    x = torch.from_numpy(ref["x"])
    with simulated_mesh((2, 4), device="cpu") as mesh, logical_mesh(mesh):
        specs = {"x": TL.spec_of("batch", "seq", None),
                 "router": TL.SpecP(None, None),
                 **{k: TL.SpecP("model", None, None)
                    for k in ("w_gate", "w_up", "w_down")}}
        placed = place_tree({"x": x, **lp}, specs, mesh)
        y = full(TL.moe_layer(placed.pop("x"), placed, cfg))
    want = ref["y"]
    np.testing.assert_allclose(y.numpy(), want, rtol=0,
                               atol=2e-5 * np.abs(want).max())
    dropped = not np.allclose(ref["y_row"], want, rtol=0,
                              atol=2e-5 * np.abs(want).max())
    assert dropped == (cf < 1), "the drops do not follow the capacity"


_SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _args(ckpt=None, steps=4, *extra):
    argv = ["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu",
            "--steps", str(steps), "--batch", "4", "--seq", "16",
            "--lr", "3e-3", "--log-every", "100", *extra]
    if ckpt:
        argv += ["--ckpt-dir", str(ckpt), "--ckpt-every", "2"]
    return T.parse_args(argv)


def _cfg():
    return dataclasses.replace(get_config("tinyllama-1.1b").smoke(),
                               n_layers=2)


def _trained(res):
    named = {n: full(p) for n, p in res["model"].named_parameters()}
    opt = {f"{k}/{n}": full(t) for k in ("mu", "nu")
           for n, t in getattr(res["opt"], k).items()}
    return named, opt, [h["loss"] for h in res["history"]]


def test_checkpoint_resumes_bitwise_and_re_shards_onto_other_meshes(
        tmp_path):
    ckpt = tmp_path / "ckpt"
    with simulated_mesh((2, 2), device="cpu") as mesh:
        whole = _trained(T.train(_args(), cfg=_cfg(), mesh=mesh))
        T.train(_args(ckpt), cfg=_cfg(), mesh=mesh, halt_at=2)
        assert latest_step(str(ckpt)) == 2
        for other in ("on12", "on11"):
            shutil.copytree(ckpt, tmp_path / other)
        res = T.train(_args(ckpt), cfg=_cfg(), mesh=mesh)
        assert res["start"] == 2
        again = _trained(res)
    assert again[2] == whole[2][2:]
    for a, b in ((again[0], whole[0]), (again[1], whole[1])):
        for n in b:
            assert torch.equal(a[n], b[n]), n
    with simulated_mesh((1, 2), device="cpu") as mesh:
        res = T.train(_args(tmp_path / "on12"), cfg=_cfg(), mesh=mesh)
        assert res["start"] == 2 and tuple(mesh.shape) == (1, 2)
        on12 = _trained(res)
    on11 = _trained(T.train(_args(tmp_path / "on11"), cfg=_cfg()))
    for got, what in ((on12, "(1, 2)"), (on11, "one device")):
        np.testing.assert_allclose(got[2], whole[2][2:], rtol=1e-5)
        hold(got[0], whole[0], f"resumed on {what}", steps=2)


def test_train_main_as_two_gloo_ranks_matches_the_simulated_run(tmp_path):
    """``torchrun --standalone`` (a free port on localhost) starts two
    ranks of ``train.main`` on a (1, 2) mesh with ``gloo``; their rank 0
    writes the checkpoint."""
    ckpt = tmp_path / "gloo"
    argv = ["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu",
            "--steps", "3", "--batch", "4", "--seq", "16", "--lr", "3e-3",
            "--data-par", "1", "--model-par", "2", "--log-every", "1",
            "--ckpt-dir", str(ckpt)]
    env = dict(os.environ, PYTHONPATH=_SRC, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run",
                        "--standalone", "--nproc-per-node", "2", "-m",
                        "repro_torch.launch.train", *argv], env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "[train] mesh {'data': 1, 'model': 2} of 2 ranks" in r.stdout
    logged = [float(line.split("loss=")[1].split()[0])
              for line in r.stdout.splitlines() if "loss=" in line]
    assert len(logged) == 3                  # rank 0 alone logs
    with simulated_mesh((1, 2), device="cpu") as mesh:
        res = T.train(T.parse_args(argv[:-2]), mesh=mesh)
        named = {n: full(p) for n, p in res["model"].named_parameters()}
    np.testing.assert_allclose(logged, [h["loss"] for h in res["history"]],
                               rtol=1e-4)
    with np.load(ckpt / "step_00000003" / "shard_0.npz") as data:
        saved = {n: torch.from_numpy(data[f"params/{n}"]) for n in named}
    hold(saved, named, "gloo ranks vs the simulated ranks")
