"""The port's checkpointer (`repro_torch.checkpoint.checkpointer`): the
JAX package's checkpoint tests in the port's terms, its layout on disk
against the JAX package's, and the port's training state round trip.

Every comparison is bitwise: arrays are saved as they are, bf16 widened
to f32 exactly and narrowed back.
"""

import json
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as JC
from repro_torch.checkpoint.checkpointer import (latest_step, list_steps,
                                                 restore_checkpoint,
                                                 save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import init_opt


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32)),
            "nested": {"b": torch.from_numpy(
                rng.normal(size=(3,)).astype(np.float32)).to(torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 10, t)
    restored, step = restore_checkpoint(str(tmp_path), t)
    assert step == 10
    assert _equal(restored["a"], t["a"])
    assert _equal(restored["nested"]["b"], t["nested"]["b"])
    assert _equal(restored["step"], t["step"])


def test_keep_last(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(str(tmp_path), s, t, keep_last=2)
    assert list_steps(str(tmp_path)) == [4, 5]
    assert latest_step(str(tmp_path)) == 5
    with open(tmp_path / "manifest.json") as f:
        assert json.load(f) == {"steps": [4, 5]}


def test_partial_write_invisible(tmp_path):
    """A crashed (un-renamed) tmp dir is never restored from."""
    t = _tree()
    save_checkpoint(str(tmp_path), 3, t)
    os.makedirs(tmp_path / "step_00000009.tmp")  # simulated crash
    os.makedirs(tmp_path / "step_00000011")      # no meta.json: unfinished
    assert latest_step(str(tmp_path)) == 3
    _, step = restore_checkpoint(str(tmp_path), t)
    assert step == 3


def test_shape_mismatch_and_missing_key_raise(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 1, t)
    with pytest.raises(ValueError, match="shape mismatch for a"):
        restore_checkpoint(str(tmp_path), dict(t, a=torch.zeros(5, 8)))
    with pytest.raises(KeyError, match="missing keys"):
        restore_checkpoint(str(tmp_path), dict(t, c=torch.zeros(2)))


def test_restore_empty_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path), _tree())


def test_layout_on_disk_is_the_jax_packages(tmp_path):
    """The same flat tree saved by both packages: the same files, the same
    ``meta.json`` keys and counts, the same arrays (bf16 as f32) under the
    same keys; each package restores the other's."""
    rng = np.random.default_rng(2)
    a = rng.normal(size=(5, 6)).astype(np.float32)
    b = rng.normal(size=(7,)).astype(np.float32).astype(ml_dtypes.bfloat16)
    jtree = {"w": jnp.asarray(a), "v": jnp.asarray(b), "n": jnp.int32(3)}
    ttree = {"w": torch.from_numpy(a),
             "v": torch.from_numpy(b.view(np.uint16).copy()).view(
                 torch.bfloat16),
             "n": torch.tensor(3, dtype=torch.int32)}
    JC.save_checkpoint(str(tmp_path / "jax"), 4, jtree)
    save_checkpoint(str(tmp_path / "port"), 4, ttree)
    for d in ("jax", "port"):
        assert sorted(os.listdir(tmp_path / d)) == ["manifest.json",
                                                   "step_00000004"]
        assert sorted(os.listdir(tmp_path / d / "step_00000004")) == [
            "meta.json", "shard_0.npz"]
    metas = [json.load(open(tmp_path / d / "step_00000004" / "meta.json"))
             for d in ("jax", "port")]
    assert {k: v for k, v in metas[0].items() if k != "time"} == \
        {k: v for k, v in metas[1].items() if k != "time"}
    with np.load(tmp_path / "jax" / "step_00000004" / "shard_0.npz") as j, \
            np.load(tmp_path / "port" / "step_00000004" / "shard_0.npz") as t:
        assert sorted(j.files) == sorted(t.files)
        for k in j.files:
            assert j[k].dtype == t[k].dtype
            np.testing.assert_array_equal(j[k], t[k])
    got, _ = restore_checkpoint(str(tmp_path / "jax"), ttree)
    assert all(_equal(got[k], ttree[k]) for k in ttree)
    back, _ = JC.restore_checkpoint(str(tmp_path / "port"), jtree)
    for k in jtree:
        np.testing.assert_array_equal(np.asarray(back[k]),
                                      np.asarray(jtree[k]))


@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16])
def test_training_state_roundtrip(tmp_path, moments):
    """``{"params", "opt"}`` of a bf16 model, f32 or bf16 moments, with
    and without an error buffer: every tensor back in its type and on its
    device, bitwise, under the port's names."""
    cfg = get_config("jamba-v0.1-52b").smoke()
    model = build_model(cfg, seed=1, device="cpu")
    model = model.to(torch.bfloat16)
    params = dict(model.named_parameters())
    rng = torch.Generator().manual_seed(0)
    opt = init_opt(params, moments_dtype=moments)
    for tree in (opt.mu, opt.nu, opt.err):
        for t in tree.values():
            t.copy_(torch.randn(t.shape, generator=rng))
    opt = opt._replace(step=opt.step + 9)
    save_checkpoint(str(tmp_path), 9, {"params": params, "opt": opt})
    with np.load(tmp_path / "step_00000009" / "shard_0.npz") as data:
        assert "params/periods.1.moe.0.w_up" in data.files
        assert "opt/mu/periods.1.moe.0.w_up" in data.files
        assert "opt/step" in data.files
    like = {"params": {k: torch.zeros_like(v) for k, v in params.items()},
            "opt": init_opt(params, moments_dtype=moments)}
    got, step = restore_checkpoint(str(tmp_path), like)
    assert step == 9 and int(got["opt"].step) == 9
    assert type(got["opt"]) is type(opt)
    for k, v in params.items():
        assert _equal(got["params"][k], v.detach())
    for field in ("mu", "nu", "err"):
        for k, v in getattr(opt, field).items():
            assert _equal(getattr(got["opt"], field)[k], v)
    # without an error buffer: nothing saved or read under opt/err
    save_checkpoint(str(tmp_path), 10, {"params": params,
                                        "opt": opt._replace(err=None)})
    with np.load(tmp_path / "step_00000010" / "shard_0.npz") as data:
        assert not any(f.startswith("opt/err/") for f in data.files)
    got, _ = restore_checkpoint(str(tmp_path),
                                {"params": like["params"],
                                 "opt": like["opt"]._replace(err=None)})
    assert got["opt"].err is None
