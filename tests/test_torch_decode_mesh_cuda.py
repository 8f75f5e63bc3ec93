"""Decode over a ``DeviceMesh`` on the card against the CPU and one card.

Every test is marked ``cuda`` and skips without a card.  This file
imports only the port.  TF32 is off.  At smoke width:

* `sharded_bounded_me_decode` on a (1, 4) mesh whose ranks are simulated
  on the card (``simulated_mesh``) against the same call on the CPU, for
  the fp32 tier on a bf16 table and the int8 tier: ids equal, scores to
  rtol 1e-5 (the merged scores are exact fp32 products, the int8 tier's
  rescored ones too, summed on the card in another order); one launch
  per rank;
* smoke command-r-35b in f32 with the bandit head placed by
  `param_pspecs` on a simulated (2, 2) mesh, its cache split over
  'kvseq': greedy tokens equal to the same run on the CPU and to one
  card (its head over the serving `Mesh` at S = 2: the same shard plan),
  kernel 1 launches steps x ranks;
* two NCCL ranks on two cards under ``torchrun`` (skipped with fewer
  cards): the same model on a (1, 2) mesh, tokens equal to one card's.
"""

import contextlib
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.boundedme_torch import draw_perms
from repro_torch.distributed.sharding import (Mesh, logical_mesh,
                                              make_shard_plan,
                                              outside_simulated_ranks,
                                              sharded_bounded_me_decode)
from repro_torch.distributed.specs import (batch_pspecs, param_pspecs,
                                           place_params, place_tree)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import simulated_mesh
from repro_torch.models.model import build_model
from repro_torch.models.steps import decode_step, prefill_step

pytestmark = pytest.mark.cuda

B, PROMPT, CACHE, STEPS = 4, 8, 32, 4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _full(t):
    if isinstance(t, torch.distributed.tensor.DTensor):
        t = t.full_tensor()
    if hasattr(t, "reconcile"):
        t = t.reconcile()
    return t.detach().cpu()


@pytest.mark.parametrize("dtype,precision", [(torch.bfloat16, "fp32"),
                                             (torch.float32, "int8")])
def test_mesh_decode_on_the_card_matches_the_cpu(card, dtype, precision):
    rng = np.random.default_rng(3)
    V = (0.02 * rng.normal(size=(1203, 256))).astype(np.float32)
    Q = rng.normal(size=(B, 256)).astype(np.float32)
    for b in range(B):                     # a clear winner per query
        V[rng.integers(1203)] += 0.05 * Q[b]
    table = torch.from_numpy(V).to(dtype)
    kw = dict(K=4, eps=0.3, delta=0.1, block=128, precision=precision,
              value_range=2.0 * float(np.abs(V).max()))
    perm = draw_perms(make_shard_plan(1203, 256, 4, **kw)[0].n_blocks)
    out = {}
    for dev in ("cpu", "cuda"):
        ops.reset_launch_counts()
        with simulated_mesh((1, 4), device=dev) as mesh:
            got = sharded_bounded_me_decode(table.to(dev),
                                            torch.from_numpy(Q).to(dev),
                                            perm, mesh=mesh, n_valid=1200,
                                            **kw)
            out[dev] = [_full(g) for g in got]
        if dev == "cuda":
            assert ops.launch_counts()["fused_cascade_batched"] == 4
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-5,
                               atol=0.0)


def _cfg():
    return dataclasses.replace(get_config("command-r-35b").smoke(),
                               n_layers=2, dtype="float32",
                               mips_mode="boundedme")


def _tokens(device, mesh=None):
    """Greedy tokens of the smoke model on ``device``: placed over
    ``mesh``, or on one device with the bandit head over the serving
    `Mesh` at S = 2 (the shard plan of a 'model' axis of 2)."""
    cfg = _cfg()
    with outside_simulated_ranks():      # one draw, not one per rank
        model = build_model(cfg, seed=0, device="cpu").to(device)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, PROMPT))).to(device)
    perms = [draw_perms(1, generator=torch.Generator().manual_seed(i))
             for i in range(STEPS)]
    with (logical_mesh(mesh) if mesh is not None
          else contextlib.nullcontext()):
        if mesh is not None:
            place_params(model, param_pspecs(
                cfg, dict(model.named_parameters()), mesh), mesh)
            prompt = place_tree({"tokens": prompt}, batch_pspecs(
                mesh, B, {"tokens": prompt}), mesh)["tokens"]
        _, caches = prefill_step(model, prompt, CACHE)
        cur, toks = prompt[:, -1:], []
        for i in range(STEPS):
            nxt, caches = decode_step(
                model, cfg, caches, cur, PROMPT + i, perm=perms[i],
                mesh=None if mesh is not None else Mesh([device] * 2))
            toks.append(_full(nxt))
            cur = nxt[:, None]
    return torch.stack(toks, 1)


def test_model_over_a_simulated_mesh_on_the_card_matches_cpu_and_one_card(
        card):
    one = _tokens("cuda")
    with simulated_mesh((2, 2), device="cpu") as mesh:
        cpu = _tokens("cpu", mesh)
    ops.reset_launch_counts()
    with simulated_mesh((2, 2), device="cuda") as mesh:
        got = _tokens("cuda", mesh)
    assert ops.launch_counts()["fused_cascade_batched"] == STEPS * 4
    assert torch.equal(got, cpu)
    assert torch.equal(got, one)


_RANK_SCRIPT = """
import sys
import torch
import torch.distributed as dist
sys.path.insert(0, {tests!r})
import test_torch_decode_mesh_cuda as T
from repro_torch.launch.mesh import make_local_mesh
dist.init_process_group("nccl")
torch.cuda.set_device(dist.get_rank())
mesh = make_local_mesh(1, 2, device="cuda")
toks = T._tokens("cuda", mesh)
if dist.get_rank() == 0:
    torch.save(toks, {out!r})
dist.destroy_process_group()
"""


def test_two_nccl_ranks_on_two_cards_match_one_card(card, tmp_path):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    want = _tokens("cuda")
    tests = os.path.dirname(os.path.abspath(__file__))
    script = tmp_path / "ranks.py"
    out = tmp_path / "tokens.pt"
    script.write_text(textwrap.dedent(_RANK_SCRIPT.format(
        tests=tests, out=str(out))))
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", str(script)],
        env=dict(os.environ, PYTHONPATH=os.path.join(tests, "..", "src")),
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert torch.equal(torch.load(out), want)
