"""Sharded training on the card against the single-device step on the
card.

Every test is marked ``cuda`` and skips without a card.  This file
imports only the port.  TF32 is off.  The trainer runs tinyllama-1.1b's
smoke config in f32 for three steps from its seeded weights and
`LMStream` batches: on a (2, 2) mesh whose ranks are simulated on the
one card (``simulated_mesh``), and as two NCCL ranks on two cards under
``torchrun`` (skipped with fewer cards), each against the same run on
one card: losses to rtol 1e-5; all but 0.1 % of the parameters within
rtol 1e-4 and atol lr / 100, every one within 2 lr a step
(``chip_smoke.py``'s ``train_card_vs_cpu`` rule: a sharded step sums its
gradients over ranks in another order).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch import train as T
from repro_torch.launch.mesh import simulated_mesh

pytestmark = pytest.mark.cuda

LR, STEPS = 1e-3, 3
ARGV = ["--arch", "tinyllama-1.1b", "--smoke", "--steps", str(STEPS),
        "--batch", "4", "--seq", "32", "--lr", str(LR), "--log-every", "1"]


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


def _hold(got: dict, want: dict):
    off = n = 0
    worst = 0.0
    for name, w in want.items():
        d = (got[name].float() - w.float()).abs()
        worst = max(worst, float(d.max()))
        off += int((d > 1e-4 * w.float().abs() + 1e-2 * LR).sum())
        n += d.numel()
    assert worst <= 2 * LR * STEPS and off <= 1e-3 * n, (worst, off, n)


def _single():
    res = T.train(T.parse_args(ARGV))
    return ({n: p.detach().cpu() for n, p in res["model"].named_parameters()},
            [h["loss"] for h in res["history"]])


def test_simulated_2x2_mesh_on_the_card_matches_one_card(card):
    want, wl = _single()
    with simulated_mesh((2, 2)) as mesh:
        res = T.train(T.parse_args(ARGV), mesh=mesh)
        got = {n: _full(p) for n, p in res["model"].named_parameters()}
    np.testing.assert_allclose([h["loss"] for h in res["history"]], wl,
                               rtol=1e-5)
    _hold(got, want)


def test_two_nccl_ranks_on_two_cards_match_one_card(card, tmp_path):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    want, wl = _single()
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *ARGV,
         "--model-par", "2", "--ckpt-dir", str(tmp_path)],
        env=dict(os.environ, PYTHONPATH=src), capture_output=True,
        text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    logged = [float(line.split("loss=")[1].split()[0])
              for line in r.stdout.splitlines() if "loss=" in line]
    np.testing.assert_allclose(logged, wl, rtol=1e-4)   # 4 decimals logged
    with np.load(tmp_path / f"step_{STEPS:08d}" / "shard_0.npz") as data:
        got = {n: torch.from_numpy(data[f"params/{n}"]) for n in want}
    _hold(got, want)
