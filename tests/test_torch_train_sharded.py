"""Sharded training of the port against the JAX package: the dense and
moe families' steps on DTensor meshes whose ranks are simulated in one
process under ``LocalTensorMode`` (``simulated_mesh``).  The other
families are in ``test_torch_train_sharded_ssm.py`` and
``test_torch_train_sharded_encdec.py``; the expert-parallel MoE against
the JAX package's ``_moe_ep_shardmap``, elastic restore and real
``gloo`` ranks in ``test_torch_train_elastic.py`` (one file each, to
keep each file's time short).

The JAX package's own sharded step fails on the installed jax
(``ShardingTypeError``, ``tests/test_system.py``), so a sharded step is
held against the JAX *single-device* ``train_step`` (GSPMD changes where
a step's pieces live, not the function) and the port's own
single-device step, three f32 steps from the JAX weights
(``sharded_util``: losses to rtol 1e-5, parameters by the card-vs-CPU
rule).  The smoke configs run at 2 layers and capacity factor 16, so no
token drops: the expert-parallel MoE of a 'model' axis (capacity over
each shard's tokens) then computes the single-device function.
"""

import pytest

from repro_torch.models import layers as TL
from sharded_util import FAMILIES, MESHES, check_sharded


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("family", ["dense", "moe"])
def test_sharded_steps_match_the_single_device_steps(family, shape):
    check_sharded(FAMILIES[family], shape)


def test_moe_on_a_2x4_mesh_takes_the_expert_parallel_path(monkeypatch):
    """qwen3-moe on (2, 4): 4 experts over 'model' = 4, the EP path (each
    rank its one expert), and its steps those of one device."""
    taken = []
    real = TL._moe_ep
    monkeypatch.setattr(TL, "_moe_ep", lambda *a: taken.append(1) or
                        real(*a))
    check_sharded(FAMILIES["moe"], (2, 4))
    assert taken
