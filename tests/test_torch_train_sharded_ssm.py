"""Sharded training of the port against the JAX package for the
ssm (mamba2-130m: the SSD scan under ``local_map`` on each rank's
batch rows and heads) and hybrid (jamba-v0.1-52b: Mamba, attention
and the MoE in one period), on DTensor meshes whose ranks are
simulated under ``LocalTensorMode``: three f32 steps each, held against
the JAX package's single-device ``train_step`` and the port's own
(``sharded_util``; ``test_torch_train_sharded.py`` has the dense and moe
families and the rule's reasons).
"""

import pytest

from sharded_util import FAMILIES, MESHES, check_sharded


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("family", ['ssm', 'hybrid'])
def test_sharded_steps_match_the_single_device_steps(family, shape):
    check_sharded(FAMILIES[family], shape)
