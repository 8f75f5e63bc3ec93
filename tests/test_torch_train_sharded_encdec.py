"""Sharded training of the port against the JAX package for the
encdec (whisper-medium: the encoder, cross attention and the GELU
MLP) and vlm (internvl2-26b: patch embeddings over the first tokens),
on DTensor meshes whose ranks are simulated under ``LocalTensorMode``:
three f32 steps each, held against
the JAX package's single-device ``train_step`` and the port's own
(``sharded_util``; ``test_torch_train_sharded.py`` has the dense and moe
families and the rule's reasons).
"""

import pytest

from sharded_util import FAMILIES, MESHES, check_sharded


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("family", ['encdec', 'vlm'])
def test_sharded_steps_match_the_single_device_steps(family, shape):
    check_sharded(FAMILIES[family], shape)
