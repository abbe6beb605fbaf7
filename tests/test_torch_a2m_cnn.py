"""The port's ``SeqLevelConvolutionalModel`` with each backbone (U-Net,
ResNet, residual blocks) at its fixed widths against the JAX package's
flax module on the CPU: the same seeded numpy weights carried across by
``convert``, a 16-frame batch with a padded tail. Tolerances as in
``test_torch_a2m_models.py``: the forward output within 1e-5 of the
reference's largest magnitude, every parameter's gradient within 1e-4
relative L2. The JAX side compiles one function (forward and gradient) per
backbone.
"""

import os
import sys

import numpy as np
import pytest
import torch

from geneface_tpu.models.audio2motion import cnn_models as jcnn
from geneface_tpu_torch.models.audio2motion.cnn_models import SeqLevelConvolutionalModel

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_a2m_models import check_parity, seeded_variables  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("backbone", ["unet", "resnet", "resblocks"])
def test_seq_conv_model_matches_jax(backbone):
    jm = jcnn.SeqLevelConvolutionalModel(out_dim=12, backbone_type=backbone)
    rng = np.random.RandomState(2)
    B, T = 2, 16
    mask = np.ones((B, T), np.float32)
    mask[1, 11:] = 0.0
    batch = {"audio": rng.randn(B, T, 29).astype(np.float32) * mask[..., None],
             "energy": rng.randn(B, T, 1).astype(np.float32) * mask[..., None],
             "style": rng.randn(B, 135).astype(np.float32), "x_mask": mask}
    tm = SeqLevelConvolutionalModel(out_dim=12, backbone_type=backbone)
    check_parity(lambda v: jm.apply(v, batch), seeded_variables(tm), tm,
                 lambda m: m({k: torch.as_tensor(v) for k, v in batch.items()}),
                 backbone)
