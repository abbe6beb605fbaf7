"""The audio2pose WaveNet-GMM (port of ``geneface_tpu/models/audio2pose``)."""

from geneface_tpu_torch.models.audio2pose.gmm import gmm_log_loss, sample_gmm  # noqa: F401
from geneface_tpu_torch.models.audio2pose.models import (  # noqa: F401
    Audio2PoseModel,
    WaveNet,
    autoregressive_infer,
)
