"""The vanilla (AD-NeRF-style) NeRF family: backbone and models."""

from geneface_tpu_torch.models.nerf.backbone import NeRFBackbone
from geneface_tpu_torch.models.nerf.models import ADNeRF, ADNeRFTorso, Lm3dNeRF

__all__ = ["NeRFBackbone", "ADNeRF", "ADNeRFTorso", "Lm3dNeRF"]
