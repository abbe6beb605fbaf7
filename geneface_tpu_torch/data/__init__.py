from geneface_tpu_torch.data.nerf_dataset import NeRFDataset
from geneface_tpu_torch.data.radnerf_dataset import (
    RADNeRFDataset,
    get_cond_window,
    smooth_camera_path,
)

__all__ = ["NeRFDataset", "RADNeRFDataset", "get_cond_window", "smooth_camera_path"]
