from geneface_tpu_torch.data.radnerf_dataset import (
    RADNeRFDataset,
    get_cond_window,
    smooth_camera_path,
)

__all__ = ["RADNeRFDataset", "get_cond_window", "smooth_camera_path"]
