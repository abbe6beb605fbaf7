from geneface_tpu_torch.inference.radnerf_infer import (
    RADNeRFInfer,
    pick_ray_capacity,
    save_mp4,
)

__all__ = ["RADNeRFInfer", "pick_ray_capacity", "save_mp4"]
