from geneface_tpu_torch.inference.audio2motion_infer import Audio2MotionInfer
from geneface_tpu_torch.inference.postnet_infer import PostnetInfer
from geneface_tpu_torch.inference.radnerf_infer import (
    RADNeRFInfer,
    pick_ray_capacity,
    save_mp4,
)

__all__ = ["Audio2MotionInfer", "PostnetInfer", "RADNeRFInfer", "pick_ray_capacity", "save_mp4"]
