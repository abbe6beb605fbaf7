from geneface_tpu_torch.inference.audio2motion_infer import Audio2MotionInfer
from geneface_tpu_torch.inference.audio2pose_infer import Audio2PoseInfer
from geneface_tpu_torch.inference.gui import NeRFGUI, NeRFWebGUI, OrbitCamera, RealtimeRenderer
from geneface_tpu_torch.inference.nerf_infer import ADNeRFInfer, LM3dNeRFInfer
from geneface_tpu_torch.inference.postnet_infer import PostnetInfer
from geneface_tpu_torch.inference.radnerf_infer import (
    RADNeRFInfer,
    pick_ray_capacity,
    save_mp4,
)

__all__ = ["ADNeRFInfer", "Audio2MotionInfer", "Audio2PoseInfer", "LM3dNeRFInfer", "NeRFGUI",
           "NeRFWebGUI", "OrbitCamera", "PostnetInfer", "RADNeRFInfer", "RealtimeRenderer",
           "pick_ray_capacity", "save_mp4"]
