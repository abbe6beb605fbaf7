from geneface_tpu_torch.utils.camera import (
    convert_poses,
    get_bg_coords,
    get_rays,
    nerf_matrix_to_ngp,
)
from geneface_tpu_torch.utils.checkpoint import (
    get_last_checkpoint,
    load_checkpoint,
    restore_partial,
    save_checkpoint,
)
from geneface_tpu_torch.utils.multiprocess import (
    MultiprocessManager,
    multiprocess_run,
    multiprocess_run_tqdm,
)

__all__ = [
    "convert_poses",
    "get_bg_coords",
    "get_rays",
    "nerf_matrix_to_ngp",
    "get_last_checkpoint",
    "load_checkpoint",
    "restore_partial",
    "save_checkpoint",
    "MultiprocessManager",
    "multiprocess_run",
    "multiprocess_run_tqdm",
]
