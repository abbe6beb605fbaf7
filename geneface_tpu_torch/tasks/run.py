"""Training and inference entry point of the port.

    python -m geneface_tpu_torch.tasks.run --config egs/... --exp_name <dir>
        [--hparams a=1,b=2] [--reset] [--infer] [--device cpu]

Mirrors ``geneface_tpu/tasks/run.py``: the config's ``task_cls`` (the JAX
package's class path) selects the port's task through :data:`TASKS`, and the
task trains under the :class:`~geneface_tpu_torch.training.trainer.Trainer`
in ``checkpoints/<exp_name>``, or with ``--infer`` runs the task's
``run_inference`` (the post-net: wav → lm3d ``.npy``; RAD-NeRF and the
vanilla NeRF: lm3d, or DeepSpeech windows for ADNeRF, → video;
audio2pose: DeepSpeech windows → the c2w ``.npy``). Both run on ``cuda``
unless ``--device cpu`` is given. Stage A
trains in the order its tasks load each other: SyncNet
(``egs/datasets/lrs3/lm3d_syncnet.yaml``), then the VAE
(``lm3d_vae_sync.yaml``, ``syncnet_work_dir``), then the post-net
(``egs/datasets/videos/May/lm3d_postnet_sync.yaml``,
``audio2motion_work_dir`` and ``syncnet_work_dir``).
"""

from __future__ import annotations

import argparse
import os

from geneface_tpu_torch.config.config import load_config
from geneface_tpu_torch.tasks.audio2motion import PitchContourVAESyncTask, VAESyncAudio2MotionTask
from geneface_tpu_torch.tasks.audio2pose import Audio2PoseTask
from geneface_tpu_torch.tasks.lm3d_nerf import (
    ADNeRFTask,
    ADNeRFTorsoTask,
    Lm3dNeRFTask,
    Lm3dNeRFTorsoTask,
)
from geneface_tpu_torch.tasks.postnet import PostnetAdvSyncTask
from geneface_tpu_torch.tasks.radnerf import RADNeRFTask
from geneface_tpu_torch.tasks.radnerf_torso import RADNeRFTorsoTask
from geneface_tpu_torch.tasks.syncnet import SyncNetTask
from geneface_tpu_torch.training.trainer import Trainer

__all__ = ["TASKS", "resolve_task", "main"]

#: ``task_cls`` of a config → the port's task class
TASKS = {
    "geneface_tpu.tasks.radnerf.RADNeRFTask": RADNeRFTask,
    "geneface_tpu.tasks.radnerf_torso.RADNeRFTorsoTask": RADNeRFTorsoTask,
    "geneface_tpu.tasks.postnet.PostnetAdvSyncTask": PostnetAdvSyncTask,
    "geneface_tpu.tasks.syncnet.SyncNetTask": SyncNetTask,
    "geneface_tpu.tasks.audio2motion.VAESyncAudio2MotionTask": VAESyncAudio2MotionTask,
    "geneface_tpu.tasks.audio2motion.PitchContourVAESyncTask": PitchContourVAESyncTask,
    "geneface_tpu.tasks.lm3d_nerf.Lm3dNeRFTask": Lm3dNeRFTask,
    "geneface_tpu.tasks.lm3d_nerf.Lm3dNeRFTorsoTask": Lm3dNeRFTorsoTask,
    "geneface_tpu.tasks.lm3d_nerf.ADNeRFTask": ADNeRFTask,
    "geneface_tpu.tasks.lm3d_nerf.ADNeRFTorsoTask": ADNeRFTorsoTask,
    "geneface_tpu.tasks.audio2pose.Audio2PoseTask": Audio2PoseTask,
}


def resolve_task(task_cls: str):
    try:
        return TASKS[task_cls]
    except KeyError:
        raise NotImplementedError(f"task {task_cls!r} is not ported") from None


def main(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--exp_name", default="")
    ap.add_argument("--hparams", default="")
    ap.add_argument("--reset", action="store_true", help="ignore a saved config.yaml")
    ap.add_argument("--infer", action="store_true", help="run the task's inference")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    work_dir = os.path.join("checkpoints", args.exp_name) if args.exp_name else None
    cfg = load_config(args.config, overrides=args.hparams, work_dir=work_dir,
                      use_saved=not args.reset)
    cfg["exp_name"] = args.exp_name
    task_cls = resolve_task(cfg["task_cls"])
    if args.infer:
        task_cls.run_inference(cfg, device=args.device)
        return 0
    return Trainer(task_cls(cfg, device=args.device)).fit()


if __name__ == "__main__":
    main()
