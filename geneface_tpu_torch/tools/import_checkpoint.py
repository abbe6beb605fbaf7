"""Import a GeneFace (PyTorch) RAD-NeRF checkpoint into a work dir of the
port::

    python -m geneface_tpu_torch.tools.import_checkpoint \
        --ckpt <GeneFace work dir or model_ckpt_steps_*.ckpt> \
        --config egs/datasets/videos/May/lm3d_radnerf_import.yaml \
        --out checkpoints/<exp> [--head_only] [--hparams k=v,...]

Writes ``<out>/model_ckpt_steps_<N>.ckpt`` (the parameters, the occupancy,
for a torso checkpoint its 2-D grid; no optimizer state) through
:func:`geneface_tpu_torch.utils.torch_import.import_radnerf_checkpoint`.
``python -m geneface_tpu_torch.tasks.run --config <yaml> --exp_name <exp>``
then renders it (``--infer``) or fine-tunes it from step ``N``.
"""

from __future__ import annotations

import argparse
import sys

__all__ = ["main"]


def main(argv: list | None = None) -> int:
    from geneface_tpu_torch.config import load_config
    from geneface_tpu_torch.utils.torch_import import import_radnerf_checkpoint

    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True, help="GeneFace work dir or model_ckpt_steps_*.ckpt")
    ap.add_argument("--config", required=True, help="the model's config (the import config)")
    ap.add_argument("--out", required=True, help="the port's work dir to write")
    ap.add_argument("--head_only", action="store_true", help="import a torso checkpoint's head")
    ap.add_argument("--hparams", default="")
    a = ap.parse_args(argv)
    cfg = load_config(a.config, overrides=a.hparams)
    path = import_radnerf_checkpoint(a.ckpt, cfg, a.out, torso=False if a.head_only else None)
    print(f"imported {a.ckpt} as {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
