"""The port and ``chip_smoke.py`` import neither JAX/flax, ``transformers``
nor the JAX package: every module is imported in a fresh interpreter and
``sys.modules`` is checked afterwards."""

import os
import pkgutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    import geneface_tpu_torch

    names = ["geneface_tpu_torch"]
    for info in pkgutil.walk_packages(geneface_tpu_torch.__path__, "geneface_tpu_torch."):
        names.append(info.name)
    return names


@pytest.mark.parametrize("extra", [[], ["chip_smoke"]], ids=["package", "chip_smoke"])
def test_imports_no_jax(extra):
    mods = _port_modules() + extra
    assert len(mods) > 15
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'transformers', 'geneface_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok")


def test_walk_covers_the_import_path():
    """The modules that read GeneFace checkpoints and the grid backends of
    the import layout are among those imported above."""
    mods = set(_port_modules())
    for name in ("geneface_tpu_torch.utils.torch_import", "geneface_tpu_torch.tools",
                 "geneface_tpu_torch.tools.validate_import", "geneface_tpu_torch.ops.encoders",
                 "geneface_tpu_torch.utils.checkpoint"):
        assert name in mods, name


def test_walk_covers_stage_a_training():
    """The LRS3 store, SyncNet, the training tasks of stage A and the
    optimizers are among the modules imported above."""
    mods = set(_port_modules())
    for name in ("geneface_tpu_torch.utils.indexed_dataset",
                 "geneface_tpu_torch.data.lrs3_dataset",
                 "geneface_tpu_torch.models.syncnet.models",
                 "geneface_tpu_torch.tasks.syncnet", "geneface_tpu_torch.tasks.audio2motion",
                 "geneface_tpu_torch.tasks.postnet", "geneface_tpu_torch.training.optim"):
        assert name in mods, name
