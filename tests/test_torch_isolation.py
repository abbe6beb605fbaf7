"""The port and ``chip_smoke.py`` import neither JAX/flax nor the JAX
package: every module is imported in a fresh interpreter and
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
        "('jax', 'jaxlib', 'flax', 'geneface_tpu'))\n"
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
