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


def test_walk_covers_datagen():
    """The datagen modules are among those imported above."""
    mods = set(_port_modules())
    for name in ("face_renderer", "face_tracker", "face_parser", "face_landmarker",
                 "face_recon", "process", "binarizer", "resize"):
        assert f"geneface_tpu_torch.datagen.{name}" in mods, name


def test_datagen_path_runs_without_opencv_or_pillow(tmp_path):
    """The card's host has neither OpenCV nor Pillow: with both made
    unimportable, the datagen path from frames in memory to the store runs
    (tiny sizes, on the CPU) — BiSeNet as the parser, FAN as the
    landmarker, the track and its refinement, Deep3DRecon's coefficients
    and the binarizer."""
    code = f"""
import sys
sys.modules["cv2"] = None
sys.modules["PIL"] = None
sys.path.insert(0, {os.path.join(REPO, "tests")!r})
import numpy as np, torch
from scipy.io import wavfile
from torch_datagen_helpers import sphere_cap, torch_full_basis, torch_lm_basis
from geneface_tpu_torch.datagen import extract_3dmm_coeffs
from geneface_tpu_torch.datagen.binarizer import binarize_video
from geneface_tpu_torch.datagen.face_landmarker import FAN, FANLandmarker
from geneface_tpu_torch.datagen.face_parser import BiSeNet, parse_frame
from geneface_tpu_torch.datagen.face_recon import ReconNet, Reconstructor
from geneface_tpu_torch.datagen.process import process_frames
torch.set_num_threads(1)
rng = np.random.RandomState(0)
frames = rng.randint(0, 256, (3, 64, 64, 3)).astype(np.uint8)
wavfile.write({str(tmp_path / "a.wav")!r}, 16000, (rng.randn(4000) * 3000).astype(np.int16))
parser = BiSeNet().eval()
fan = FANLandmarker(FAN(num_modules=1), device="cpu")
b = sphere_cap(rng, nu=8, nv=8)
man = process_frames(frames, {str(tmp_path / "proc")!r},
                     parse_fn=lambda f: parse_frame(parser, f), lm_fn=fan,
                     basis=torch_lm_basis(b), full_basis=torch_full_basis(b),
                     wav_path={str(tmp_path / "a.wav")!r}, device="cpu")
coeffs = extract_3dmm_coeffs(frames, man["lms"], Reconstructor(ReconNet(), device="cpu"))
assert coeffs.shape == (3, 257) and np.isfinite(coeffs).all()
binarize_video(man, {str(tmp_path / "bin")!r}, basis=torch_lm_basis(b))
print("ok", sorted(m for m in sys.modules if m.split(".")[0] in ("cv2", "PIL")))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok ['PIL', 'cv2']"  # the blocked entries
    assert os.path.exists(tmp_path / "bin" / "trainval_dataset.npy")
