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


def test_walk_covers_vanilla_nerf():
    """The vanilla NeRF modules, every one that ``chip_smoke.py``'s
    ``nerf_serve`` and ``nerf_train`` import inside their functions, are
    among those imported above."""
    mods = set(_port_modules())
    for name in ("ops.volume", "ops.geometry", "models.nerf.backbone", "models.nerf.models",
                 "data.nerf_dataset", "data.ray_samplers", "tasks.lm3d_nerf",
                 "inference.nerf_infer", "inference.landmark_postprocess", "config.config",
                 "models.radnerf.cond_encoder", "utils.checkpoint", "kernels"):
        assert f"geneface_tpu_torch.{name}" in mods, name


def test_walk_covers_asr_and_pose():
    """The ASR conditions, the streaming ASR and audio2pose (every module
    that ``chip_smoke.py``'s ``asr`` and ``pose`` import inside their
    functions) are among the modules imported above, and the task map knows
    every JAX task class."""
    mods = set(_port_modules())
    for name in ("datagen._ds_audio", "datagen.deepspeech", "datagen.asr_features",
                 "datagen.streaming_asr", "datagen.wav2vec2", "models.audio2pose",
                 "models.audio2pose.gmm", "models.audio2pose.models", "tasks.audio2pose",
                 "inference.audio2pose_infer", "inference.nerf_infer", "utils.torch_import"):
        assert f"geneface_tpu_torch.{name}" in mods, name
    import ast

    from geneface_tpu_torch.tasks.run import TASKS

    jax_tasks = set()
    tasks_dir = os.path.join(REPO, "geneface_tpu", "tasks")
    for fname in sorted(os.listdir(tasks_dir)):
        if not fname.endswith(".py") or fname in ("__init__.py", "run.py"):
            continue
        tree = ast.parse(open(os.path.join(tasks_dir, fname)).read())
        for node in tree.body:
            if isinstance(node, ast.ClassDef) and node.name.endswith("Task") and not \
                    node.name.startswith("_"):
                jax_tasks.add(f"geneface_tpu.tasks.{fname[:-3]}.{node.name}")
    assert jax_tasks and jax_tasks <= set(TASKS), sorted(jax_tasks - set(TASKS))


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


def test_parallel_and_native_import_no_jax():
    """``parallel/`` and ``native/`` are among the modules imported above,
    and running them — a one-rank gloo group with its mesh, a batch split,
    the native library's build and a gather — pulls in no JAX, flax or
    ``geneface_tpu`` either."""
    mods = set(_port_modules())
    for name in ("parallel", "parallel.mesh", "native", "native.build"):
        assert f"geneface_tpu_torch.{name}" in mods, name
    code = (
        "import os, sys, socket\n"
        "import numpy as np, torch\n"
        "from geneface_tpu_torch import parallel\n"
        "from geneface_tpu_torch.native import NativeBatchLoader\n"
        "s = socket.socket(); s.bind(('127.0.0.1', 0)); port = s.getsockname()[1]; s.close()\n"
        "os.environ.update(WORLD_SIZE='1', RANK='0', LOCAL_RANK='0',\n"
        "                  MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port))\n"
        "assert parallel.initialize_distributed('cpu') == torch.device('cpu')\n"
        "mesh = parallel.make_mesh()\n"
        "out = parallel.shard_batch(mesh, {'x': np.arange(4)})\n"
        "assert out['x'].tolist() == [0, 1, 2, 3]\n"
        "u8 = np.zeros((1, 4, 3), np.uint8)\n"
        "NativeBatchLoader(u8, u8, u8[0]).gather(0, np.arange(4, dtype=np.int32))\n"
        "torch.distributed.destroy_process_group()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'geneface_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"
