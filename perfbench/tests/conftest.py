"""Fixtures of the benchmark's own tests: the harness on the CPU at a tiny
size, with the person's dataset made in a temporary directory.

Run them with ``python -m pytest perfbench/tests``; the tests marked
``cuda`` need the card and skip without it.
"""

from __future__ import annotations

import os
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (HERE, os.path.dirname(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: the cells' configurations cut to a size a test run holds (the CPU runs
#: the program's plain path)
TINY = dict(dataset_frames=6, dataset_hw=32, n_rays=512, grid_size=32, tb_log_interval=2)

#: the limits at that size, from readings of three seeds on the CPU: sound
#: runs read frames 0, losses ≤ 7.6e-3, first gradients ≤ 1.1e-5 (head) and
#: 5.3e-8 (torso), changes ≤ 0.069; the bfloat16-grid control reads frames
#: ≥ 3.6e-3 and first gradients ≥ 0.31 (head) and 2.5e-4 (torso); half a
#: batch reads losses ≥ 0.043, gradients ≥ 0.15, changes ≥ 0.28; a state left
#: unchanged reads a change of 1. (Adam's first steps move every leaf by its
#: learning rate whatever the gradient's size, so the later steps of so few
#: rays part further than at the cells' size.)
TINY_LIMITS = {
    "head_train": {"loss_rel_gap": 0.02, "grad1_leaf_gap": 1e-3, "change_leaf_gap": 0.15,
                   "batch_pixel_levels": 0.0, "window_loss_rel_gap": 0.02,
                   "window_grad1_leaf_gap": 1e-3, "window_change_leaf_gap": 0.15},
    "torso_train": {"loss_rel_gap": 0.02, "grad1_leaf_gap": 1e-5, "change_leaf_gap": 0.15,
                    "batch_pixel_levels": 0.0, "window_loss_rel_gap": 0.02,
                    "window_grad1_leaf_gap": 1e-5, "window_change_leaf_gap": 0.15,
                    "head_frozen_gap": 0.0},
    "head_video": {"frame_rgb_gap": 1e-4, "frame_u8_exact": 0.0},
    "torso_live": {"frame_rgb_gap": 1e-4, "frame_u8_exact": 0.0},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips when CUDA is absent")


@pytest.fixture(scope="session")
def pb_cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("pb_cache"))


def bench_with_later() -> dict:
    """``BENCHMARK.json`` with the entries of the cells kept in
    ``perfbench/later/`` (built, not yet measured on the card) added."""
    import glob
    import json

    with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as f:
        bench = json.load(f)
    for path in sorted(glob.glob(os.path.join(HERE, "later", "*.json"))):
        with open(path) as f:
            later = json.load(f)
        for key in ("workloads", "end_to_end", "per_layer"):
            bench[key] = bench[key] + later[key]
    return bench


@pytest.fixture
def harness(pb_cache, tmp_path, monkeypatch):
    """``run`` with the dataset cache in a temporary directory, the run's
    work directories in the test's own, and the later cells found by name."""
    import tempfile

    import run
    from pbcore import scene

    monkeypatch.setattr(scene, "CACHE", pb_cache)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    real = run.cell_spec
    monkeypatch.setattr(run, "cell_spec", lambda name, bench=None: real(name, bench or bench_with_later()))
    return run


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
