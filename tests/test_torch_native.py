"""The port's native host library (``geneface_tpu_torch/csrc/gf_native.cpp``
through ``geneface_tpu_torch/native``) against the JAX package's
(``geneface_tpu/native``), both built with ``g++`` here.

Exact: the gather (pixels and the fixed-point torso-over-background
composite, with and without alpha), the seeded and rect jobs of the
prefetch queue, the store's byte reads and the records an
``IndexedDataset`` reads through it, and the port's native batches against
the JAX package's native batches. Within one uint8 level: the port's native
batches against its numpy batches (as ``tests/test_native.py`` holds the
JAX package's). A failed build raises, and processes that build at once
all end with a loadable library.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from geneface_tpu import native as jnative
from geneface_tpu.config import Config as JConfig
from geneface_tpu.data.radnerf_dataset import RADNeRFDataset as JDataset
from geneface_tpu.utils.indexed_dataset import IndexedDataset as JIndexedDataset
from geneface_tpu_torch import native
from geneface_tpu_torch.data.radnerf_dataset import RADNeRFDataset
from geneface_tpu_torch.native import build as native_build
from geneface_tpu_torch.utils.indexed_dataset import IndexedDataset, IndexedDatasetBuilder

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tools.make_synthetic_dataset import make_dataset  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.RandomState(0)
    T, HW = 3, 32 * 48
    return (rng.randint(0, 256, (T, HW, 3), dtype=np.uint8),
            rng.randint(0, 256, (T, HW, 4), dtype=np.uint8),
            rng.randint(0, 256, (HW, 3), dtype=np.uint8))


@pytest.mark.parametrize("channels", [4, 3], ids=["alpha", "rgb"])
def test_gather_is_bit_equal_to_jax(frames, channels):
    gt, torso, bg = frames
    torso = np.ascontiguousarray(torso[..., :channels])
    assert jnative.load_library() is not None
    mine = native.NativeBatchLoader(gt, torso, bg)
    ref = jnative.NativeBatchLoader(gt, torso, bg)
    try:
        inds = np.random.RandomState(1).randint(0, gt.shape[1], 4099).astype(np.int32)
        for f in range(gt.shape[0]):
            for a, b in zip(mine.gather(f, inds), ref.gather(f, inds)):
                np.testing.assert_array_equal(a, b)
        with pytest.raises(IndexError):
            mine.gather(0, np.asarray([gt.shape[1]], np.int32))
    finally:
        mine.close()
        ref.close()


def test_queue_jobs_are_bit_equal_to_jax(frames):
    gt, torso, bg = frames
    mine = native.NativeBatchLoader(gt, torso, bg, n_threads=3)
    ref = jnative.NativeBatchLoader(gt, torso, bg, n_threads=3)
    try:
        for L in (mine, ref):
            for f in range(3):
                L.submit(f, 500, seed=40 + f)
            L.submit(1, 0, seed=0, rect=(3, 5, 4, 6), W=48)
        for _ in range(4):
            for a, b in zip(mine.wait(), ref.wait()):
                np.testing.assert_array_equal(a, b)
    finally:
        mine.close()
        ref.close()


def test_store_reads_are_bit_equal_to_jax(tmp_path):
    path = str(tmp_path / "store")
    builder = IndexedDatasetBuilder(path, header_size=8192, max_chunk_size=2048)
    items = [{"i": i, "x": np.arange(i * 7 + 1, dtype=np.float32)} for i in range(30)]
    for it in items:
        builder.add_item(it)
    builder.finalize()
    ds = IndexedDataset(path)  # the native reader by default
    assert ds.native is not None and len(ds.chunk_begin) > 1  # several chunk files
    plain = IndexedDataset(path, use_native=False)
    ref = JIndexedDataset(path)
    assert ref.native is not None
    for i in range(len(items)):
        raw = ds.read_bytes(i)
        assert raw == ref.read_bytes(i) == plain.read_bytes(i)
        np.testing.assert_array_equal(pickle.loads(raw)["x"], items[i]["x"])
    st = native.NativeStore([ds._chunk_path(k) for k in range(len(ds.chunk_begin))],
                            ds.chunk_begin)
    try:
        st.prefetch(ds.offsets[3], 64)
        assert st.read(ds.offsets[3], 64) == ref.native.read(ds.offsets[3], 64)
        with pytest.raises(OSError):
            st.read(ds.offsets[-1] + 10**9, 4)
    finally:
        st.close()
    with pytest.raises(OSError):
        native.NativeStore([str(tmp_path / "missing.data")], [0])


def test_dataset_native_batches(tmp_path):
    """The port's default (native) batches equal the JAX package's native
    ones and agree with the port's numpy path within one uint8 level."""
    make_dataset(str(tmp_path), n_frames=3, hw=32)
    base = dict(data_dir=str(tmp_path), cond_type="idexp_lm3d_normalized", cond_win_size=1,
                smo_win_size=5, n_rays=128, lip_patch_size=16, seed=3)
    nat = RADNeRFDataset("train", str(tmp_path), dict(base), training=True)
    py = RADNeRFDataset("train", str(tmp_path), dict(base, native_loader=False), training=True)
    jnat = JDataset("train", str(tmp_path), JConfig(**base), training=True)
    assert nat.native_loader is not None and py.native_loader is None
    assert jnat.native_loader is not None
    for idx in (0, 1, 0):
        a, b, c = nat[idx], py[idx], jnat[idx]
        np.testing.assert_array_equal(a["inds"], b["inds"])
        for k in ("gt_img_u8", "bg_img_u8", "bg_torso_img_u8"):
            np.testing.assert_array_equal(a[k], c[k], err_msg=k)
            d = np.abs(a[k].astype(np.int16) - b[k].astype(np.int16)).max()
            assert d <= 1, (k, d)
    # the lip patch too
    nat.finetune_lip_flag = py.finetune_lip_flag = True
    a, b = nat[1], py[1]
    np.testing.assert_array_equal(a["inds"], b["inds"])
    assert np.abs(a["bg_torso_img_u8"].astype(np.int16) - b["bg_torso_img_u8"]).max() <= 1


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="gf_native build failed"):
        native_build.build(str(bad), str(tmp_path / "libbad.so"))
    assert not any(p.name.endswith(".part") for p in tmp_path.iterdir())
    monkeypatch.setattr(native_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native_build.build(native_build.SRC, str(tmp_path / "libnone.so"))


def test_concurrent_builds_end_with_one_library(tmp_path):
    lib = str(tmp_path / "libgf_native.so")
    code = ("import sys; from geneface_tpu_torch.native.build import build, SRC; "
            "import ctypes; ctypes.CDLL(build(SRC, sys.argv[1]))")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, "-c", code, lib], cwd=repo,
                              stderr=subprocess.PIPE, text=True) for _ in range(3)]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
    assert os.path.exists(lib)
    assert not any(p.name.endswith(".part") for p in tmp_path.iterdir())
