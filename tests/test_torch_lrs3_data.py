"""The port's LRS3 store and batching against the JAX package on the CPU:
the port reads a store the JAX builder wrote (``make_lrs3``) item for
item, the JAX reader (``use_native=False``) reads the port builder's
stores — plain, gzip, and split over overflow chunks — exactly, and
``batch_by_size``, ``collate_seq_batch`` and ``iter_batches`` give the same
batches (``sizes_<prefix>.npy`` written by either package)."""

import os

import numpy as np
import pytest

from geneface_tpu.data import lrs3_dataset as jds
from geneface_tpu.utils.indexed_dataset import IndexedDataset as JIndexedDataset
from geneface_tpu_torch.data import lrs3_dataset as ds
from geneface_tpu_torch.utils.indexed_dataset import IndexedDataset, IndexedDatasetBuilder
from tools.make_synthetic_lrs3 import make_lrs3


def assert_items_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.fixture(scope="module")
def jax_store(tmp_path_factory):
    return make_lrs3(str(tmp_path_factory.mktemp("lrs3")), n_train=7, n_val=3)


def test_port_reads_the_jax_builders_store(jax_store):
    for prefix in ("train", "val"):
        j = JIndexedDataset(os.path.join(jax_store, prefix), use_native=False)
        p = IndexedDataset(os.path.join(jax_store, prefix))
        assert len(p) == len(j) and p.offsets == j.offsets and p.id2pos == j.id2pos
        for i in range(len(j)):
            assert p.read_bytes(i) == j.read_bytes(i)
            assert_items_equal(p[i], j[i])


def _items(n, seed=0):
    rng = np.random.RandomState(seed)
    for i in range(n):
        T = rng.randint(20, 40)
        yield {"hubert": rng.randn(2 * T, 8).astype(np.float32),
               "f0": rng.rand(2 * T).astype(np.float32),
               "idexp_lm3d": rng.randn(T, 68, 3).astype(np.float32), "item_id": f"c{i}"}


@pytest.mark.parametrize("gzip,chunk", [(False, 64 * 1024**3), (True, 64 * 1024**3),
                                        (False, 20000), (True, 9000)],
                         ids=["plain", "gzip", "chunks", "gzip_chunks"])
def test_jax_reads_the_port_builders_store(tmp_path, gzip, chunk):
    path = str(tmp_path / "train")
    b = IndexedDatasetBuilder(path, gzip=gzip, max_chunk_size=chunk, header_size=1 << 16)
    items = list(_items(9))
    for i, it in enumerate(items):
        b.add_item(it, id=100 + i)
    b.finalize()
    n_chunks = len([f for f in os.listdir(tmp_path) if f.endswith(".data")])
    assert (n_chunks > 2) == (chunk < 10**6)
    j = JIndexedDataset(path, use_native=False)
    p = IndexedDataset(path)
    assert len(j) == len(items) and j.gzip == gzip and j.chunk_begin == p.chunk_begin
    for i, it in enumerate(items):
        assert_items_equal(j[100 + i], it)
        assert_items_equal(p[100 + i], it)
        assert j.read_bytes(i) == p.read_bytes(i)


def test_index_overflow_raises(tmp_path):
    b = IndexedDatasetBuilder(str(tmp_path / "x"), header_size=64)
    for it in _items(3):
        b.add_item(it)
    with pytest.raises(ValueError, match="header"):
        b.finalize()


@pytest.mark.parametrize("max_tokens,max_sentences", [(300, 512), (160, 2), (10**6, 3)])
def test_batch_by_size_matches(max_tokens, max_sentences):
    sizes = list(np.random.RandomState(1).randint(0, 80, 40))
    sizes[3] = 0  # an empty clip is dropped
    want = jds.batch_by_size(sizes, max_tokens, max_sentences)
    assert ds.batch_by_size(sizes, max_tokens, max_sentences) == want
    with pytest.raises(ValueError):
        ds.batch_by_size([5, 400], 300)


def test_collate_and_iter_batches_match(jax_store, tmp_path):
    items = [ds.LRS3SeqDataset("train", jax_store).item(i) for i in range(3)]
    for pad in (8, 32):
        got, want = ds.collate_seq_batch(items, pad), jds.collate_seq_batch(items, pad)
        assert_items_equal(got, want)
        assert got["y"].shape[1] % pad == 0 and got["hubert"].shape[1] == 2 * got["y"].shape[1]
    # each package writes sizes_<prefix>.npy on first use; the other reads it
    for first, second in ((ds, jds), (jds, ds)):
        d = tmp_path / first.__name__.split(".")[0]
        os.makedirs(d)
        for f in os.listdir(jax_store):
            if f.endswith(".data"):
                os.symlink(os.path.join(jax_store, f), d / f)
        a = first.LRS3SeqDataset("train", str(d), max_tokens=300)
        assert os.path.exists(d / "sizes_train.npy")
        b = second.LRS3SeqDataset("train", str(d), max_tokens=300)
        assert a.batches == b.batches and len(a.batches) > 1
        for shuffle, seed in ((True, 3), (False, 0)):
            ga = a.iter_batches(shuffle=shuffle, seed=seed)
            gb = b.iter_batches(shuffle=shuffle, seed=seed)
            for _ in range(len(a.batches) + 2):  # into the second epoch
                assert_items_equal(next(ga), next(gb))
        val = list(ds.LRS3SeqDataset("val", jax_store).iter_batches(shuffle=False,
                                                                    infinite=False))
        jval = list(jds.LRS3SeqDataset("val", jax_store).iter_batches(shuffle=False,
                                                                      infinite=False))
        assert len(val) == len(jval)
        for x, y in zip(val, jval):
            assert_items_equal(x, y)
