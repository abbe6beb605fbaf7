"""LRS3 sequence dataset (port of ``geneface_tpu/data/lrs3_dataset.py``):
random access into the binarized LRS3 store (``hubert``, ``mel``, ``f0``,
``idexp_lm3d`` per clip), size-sorted token bucketing and pad-collate.

Padded batch lengths round up to a multiple of ``pad_multiple`` (32), as in
the JAX package, and ``sizes_<prefix>.npy`` is written into the data dir on
first use, so both packages bucket a store the same way. Batches are numpy
dicts; the tasks move them to their device.
"""

from __future__ import annotations

import os

import numpy as np

from geneface_tpu_torch.utils.indexed_dataset import IndexedDataset

__all__ = ["LRS3SeqDataset", "batch_by_size", "collate_seq_batch"]


def batch_by_size(sizes, max_tokens=60000, max_sentences=512):
    """Size-sorted index bucketing → a list of index lists, each batch at
    most ``max_tokens`` padded tokens and ``max_sentences`` clips."""
    indices = np.argsort(np.asarray(sizes), kind="mergesort")
    batches, batch, sample_len = [], [], 0
    for idx in indices:
        n = sizes[idx]
        if n == 0:
            continue
        if n > max_tokens:
            raise ValueError(f"sample {idx} has {n} tokens > max_tokens {max_tokens}")
        new_len = max(sample_len, n)
        if batch and (len(batch) >= max_sentences or (len(batch) + 1) * new_len > max_tokens):
            batches.append(batch)
            batch, sample_len = [], 0
        batch.append(int(idx))
        sample_len = max(sample_len, n)
    if batch:
        batches.append(batch)
    return batches


def _pad_2d(arrs, max_len):
    out = np.zeros((len(arrs), max_len) + arrs[0].shape[1:], np.float32)
    for i, a in enumerate(arrs):
        out[i, : len(a)] = a
    return out


def collate_seq_batch(items, pad_multiple: int = 32):
    """Pad per-clip dicts into one batch; audio rows are 2× the motion
    frames (HuBERT's 50 Hz against 25 fps landmarks)."""
    y_len = max(len(it["idexp_lm3d"]) for it in items)
    y_len = int(np.ceil(y_len / pad_multiple) * pad_multiple)
    x_len = 2 * y_len
    batch = {
        "hubert": _pad_2d([it["hubert"][: 2 * len(it["idexp_lm3d"])] for it in items], x_len),
        "y": _pad_2d([it["idexp_lm3d"] for it in items], y_len),
        "mouth_lm3d": _pad_2d([it["mouth_idexp_lm3d"] for it in items], y_len),
        "item_names": [it.get("item_name", "") for it in items],
    }
    if "mel" in items[0]:
        batch["mel"] = _pad_2d([it["mel"] for it in items], x_len)
    if "f0" in items[0]:
        batch["f0"] = _pad_2d([it["f0"][:, None] for it in items], x_len)[..., 0]
    batch["y_mask"] = (np.abs(batch["y"]).sum(-1) > 0).astype(np.float32)
    return batch


class LRS3SeqDataset:
    def __init__(self, prefix: str, data_dir: str, max_tokens: int = 60000,
                 pad_multiple: int = 32):
        self.prefix = prefix
        self.ds = IndexedDataset(os.path.join(data_dir, prefix))
        self.pad_multiple = pad_multiple
        sizes_path = os.path.join(data_dir, f"sizes_{prefix}.npy")
        if os.path.exists(sizes_path):
            self.sizes = list(np.load(sizes_path))
        else:
            self.sizes = []
            for item in self.ds:
                self.sizes.append(0 if item is None else item["mel"].shape[0]
                                  if "mel" in item else len(item["hubert"]))
            np.save(sizes_path, self.sizes)
        self.batches = batch_by_size(self.sizes, max_tokens=max_tokens)

    def __len__(self):
        return len(self.ds)

    def item(self, idx: int) -> dict:
        raw = self.ds[idx]
        t = len(raw["idexp_lm3d"])
        lm = np.asarray(raw["idexp_lm3d"], np.float32).reshape(t, 68, 3)
        item = {
            "hubert": np.asarray(raw["hubert"], np.float32),
            "idexp_lm3d": lm.reshape(t, 204),
            "mouth_idexp_lm3d": lm[:, 48:68].reshape(t, 60),
            "item_name": raw.get("item_id", str(idx)),
        }
        if "mel" in raw:
            item["mel"] = np.asarray(raw["mel"], np.float32)
        if "f0" in raw:
            item["f0"] = np.asarray(raw["f0"], np.float32)
        return item

    def iter_batches(self, shuffle: bool = True, seed: int = 0, infinite: bool = True):
        rng = np.random.RandomState(seed)
        while True:
            order = np.arange(len(self.batches))
            if shuffle:
                rng.shuffle(order)
            for bi in order:
                yield collate_seq_batch([self.item(i) for i in self.batches[bi]],
                                        self.pad_multiple)
            if not infinite:
                break
