"""Append-only binary record store (port of
``geneface_tpu/utils/indexed_dataset.py``, the same on-disk format).

- ``<path>.data``: a reserved header region of ``header_size`` bytes
  (default 16 MiB) followed by the concatenated pickled records. On
  ``finalize`` the header receives the length of the index blob as 32
  little-endian bytes at offset 0, and the pickled index dict (``offsets``,
  absolute byte offsets; ``id2pos``, an id → position map; ``meta``, with
  ``gzip`` and ``chunk_begin``) at offset 32.
- overflow chunks ``<path>.<k>.data`` once a chunk exceeds
  ``max_chunk_size``.

Reads go through the native mmap reader
(:class:`~geneface_tpu_torch.native.NativeStore`) by default, as in the JAX
package, or with ``use_native=False`` through plain Python seeks into the
chunk files. A failed native build or open raises.
"""

from __future__ import annotations

import gzip as gzip_mod
import os
import pickle
from bisect import bisect
from typing import Any, Iterator

__all__ = ["IndexedDataset", "IndexedDatasetBuilder"]

_HEADER_LEN_BYTES = 32
_DEFAULT_HEADER_SIZE = 16 * 1024 * 1024


class IndexedDataset:
    """Random-access reader over a finalized store."""

    def __init__(self, path: str, use_native: bool = True):
        self.path = path
        with open(f"{path}.data", "rb") as f:
            index_len = int.from_bytes(f.read(_HEADER_LEN_BYTES), "little")
            index = pickle.loads(f.read(index_len))
        self.offsets: list[int] = list(index["offsets"])
        self.id2pos: dict = dict(index.get("id2pos", {}))
        self.meta: dict = dict(index.get("meta", {}))
        self.gzip: bool = bool(self.meta.get("gzip", False))
        self.chunk_begin: list[int] = list(self.meta.get("chunk_begin", [0]))
        self.native = None
        if use_native:
            from geneface_tpu_torch.native import NativeStore

            self.native = NativeStore(
                [self._chunk_path(k) for k in range(len(self.chunk_begin))], self.chunk_begin)

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def _chunk_path(self, chunk_id: int) -> str:
        return f"{self.path}.data" if chunk_id == 0 else f"{self.path}.{chunk_id}.data"

    def read_bytes(self, i: int) -> bytes:
        if self.id2pos and i in self.id2pos:
            i = self.id2pos[i]
        if not 0 <= i < len(self):
            raise IndexError(f"record {i} out of range [0, {len(self)})")
        if self.native is not None:
            return self.native.read(self.offsets[i], self.offsets[i + 1] - self.offsets[i])
        chunk_id = bisect(self.chunk_begin[1:], self.offsets[i])
        with open(self._chunk_path(chunk_id), "rb") as f:
            f.seek(self.offsets[i] - self.chunk_begin[chunk_id])
            return f.read(self.offsets[i + 1] - self.offsets[i])

    def __getitem__(self, i: int) -> Any:
        b = self.read_bytes(i)
        if self.gzip:
            b = gzip_mod.decompress(b)
        return pickle.loads(b)

    def __iter__(self) -> Iterator[Any]:
        for i in range(len(self)):
            yield self[i]


class IndexedDatasetBuilder:
    """Sequential writer of the same layout."""

    def __init__(self, path: str, gzip: bool = False, max_chunk_size: int = 64 * 1024**3,
                 header_size: int = _DEFAULT_HEADER_SIZE):
        self.path = path
        self.header_size = header_size
        self.max_chunk_size = max_chunk_size
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.root_file = open(f"{path}.data", "wb")
        self.root_file.seek(header_size)
        self.cur_file = self.root_file
        self.offsets = [header_size]
        self.id2pos: dict = {}
        self.meta: dict = {"gzip": gzip, "chunk_begin": [0]}
        self.gzip = gzip
        self._chunk_id = 0

    def add_item(self, item: Any, id: Any = None, raw: bool = False) -> None:
        if self.offsets[-1] > self.meta["chunk_begin"][-1] + self.max_chunk_size:
            if self.cur_file is not self.root_file:
                self.cur_file.close()
            self._chunk_id += 1
            self.cur_file = open(f"{self.path}.{self._chunk_id}.data", "wb")
            self.meta["chunk_begin"].append(self.offsets[-1])
        blob = item if raw else pickle.dumps(item)
        if self.gzip and not raw:
            blob = gzip_mod.compress(blob, 1)
        n = self.cur_file.write(blob)
        if id is not None:
            self.id2pos[id] = len(self.offsets) - 1
        self.offsets.append(self.offsets[-1] + n)

    def finalize(self) -> None:
        index = pickle.dumps({"offsets": self.offsets, "id2pos": self.id2pos, "meta": self.meta})
        if len(index) + _HEADER_LEN_BYTES > self.header_size:
            raise ValueError(
                f"index blob ({len(index)} B) exceeds header region ({self.header_size} B); "
                "rebuild with a larger header_size")
        self.root_file.seek(0)
        self.root_file.write(len(index).to_bytes(_HEADER_LEN_BYTES, "little"))
        self.root_file.seek(_HEADER_LEN_BYTES)
        self.root_file.write(index)
        self.root_file.close()
        if self.cur_file is not self.root_file:
            self.cur_file.close()
