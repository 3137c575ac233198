"""Pipeline-progress checkpoints (port of ``daft_tpu/checkpoint.py``).

Reference: src/daft-checkpoint + daft/checkpoint.py — records the source keys
a pipeline has processed so that running it again skips them (this is not
model checkpointing; that is ``models/checkpoint.py``).
``df.with_checkpoint(cfg)`` anti-filters the keys already done, and a write
with ``checkpoint=cfg`` seals the keys it wrote once the write is done (the
reference's CheckpointTerminus). Keys are stored as parquet files under a
directory: a local path or any URI that ``io/scan.py::resolve_filesystem``
resolves (object stores included), as in the JAX package.
"""

from __future__ import annotations

import threading
import uuid
from dataclasses import dataclass
from typing import List, Set

import pyarrow as pa
import pyarrow.fs as pafs
import pyarrow.parquet as pq


class CheckpointStore:
    """Processed keys under a directory, as parquet key files (reference:
    src/daft-checkpoint/src/{store.rs,impls})."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()

    def _fs(self):
        from daft_tpu_torch.io.scan import resolve_filesystem

        return resolve_filesystem(self.path)

    def load_keys(self) -> Set:
        fs, p = self._fs()
        if fs.get_file_info(p).type == pafs.FileType.NotFound:
            return set()
        out: Set = set()
        for f in fs.get_file_info(pafs.FileSelector(p, recursive=True)):
            if f.type == pafs.FileType.File and f.path.endswith(".parquet"):
                with fs.open_input_file(f.path) as fh:
                    out.update(pq.read_table(fh).column("key").to_pylist())
        return out

    def append_keys(self, keys: List) -> None:
        if not keys:
            return
        fs, p = self._fs()
        fs.create_dir(p, recursive=True)
        table = pa.table({"key": keys})
        with self._lock:
            with fs.open_output_stream(f"{p}/keys-{uuid.uuid4().hex[:12]}.parquet") as out:
                pq.write_table(table, out)

    def clear(self) -> None:
        fs, p = self._fs()
        if fs.get_file_info(p).type != pafs.FileType.NotFound:
            fs.delete_dir_contents(p)


@dataclass
class CheckpointConfig:
    store: CheckpointStore
    on: str  # the key column's name

    def filter_done(self, df):
        """``df`` without the rows whose key was already processed. The keys
        sort by ``repr``, so int and str keys sealed by different runs mix."""
        from daft_tpu_torch.expressions.expression import col

        done = self.store.load_keys()
        if not done:
            return df
        return df.where(~col(self.on).is_in(sorted(done, key=repr)))

    def seal(self, df) -> None:
        """Record the keys of a fully processed DataFrame. This runs ``df``
        if it is not materialised; ``seal_partitions`` takes partitions
        already materialised."""
        keys = df.select(self.on).distinct().to_pydict()[self.on]
        self.store.append_keys([k for k in keys if k is not None])

    def seal_partitions(self, partitions, schema) -> None:
        """Record the keys of partitions already materialised, running
        nothing again."""
        keys: Set = set()
        for part in partitions:
            column = part.combined().get_column(self.on)
            keys.update(k for k in column.unique().to_pylist() if k is not None)
        self.store.append_keys(sorted(keys, key=repr))
