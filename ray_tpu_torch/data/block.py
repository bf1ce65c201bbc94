"""Block layer: the unit of distributed data.

Reference analogue: python/ray/data/block.py + _internal/arrow_block.py /
pandas_block.py / simple_block.py. A Dataset is a list of object refs to
Blocks. A Block is one of:

- a ``pyarrow.Table``            (tabular data — the default for files)
- a ``dict[str, np.ndarray]``    (tensor batch — TPU-first native form; maps
                                  straight to a jit input without conversion)
- a ``list``                     (simple block of arbitrary Python rows)

``BlockAccessor.for_block`` dispatches uniform operations (slice, concat,
format conversion, sampling) over all three. The tensor-dict form is the
TPU-first addition: batches stay as contiguous numpy arrays end-to-end so
a column reaches the device in one host-to-device copy.
"""

from __future__ import annotations

import random
import sys
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Union

import numpy as np

try:
    import pyarrow as pa
except ImportError:  # pragma: no cover - pyarrow is baked into the image
    pa = None

Block = Union["pa.Table", Dict[str, np.ndarray], List[Any]]

# Name used when wrapping bare arrays / scalar rows into columnar form
# (reference: ray.data uses "value"/"__value__" for tensor datasets).
VALUE_COL = "value"


@dataclass
class BlockMetadata:
    """Reference analogue: ray.data.block.BlockMetadata."""
    num_rows: int
    size_bytes: int
    schema: Any = None
    input_files: Optional[List[str]] = None


class BlockAccessor:
    """Uniform ops over the three block representations."""

    def __init__(self, block: Block):
        self._block = block

    # ------------------------------------------------------------ dispatch

    @staticmethod
    def for_block(block: Block) -> "BlockAccessor":
        if pa is not None and isinstance(block, pa.Table):
            return ArrowBlockAccessor(block)
        if isinstance(block, dict):
            return TensorBlockAccessor(block)
        if isinstance(block, list):
            return SimpleBlockAccessor(block)
        try:
            import pandas as pd
            if isinstance(block, pd.DataFrame):
                return ArrowBlockAccessor(pa.Table.from_pandas(block))
        except ImportError:
            pass
        raise TypeError(f"not a valid block type: {type(block)}")

    @staticmethod
    def batch_to_block(batch: Any) -> Block:
        """Normalize a user-returned batch into a block."""
        if pa is not None and isinstance(batch, pa.Table):
            return batch
        if isinstance(batch, dict):
            return {k: np.asarray(v) for k, v in batch.items()}
        if isinstance(batch, np.ndarray):
            return {VALUE_COL: batch}
        if isinstance(batch, list):
            return batch
        try:
            import pandas as pd
            if isinstance(batch, pd.DataFrame):
                return pa.Table.from_pandas(batch)
        except ImportError:
            pass
        raise TypeError(
            f"map_batches UDF returned {type(batch)}; expected dict of "
            "ndarrays, ndarray, pyarrow.Table, pandas.DataFrame, or list")

    # ----------------------------------------------------------- interface

    def num_rows(self) -> int:
        raise NotImplementedError

    def size_bytes(self) -> int:
        raise NotImplementedError

    def schema(self) -> Any:
        raise NotImplementedError

    def slice(self, start: int, end: int) -> Block:
        raise NotImplementedError

    def to_pylist(self) -> List[Any]:
        raise NotImplementedError

    def to_numpy(self) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def to_arrow(self) -> "pa.Table":
        raise NotImplementedError

    def to_pandas(self):
        return self.to_arrow().to_pandas()

    def to_batch(self, batch_format: str) -> Any:
        if batch_format in ("default", "numpy"):
            out = self.to_numpy()
            if set(out.keys()) == {VALUE_COL}:
                return out[VALUE_COL]
            return out
        if batch_format == "pandas":
            return self.to_pandas()
        if batch_format in ("pyarrow", "arrow"):
            return self.to_arrow()
        if batch_format == "pylist":
            return self.to_pylist()
        raise ValueError(f"unknown batch_format {batch_format!r}")

    def select(self, indices: List[int]) -> Block:
        raise NotImplementedError

    def get_metadata(self, input_files: Optional[List[str]] = None
                     ) -> BlockMetadata:
        return BlockMetadata(self.num_rows(), self.size_bytes(),
                             self.schema(), input_files)

    def sample_rows(self, n: int, seed: Optional[int] = None) -> List[Any]:
        rows = self.to_pylist()
        rng = random.Random(seed)
        if n >= len(rows):
            return rows
        return rng.sample(rows, n)

    def sort_key_values(self, key) -> List[Any]:
        """Values of the sort key for every row (for boundary sampling)."""
        return [_key_of(r, key) for r in self.to_pylist()]

    # ------------------------------------------------------------- statics

    @staticmethod
    def concat(blocks: List[Block]) -> Block:
        blocks = [b for b in blocks
                  if BlockAccessor.for_block(b).num_rows() > 0]
        if not blocks:
            return []
        first = BlockAccessor.for_block(blocks[0])
        if isinstance(first, ArrowBlockAccessor):
            return pa.concat_tables(
                [BlockAccessor.for_block(b).to_arrow() for b in blocks],
                promote_options="permissive")
        if isinstance(first, TensorBlockAccessor):
            keys = list(blocks[0].keys())
            return {k: np.concatenate(
                [np.asarray(b[k]) for b in blocks]) for k in keys}
        out: List[Any] = []
        for b in blocks:
            out.extend(BlockAccessor.for_block(b).to_pylist())
        return out


def _key_of(row: Any, key) -> Any:
    if key is None:
        return row
    if callable(key):
        return key(row)
    if isinstance(row, dict):
        return row[key]
    return getattr(row, key)


def _deep_size(obj: Any, depth: int = 3) -> int:
    """Recursive size estimate: getsizeof is SHALLOW — a dict row of
    512 KiB ndarrays reported ~100 bytes, making size-based splitting
    and spill accounting blind to the real payload."""
    if isinstance(obj, np.ndarray):
        return int(obj.nbytes)
    if depth <= 0:
        return sys.getsizeof(obj)
    if isinstance(obj, dict):
        return sys.getsizeof(obj) + sum(
            _deep_size(v, depth - 1) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        n = len(obj)
        if not n:
            return sys.getsizeof(obj)
        sample = obj[:100]
        est = sum(_deep_size(v, depth - 1) for v in sample)
        return sys.getsizeof(obj) + int(est * (n / len(sample)))
    return sys.getsizeof(obj)


class SimpleBlockAccessor(BlockAccessor):
    def num_rows(self) -> int:
        return len(self._block)

    def size_bytes(self) -> int:
        n = len(self._block)
        if not n:
            return 0
        sample = self._block[:100]
        return int(sum(_deep_size(r) for r in sample) * (n / len(sample)))

    def schema(self) -> Any:
        return type(self._block[0]).__name__ if self._block else None

    def slice(self, start: int, end: int) -> Block:
        return self._block[start:end]

    def to_pylist(self) -> List[Any]:
        return list(self._block)

    def to_numpy(self) -> Dict[str, np.ndarray]:
        if self._block and isinstance(self._block[0], dict):
            keys = self._block[0].keys()
            return {k: np.asarray([r[k] for r in self._block]) for k in keys}
        return {VALUE_COL: np.asarray(self._block)}

    def to_arrow(self) -> "pa.Table":
        if self._block and isinstance(self._block[0], dict):
            return pa.Table.from_pylist(self._block)
        return pa.table({VALUE_COL: self._block})

    def select(self, indices: List[int]) -> Block:
        return [self._block[i] for i in indices]


class TensorBlockAccessor(BlockAccessor):
    def _cols(self) -> Dict[str, np.ndarray]:
        return self._block

    def num_rows(self) -> int:
        if not self._block:
            return 0
        return len(next(iter(self._block.values())))

    def size_bytes(self) -> int:
        return int(sum(np.asarray(v).nbytes for v in self._block.values()))

    def schema(self) -> Any:
        return {k: (np.asarray(v).dtype.str, np.asarray(v).shape[1:])
                for k, v in self._block.items()}

    def slice(self, start: int, end: int) -> Block:
        return {k: np.asarray(v)[start:end] for k, v in self._block.items()}

    def to_pylist(self) -> List[Any]:
        n = self.num_rows()
        keys = list(self._block.keys())
        if keys == [VALUE_COL]:
            return list(self._block[VALUE_COL])
        return [{k: self._block[k][i] for k in keys} for i in range(n)]

    def to_numpy(self) -> Dict[str, np.ndarray]:
        return {k: np.asarray(v) for k, v in self._block.items()}

    def to_arrow(self) -> "pa.Table":
        import json
        arrays, fields = [], []
        for k, v in self._block.items():
            v = np.asarray(v)
            if v.ndim > 1:
                # flatten fixed-shape tensors into FixedSizeList columns;
                # the row shape rides in field metadata so to_numpy can
                # restore ndim>2 tensors losslessly
                flat = v.reshape(len(v), -1)
                arr = pa.FixedSizeListArray.from_arrays(
                    pa.array(flat.ravel()), flat.shape[1])
                fields.append(pa.field(
                    k, arr.type,
                    metadata={b"tensor_shape":
                              json.dumps(v.shape[1:]).encode()}))
                arrays.append(arr)
            else:
                arr = pa.array(v)
                fields.append(pa.field(k, arr.type))
                arrays.append(arr)
        return pa.Table.from_arrays(arrays, schema=pa.schema(fields))

    def select(self, indices: List[int]) -> Block:
        idx = np.asarray(indices, dtype=np.int64)
        return {k: np.asarray(v)[idx] for k, v in self._block.items()}


class ArrowBlockAccessor(BlockAccessor):
    def num_rows(self) -> int:
        return self._block.num_rows

    def size_bytes(self) -> int:
        return self._block.nbytes

    def schema(self) -> Any:
        return self._block.schema

    def slice(self, start: int, end: int) -> Block:
        return self._block.slice(start, end - start)

    def to_pylist(self) -> List[Any]:
        return self._block.to_pylist()

    def to_numpy(self) -> Dict[str, np.ndarray]:
        import json
        out = {}
        for name in self._block.column_names:
            col = self._block.column(name)
            if pa.types.is_fixed_size_list(col.type):
                flat = np.asarray(col.combine_chunks().flatten())
                field = self._block.schema.field(name)
                meta = field.metadata or {}
                if b"tensor_shape" in meta:
                    shape = tuple(json.loads(meta[b"tensor_shape"]))
                    out[name] = flat.reshape(
                        (self._block.num_rows,) + shape)
                else:
                    out[name] = flat.reshape(self._block.num_rows, -1)
            else:
                out[name] = np.asarray(col)
        return out

    def to_arrow(self) -> "pa.Table":
        return self._block

    def select(self, indices: List[int]) -> Block:
        return self._block.take(pa.array(indices, type=pa.int64()))
