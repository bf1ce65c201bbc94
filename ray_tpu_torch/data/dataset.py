"""Dataset: distributed data over object-store blocks.

Reference analogue: python/ray/data/dataset.py:139 (Dataset over Blocks,
lazy ExecutionPlan, map/map_batches/filter/flat_map, shuffle/sort/
repartition, split, iter_batches). TPU-first differences:

- the native block form is a dict of contiguous numpy arrays, so a batch
  is already the dict of tensors a training step takes;
- ``iter_batches`` pads the last batch (optional) to keep shapes static,
  and ``iter_device_batches`` prefetches one batch ahead through pinned
  memory on a side CUDA stream, so the host-to-device copy of batch N+1
  overlaps the step on batch N.
"""

from __future__ import annotations

import itertools
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Optional,
                    Union)

import numpy as np

from ray_tpu_torch.data.block import (Block, BlockAccessor, BlockMetadata,
                                      VALUE_COL)
from ray_tpu_torch.data._internal.plan import (AllToAllStage, ExecutionPlan,
                                               OneToOneStage, get_metadata)
from ray_tpu_torch.data._internal import shuffle as _shuffle


class Dataset:
    def __init__(self, plan: ExecutionPlan, epoch: int = 0):
        self._plan = plan
        self._epoch = epoch

    # ----------------------------------------------------------- transforms

    def _one2one(self, name: str, fn: Callable[[Block], Block],
                 **remote_opts) -> "Dataset":
        return Dataset(self._plan.with_stage(
            OneToOneStage(name, fn, remote_opts or None)), self._epoch)

    def map(self, fn: Callable[[Any], Any], **opts) -> "Dataset":
        def _do(block: Block) -> Block:
            acc = BlockAccessor.for_block(block)
            rows = [fn(r) for r in acc.to_pylist()]
            if rows and isinstance(rows[0], dict) and all(
                    np.isscalar(v) or isinstance(v, np.ndarray)
                    for v in rows[0].values()):
                return BlockAccessor.for_block(rows).to_numpy()
            return rows
        return self._one2one("map", _do, **opts)

    def map_batches(self, fn: Callable[[Any], Any], *,
                    batch_size: Optional[int] = None,
                    batch_format: str = "default",
                    compute=None, **opts) -> "Dataset":
        if compute is not None:
            from ray_tpu_torch.data._internal.compute import resolve_compute
            opts["_compute"] = resolve_compute(compute)

        def _do(block: Block) -> Block:
            acc = BlockAccessor.for_block(block)
            n = acc.num_rows()
            bs = batch_size or max(n, 1)
            outs = []
            for s in range(0, max(n, 1), bs):
                e = min(s + bs, n)
                sub = BlockAccessor.for_block(acc.slice(s, e))
                out = fn(sub.to_batch(batch_format))
                outs.append(BlockAccessor.batch_to_block(out))
            return BlockAccessor.concat(outs)
        return self._one2one("map_batches", _do, **opts)

    def flat_map(self, fn: Callable[[Any], Iterable[Any]], **opts
                 ) -> "Dataset":
        def _do(block: Block) -> Block:
            acc = BlockAccessor.for_block(block)
            out: List[Any] = []
            for r in acc.to_pylist():
                out.extend(fn(r))
            return out
        return self._one2one("flat_map", _do, **opts)

    def filter(self, fn: Callable[[Any], bool], **opts) -> "Dataset":
        def _do(block: Block) -> Block:
            acc = BlockAccessor.for_block(block)
            idx = [i for i, r in enumerate(acc.to_pylist()) if fn(r)]
            return acc.select(idx)
        return self._one2one("filter", _do, **opts)

    def add_column(self, name: str, fn: Callable[[Any], np.ndarray],
                   **opts) -> "Dataset":
        def _do(block: Block) -> Block:
            acc = BlockAccessor.for_block(block)
            cols = acc.to_numpy()
            cols[name] = np.asarray(fn(cols))
            return cols
        return self._one2one("add_column", _do, **opts)

    def drop_columns(self, cols: List[str], **opts) -> "Dataset":
        def _do(block: Block) -> Block:
            acc = BlockAccessor.for_block(block)
            out = acc.to_numpy()
            return {k: v for k, v in out.items() if k not in cols}
        return self._one2one("drop_columns", _do, **opts)

    def select_columns(self, cols: List[str], **opts) -> "Dataset":
        def _do(block: Block) -> Block:
            acc = BlockAccessor.for_block(block)
            out = acc.to_numpy()
            return {k: out[k] for k in cols}
        return self._one2one("select_columns", _do, **opts)

    # ----------------------------------------------------------- all-to-all

    def random_shuffle(self, *, seed: Optional[int] = None,
                       num_blocks: Optional[int] = None) -> "Dataset":
        extra: Dict[str, Any] = {}

        def _do(refs):
            n = num_blocks or max(len(refs), 1)
            return _shuffle.shuffle_blocks(refs, n, seed, stats=extra)
        return Dataset(self._plan.with_stage(
            AllToAllStage("random_shuffle", _do, extra=extra)),
            self._epoch)

    def sort(self, key=None, descending: bool = False) -> "Dataset":
        def _do(refs):
            return _shuffle.sort_blocks(refs, key, descending)
        return Dataset(self._plan.with_stage(
            AllToAllStage("sort", _do)), self._epoch)

    def repartition(self, num_blocks: int, *,
                    shuffle: bool = False) -> "Dataset":
        if shuffle:
            def _do(refs):
                return _shuffle.shuffle_blocks(refs, num_blocks, None)
        else:
            def _do(refs):
                counts = [m.num_rows for m in get_metadata(refs)]
                return _shuffle.repartition_blocks(refs, num_blocks, counts)
        return Dataset(self._plan.with_stage(
            AllToAllStage("repartition", _do)), self._epoch)

    def repartition_by_size(self, target_bytes: int) -> "Dataset":
        """Split oversized blocks so none exceeds ``target_bytes`` —
        the block-size-based splitting the reference applies dynamically
        in its map tasks (reference: _internal/plan -> block splitting
        on target_max_block_size).  Splits run remotely per block; no
        driver materialization."""
        if target_bytes <= 0:
            raise ValueError("target_bytes must be positive")

        def _do(refs):
            import ray_tpu_torch
            metas = get_metadata(refs)

            def _split(block, parts):
                acc = BlockAccessor.for_block(block)
                n = acc.num_rows()
                cuts = [round(i * n / parts) for i in range(parts + 1)]
                return [acc.slice(cuts[i], cuts[i + 1])
                        for i in range(parts)]

            split_task = ray_tpu_torch.remote(_split)  # ONE export for all blocks
            out = []
            for ref, m in zip(refs, metas):
                parts = -(-max(m.size_bytes, 1) // target_bytes)
                if parts <= 1 or m.num_rows <= 1:
                    out.append(ref)
                    continue
                parts = min(parts, m.num_rows)
                pieces = split_task.options(
                    num_returns=parts).remote(ref, parts)
                out.extend(pieces if isinstance(pieces, list)
                           else [pieces])
            return out

        return Dataset(self._plan.with_stage(
            AllToAllStage("repartition_by_size", _do)), self._epoch)

    def randomize_block_order(self, *, seed: Optional[int] = None
                              ) -> "Dataset":
        def _do(refs):
            import random as _r
            rng = _r.Random(seed)
            refs = list(refs)
            rng.shuffle(refs)
            return refs
        return Dataset(self._plan.with_stage(
            AllToAllStage("randomize_block_order", _do)), self._epoch)

    def limit(self, n: int) -> "Dataset":
        def _do(refs):
            counts = [m.num_rows for m in get_metadata(refs)]
            tasks = _shuffle._get_tasks()
            out, used = [], 0
            for ref, c in zip(refs, counts):
                if used >= n:
                    break
                take = min(c, n - used)
                out.append(ref if take == c else
                           tasks["slice_block"].remote(ref, 0, take))
                used += take
            return out
        return Dataset(self._plan.with_stage(
            AllToAllStage("limit", _do)), self._epoch)

    def union(self, *others: "Dataset") -> "Dataset":
        blocks = list(self._blocks())
        for o in others:
            blocks.extend(o._blocks())
        return Dataset(ExecutionPlan(blocks), self._epoch)

    def zip(self, other: "Dataset") -> "Dataset":
        """Zip columns of two datasets row-aligned (requires equal counts)."""
        import ray_tpu_torch
        left = self._blocks()
        right = other._blocks()
        lc = [m.num_rows for m in self._meta()]
        rc = [m.num_rows for m in other._meta()]
        if sum(lc) != sum(rc):
            raise ValueError("zip requires equal row counts")
        if lc != rc:
            right = _shuffle.repartition_blocks(right, len(lc), rc,
                                                targets=lc)

        def _zip(a, b):
            ca = BlockAccessor.for_block(a).to_numpy()
            cb = BlockAccessor.for_block(b).to_numpy()
            out = dict(ca)
            for k, v in cb.items():
                out[k if k not in out else k + "_1"] = v
            return out
        zt = ray_tpu_torch.remote(_zip)
        return Dataset(ExecutionPlan(
            [zt.remote(a, b) for a, b in zip(left, right)]), self._epoch)

    # ------------------------------------------------------------ splitting

    def split(self, n: int, *, equal: bool = True,
              locality_hints=None) -> List["Dataset"]:
        """Split into n datasets with equal row counts (reference:
        dataset.py split; used by Train to shard per worker)."""
        refs = self._blocks()
        counts = [m.num_rows for m in self._meta()]
        total = sum(counts)
        per = total // n if equal else None
        outs = []
        for i in range(n):
            lo = i * per if equal else (total * i) // n
            hi = (i + 1) * per if equal else (total * (i + 1)) // n
            outs.append((lo, hi))
        return self._split_ranges(refs, counts, outs)

    def split_at_indices(self, indices: List[int]) -> List["Dataset"]:
        refs = self._blocks()
        counts = [m.num_rows for m in self._meta()]
        total = sum(counts)
        bounds = [0] + list(indices) + [total]
        ranges = [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)]
        return self._split_ranges(refs, counts, ranges)

    def train_test_split(self, test_size: float, *,
                         shuffle: bool = False,
                         seed: Optional[int] = None):
        ds = self.random_shuffle(seed=seed) if shuffle else self
        total = ds.count()
        n_test = int(total * test_size) if isinstance(test_size, float) \
            else int(test_size)
        train, test = ds.split_at_indices([total - n_test])
        return train, test

    def streaming_split(self, n: int) -> List["Dataset"]:
        """Split into n shards WITHOUT materializing pending one-to-one
        stages: input blocks are partitioned round-robin and every shard
        carries the un-executed stage chain, so each consumer (e.g. a
        train worker) streams its own shard through the pipeline.  Shards
        are block-aligned, not row-equal — use ``split`` when exact row
        balance matters.  Falls back to ``split`` when the plan is
        already executed, has non-one-to-one stages, or has fewer input
        blocks than shards."""
        from ray_tpu_torch.data._internal.plan import OneToOneStage
        plan = self._plan
        if (plan.is_executed()
                or not all(isinstance(s, OneToOneStage)
                           for s in plan._stages)
                or len(plan._in_blocks) < n):
            return self.split(n)
        return [Dataset(ExecutionPlan(plan._in_blocks[i::n],
                                      list(plan._stages),
                                      stats=plan.stats.copy()),
                        self._epoch)
                for i in range(n)]

    def _split_ranges(self, refs, counts, ranges) -> List["Dataset"]:
        tasks = _shuffle._get_tasks()
        offsets = []
        off = 0
        for c in counts:
            offsets.append((off, off + c))
            off += c
        outs = []
        for lo, hi in ranges:
            pieces = []
            for (bs, be), ref in zip(offsets, refs):
                s, e = max(lo, bs), min(hi, be)
                if s < e:
                    pieces.append(ref if (s == bs and e == be) else
                                  tasks["slice_block"].remote(
                                      ref, s - bs, e - bs))
            outs.append(Dataset(ExecutionPlan(pieces), self._epoch))
        return outs

    # ---------------------------------------------------------- aggregates

    def count(self) -> int:
        return sum(m.num_rows for m in self._meta())

    def size_bytes(self) -> int:
        return sum(m.size_bytes for m in self._meta())

    def num_blocks(self) -> int:
        return len(self._blocks())

    def schema(self):
        refs = self._blocks()
        if not refs:
            return None
        return get_metadata(refs[:1])[0].schema

    def _agg(self, on: Optional[str], np_fn, combine):
        import ray_tpu_torch

        def _block_agg(block):
            acc = BlockAccessor.for_block(block)
            if acc.num_rows() == 0:
                return None
            cols = acc.to_numpy()
            col = cols[on] if on else cols[VALUE_COL]
            return np_fn(np.asarray(col))
        t = ray_tpu_torch.remote(_block_agg)
        vals = [v for v in ray_tpu_torch.get(
            [t.remote(b) for b in self._blocks()]) if v is not None]
        if not vals:
            return None
        return combine(vals)

    def sum(self, on: Optional[str] = None):
        return self._agg(on, np.sum, sum)

    def min(self, on: Optional[str] = None):
        return self._agg(on, np.min, min)

    def max(self, on: Optional[str] = None):
        return self._agg(on, np.max, max)

    def mean(self, on: Optional[str] = None):
        s = self._agg(on, np.sum, sum)
        c = self.count()
        return None if not c else s / c

    def std(self, on: Optional[str] = None, ddof: int = 1):
        import math
        c = self.count()
        if not c:
            return None
        s = self._agg(on, np.sum, sum)
        ss = self._agg(on, lambda a: np.sum(a.astype(np.float64) ** 2), sum)
        mean = s / c
        var = (ss - c * mean * mean) / max(c - ddof, 1)
        return math.sqrt(max(var, 0.0))

    def groupby(self, key):
        from ray_tpu_torch.data.grouped_data import GroupedData
        return GroupedData(self, key)

    # ----------------------------------------------------------- consuming

    def take(self, n: int = 20) -> List[Any]:
        out: List[Any] = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> List[Any]:
        import ray_tpu_torch
        out: List[Any] = []
        for b in ray_tpu_torch.get(self._blocks()):
            out.extend(BlockAccessor.for_block(b).to_pylist())
        return out

    def show(self, n: int = 20) -> None:
        for row in self.take(n):
            print(row)

    def iter_rows(self) -> Iterator[Any]:
        for block in self._iter_blocks():
            yield from BlockAccessor.for_block(block).to_pylist()

    def iter_batches(self, *, batch_size: int = 256,
                     batch_format: str = "default",
                     drop_last: bool = False,
                     pad_to_batch: bool = False,
                     local_shuffle_buffer_size: Optional[int] = None,
                     local_shuffle_seed: Optional[int] = None,
                     prefetch_blocks: int = 1) -> Iterator[Any]:
        """Iterate fixed-size batches. ``pad_to_batch`` repeats final rows so
        every batch has identical shape — keeps XLA from recompiling on the
        remainder batch (TPU-first; no reference analogue). ``pad_to_batch``
        wins over ``drop_last``: a padded remainder is always emitted.
        ``prefetch_blocks`` block pulls run ahead on a background thread so
        object-store fetches overlap consumption.

        Under the streaming executor (RTT_DATA_STREAMING, default on)
        pending stages execute as a pull-based pipeline: the first batch
        yields after the FIRST block's chain completes rather than the
        last, with a bounded in-flight budget behind it."""
        shuffler = _LocalShuffler(local_shuffle_buffer_size,
                                  local_shuffle_seed)
        carry: Optional[Block] = None
        for block in self._iter_blocks(prefetch_blocks):
            block = shuffler.feed(block)
            if block is None:
                continue
            if carry is not None:
                block = BlockAccessor.concat([carry, block])
                carry = None
            acc = BlockAccessor.for_block(block)
            n = acc.num_rows()
            s = 0
            while n - s >= batch_size:
                yield BlockAccessor.for_block(
                    acc.slice(s, s + batch_size)).to_batch(batch_format)
                s += batch_size
            if s < n:
                carry = acc.slice(s, n)
        tail = shuffler.drain()
        if tail is not None:
            carry = tail if carry is None else BlockAccessor.concat(
                [carry, tail])
        if carry is not None:
            acc = BlockAccessor.for_block(carry)
            n = acc.num_rows()
            s = 0
            while n - s >= batch_size:
                yield BlockAccessor.for_block(
                    acc.slice(s, s + batch_size)).to_batch(batch_format)
                s += batch_size
            rem = n - s
            if rem:
                last = acc.slice(s, n)
                if pad_to_batch:
                    la = BlockAccessor.for_block(last)
                    need = batch_size - rem
                    idx = (list(range(rem)) * (need // rem + 1))[:need]
                    last = BlockAccessor.concat([last, la.select(idx)])
                    yield BlockAccessor.for_block(last).to_batch(
                        batch_format)
                elif not drop_last:
                    yield BlockAccessor.for_block(last).to_batch(
                        batch_format)

    def iter_torch_batches(self, *, batch_size: int = 256,
                           dtypes=None, drop_last: bool = False,
                           local_shuffle_buffer_size: Optional[int] = None,
                           local_shuffle_seed: Optional[int] = None,
                           prefetch_blocks: int = 1) -> Iterator[Any]:
        """iter_batches with columns converted to torch tensors
        (reference: Dataset.iter_torch_batches). ``dtypes`` maps column
        name -> torch dtype (or one dtype for all)."""
        import torch

        def _to_torch(col, name):
            t = torch.as_tensor(np.ascontiguousarray(col))
            if dtypes is None:
                return t
            want = dtypes.get(name) if isinstance(dtypes, dict) else dtypes
            return t.to(want) if want is not None else t

        for batch in self.iter_batches(
                batch_size=batch_size, batch_format="numpy",
                drop_last=drop_last,
                local_shuffle_buffer_size=local_shuffle_buffer_size,
                local_shuffle_seed=local_shuffle_seed,
                prefetch_blocks=prefetch_blocks):
            if isinstance(batch, dict):
                yield {k: _to_torch(v, k) for k, v in batch.items()}
            else:
                yield _to_torch(batch, VALUE_COL)

    def iter_device_batches(self, *, batch_size: int = 256,
                            device="cuda", dtypes=None,
                            drop_last: bool = False,
                            pad_to_batch: bool = True, trainer=None,
                            **kw) -> Iterator[Any]:
        """Batches as torch tensors on ``device`` (a dict of them for
        dict batches), in ``iter_batches``' order, with a 1-deep
        prefetch: the copy of batch N+1 is issued before batch N is
        yielded, so it overlaps the consumer's step on batch N. Without
        CUDA, ``device="cuda"`` raises; pass ``device="cpu"``.

        On CUDA each host batch is written once into pinned memory
        (PyTorch's caching host allocator, which holds a block until the
        copies that read it are done) and copied to the card on a side
        stream; the consumer's current stream waits on that copy's
        event when the batch is yielded, and each tensor is recorded on
        the consumer's stream so its memory is not reused while the
        consumer's work is queued. No copy runs on the default stream.

        ``dtypes`` casts with numpy's ``astype`` before the copy, as the
        JAX package's does: per column (a dict; columns it does not name
        keep their dtype) or the whole batch. uint8 images stay bytes.
        ``trainer`` (an ``SpmdTrainer``, in the role of JAX's
        ``sharding=trainer.batch_shardings``): each batch is the global
        batch, and this rank gets its part, split and converted as
        ``train.spmd.put_batch`` does, on the trainer's device
        (``device`` is then not used)."""
        import torch

        from ray_tpu_torch.device import resolve_device

        dev = (torch.device(trainer.device) if trainer is not None
               else resolve_device(device))
        side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

        def _host(batch):
            if dtypes:
                if isinstance(batch, dict):
                    batch = {k: np.asarray(v).astype(dtypes.get(k, v.dtype))
                             for k, v in batch.items()}
                else:
                    batch = np.asarray(batch).astype(dtypes)
            if trainer is not None:
                from ray_tpu_torch.train.spmd import host_batch
                return host_batch(trainer, batch)
            if isinstance(batch, dict):
                return {k: _tensor(v) for k, v in batch.items()}
            return _tensor(batch)

        def _tensor(a):
            a = np.asarray(a)
            if side is None:
                return torch.tensor(a)
            t = torch.empty(a.shape, dtype=torch.from_numpy(
                np.empty(0, a.dtype)).dtype, pin_memory=True)
            t.numpy()[...] = a
            return t

        def _put(batch):
            host = _host(batch)
            if side is None:
                return host, None
            cols = host if isinstance(host, dict) else {None: host}
            with torch.cuda.stream(side):
                out = {k: (t if t.is_pinned() else t.pin_memory()).to(
                    dev, non_blocking=True) for k, t in cols.items()}
                ready = side.record_event()
            return (out if isinstance(host, dict) else out[None]), ready

        def _hand_over(staged):
            batch, ready = staged
            if ready is not None:
                consumer = torch.cuda.current_stream(dev)
                consumer.wait_event(ready)
                for t in (batch.values() if isinstance(batch, dict)
                          else (batch,)):
                    t.record_stream(consumer)
            return batch

        it = self.iter_batches(batch_size=batch_size, batch_format="numpy",
                               drop_last=drop_last,
                               pad_to_batch=pad_to_batch, **kw)
        prev = None
        for batch in it:
            cur = _put(batch)
            if prev is not None:
                yield _hand_over(prev)
            prev = cur
        if prev is not None:
            yield _hand_over(prev)

    def iter_tf_batches(self, *, batch_size: int = 256,
                        dtypes=None, drop_last: bool = False,
                        prefetch_blocks: int = 1, **kw) -> Iterator[Any]:
        """iter_batches with columns converted to tf tensors
        (reference: Dataset.iter_tf_batches)."""
        import tensorflow as tf

        def _to_tf(col, name):
            want = (dtypes.get(name) if isinstance(dtypes, dict)
                    else dtypes)
            return tf.convert_to_tensor(np.ascontiguousarray(col),
                                        dtype=want)

        for batch in self.iter_batches(
                batch_size=batch_size, batch_format="numpy",
                drop_last=drop_last, prefetch_blocks=prefetch_blocks,
                **kw):
            if isinstance(batch, dict):
                yield {k: _to_tf(v, k) for k, v in batch.items()}
            else:
                yield _to_tf(batch, VALUE_COL)

    def to_tf(self, *, feature_columns, label_columns=None,
              batch_size: int = 256,
              drop_last: bool = False) -> Any:
        """A ``tf.data.Dataset`` over this dataset's batches
        (reference: Dataset.to_tf — feature/label column split, batched).
        ``feature_columns``/``label_columns`` may be one name or a list;
        a list yields a dict of tensors per element."""
        import tensorflow as tf

        first = self.take(1)
        if not first:
            raise ValueError("to_tf on an empty dataset: the element "
                             "spec cannot be inferred from zero rows")
        one = first[0]

        def _spec(cols):
            if cols is None:
                return None

            def spec_for(name):
                v = np.asarray(one[name])
                return tf.TensorSpec(shape=(None,) + v.shape,
                                     dtype=tf.as_dtype(v.dtype))
            if isinstance(cols, str):
                return spec_for(cols)
            return {c: spec_for(c) for c in cols}

        feat_spec = _spec(feature_columns)
        label_spec = _spec(label_columns)

        def _select(batch, cols):
            if isinstance(cols, str):
                return tf.convert_to_tensor(batch[cols])
            return {c: tf.convert_to_tensor(batch[c]) for c in cols}

        def gen():
            for batch in self.iter_batches(batch_size=batch_size,
                                           batch_format="numpy",
                                           drop_last=drop_last):
                feats = _select(batch, feature_columns)
                if label_columns is None:
                    yield feats
                else:
                    yield feats, _select(batch, label_columns)

        sig = feat_spec if label_spec is None else (feat_spec, label_spec)
        return tf.data.Dataset.from_generator(gen, output_signature=sig)

    def to_pandas(self):
        import pandas as pd
        import ray_tpu_torch
        blocks = ray_tpu_torch.get(self._blocks())
        return pd.concat(
            [BlockAccessor.for_block(b).to_pandas() for b in blocks],
            ignore_index=True)

    def to_arrow(self):
        import ray_tpu_torch
        import pyarrow as pa
        blocks = ray_tpu_torch.get(self._blocks())
        return pa.concat_tables(
            [BlockAccessor.for_block(b).to_arrow() for b in blocks])

    def to_numpy(self) -> Dict[str, np.ndarray]:
        import ray_tpu_torch
        blocks = ray_tpu_torch.get(self._blocks())
        return BlockAccessor.for_block(
            BlockAccessor.concat(blocks)).to_numpy()

    # -------------------------------------------------------------- writing

    def write_parquet(self, path: str) -> None:
        self._write(path, "parquet")

    def write_csv(self, path: str) -> None:
        self._write(path, "csv")

    def write_json(self, path: str) -> None:
        self._write(path, "json")

    def write_numpy(self, path: str, column: str = VALUE_COL) -> None:
        import os
        import ray_tpu_torch
        os.makedirs(path, exist_ok=True)

        def _w(block, p, col):
            cols = BlockAccessor.for_block(block).to_numpy()
            np.save(p, cols[col])
            return p
        t = ray_tpu_torch.remote(_w)
        refs = [t.remote(b, os.path.join(path, f"{i:06}.npy"), column)
                for i, b in enumerate(self._blocks())]
        ray_tpu_torch.get(refs)

    def _write(self, path: str, fmt: str) -> None:
        import os
        import ray_tpu_torch
        os.makedirs(path, exist_ok=True)

        def _w(block, p, f):
            table = BlockAccessor.for_block(block).to_arrow()
            if f == "parquet":
                import pyarrow.parquet as pq
                pq.write_table(table, p)
            elif f == "csv":
                import pyarrow.csv as pcsv
                pcsv.write_csv(table, p)
            else:
                table.to_pandas().to_json(p, orient="records", lines=True)
            return p
        t = ray_tpu_torch.remote(_w)
        ext = {"parquet": "parquet", "csv": "csv", "json": "json"}[fmt]
        refs = [t.remote(b, os.path.join(path, f"{i:06}.{ext}"), fmt)
                for i, b in enumerate(self._blocks())]
        ray_tpu_torch.get(refs)

    # ------------------------------------------------------------ pipelines

    def repeat(self, times: Optional[int] = None):
        from ray_tpu_torch.data.dataset_pipeline import DatasetPipeline
        return DatasetPipeline.from_dataset_repeat(self, times)

    def window(self, *, blocks_per_window: int = 10):
        from ray_tpu_torch.data.dataset_pipeline import DatasetPipeline
        return DatasetPipeline.from_dataset_windows(self, blocks_per_window)

    # ------------------------------------------------------------- plumbing

    def materialize(self) -> "Dataset":
        self._blocks()
        return self

    fully_executed = materialize

    def stats(self) -> str:
        return self._plan.stats.summary_string()

    def _blocks(self) -> List[Any]:
        return self._plan.execute()

    def _iter_blocks(self, prefetch_blocks: int = 1) -> Iterator[Block]:
        """Yield block VALUES in order.  With the streaming executor
        enabled and pending stages, blocks are produced by the pull-based
        pipeline (O(depth) in-flight, first block available after one
        chain); otherwise the plan bulk-materializes and blocks are
        fetched with thread prefetch."""
        from ray_tpu_torch.data._internal.streaming_executor import (
            streaming_enabled)
        plan = self._plan
        if (streaming_enabled() and not plan.is_executed()
                and plan.supports_streaming()):
            import ray_tpu_torch
            for ref, _ in plan.execute_streaming():
                yield ray_tpu_torch.get(ref)
            return
        yield from _iter_blocks_prefetch(self._blocks(), prefetch_blocks)

    def _meta(self) -> List[BlockMetadata]:
        return self._plan.metadata()

    def __repr__(self) -> str:
        if self._plan.is_executed():
            return (f"Dataset(num_blocks={self.num_blocks()}, "
                    f"num_rows={self.count()}, schema={self.schema()})")
        return "Dataset(lazy)"


def _iter_blocks_prefetch(refs: List[Any], depth: int) -> Iterator[Block]:
    """Yield blocks with up to ``depth`` pulls running ahead on a background
    thread, so object-store fetch of block N+1 overlaps consumption of N.

    Generator close (an abandoned ``iter_batches`` iterator) must not leak
    the thread: the finally clause signals stop, drains the queue so a
    blocked ``put`` wakes, and joins the thread with a bounded timeout.
    The thread stays daemonized so a ``get`` stuck on a lost object can
    never pin process exit."""
    import ray_tpu_torch
    if depth <= 0 or len(refs) <= 1:
        for r in refs:
            yield ray_tpu_torch.get(r)
        return
    import queue as _q
    import threading
    q: "_q.Queue" = _q.Queue(maxsize=depth)
    sentinel = object()
    stop = threading.Event()
    err: List[BaseException] = []

    def _pull():
        try:
            for r in refs:
                if stop.is_set():
                    return
                b = ray_tpu_torch.get(r)
                while not stop.is_set():
                    try:
                        q.put(b, timeout=0.1)
                        break
                    except _q.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:
            err.append(e)
        finally:
            while not stop.is_set():
                try:
                    q.put(sentinel, timeout=0.1)
                    break
                except _q.Full:
                    continue

    t = threading.Thread(target=_pull, daemon=True,
                         name="rtt-data-prefetch")
    t.start()
    try:
        while True:
            b = q.get()
            if b is sentinel:
                break
            yield b
        if err:
            raise err[0]
    finally:
        stop.set()
        try:  # unblock a producer stuck in q.put
            while True:
                q.get_nowait()
        except _q.Empty:
            pass
        t.join(timeout=5.0)


class _LocalShuffler:
    """Buffered local shuffle for iter_batches (reference:
    local_shuffle_buffer_size semantics)."""

    def __init__(self, buffer_size: Optional[int], seed: Optional[int]):
        self.size = buffer_size
        self.rng = np.random.default_rng(seed)
        self.buf: List[Block] = []
        self.rows = 0

    def feed(self, block: Block) -> Optional[Block]:
        if not self.size:
            return block
        self.buf.append(block)
        self.rows += BlockAccessor.for_block(block).num_rows()
        if self.rows >= self.size * 2:
            return self._emit(self.size)
        return None

    def drain(self) -> Optional[Block]:
        if not self.size or not self.buf:
            return None
        return self._emit(0)

    def _emit(self, keep: int) -> Block:
        merged = BlockAccessor.concat(self.buf)
        acc = BlockAccessor.for_block(merged)
        n = acc.num_rows()
        perm = self.rng.permutation(n)
        out_n = n - keep
        out = acc.select(perm[:out_n].tolist())
        rest = acc.select(perm[out_n:].tolist())
        self.buf = [rest] if keep else []
        self.rows = keep
        return out
