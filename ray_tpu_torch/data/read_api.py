"""Dataset creation: range/from_*/read_* factories.

Reference analogue: python/ray/data/read_api.py (range/read_parquet/
read_csv/... over datasource/). File reads are one remote task per file;
in-memory sources are chunked into ``parallelism`` blocks and put into the
object store.
"""

from __future__ import annotations

import builtins
import glob as _glob
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ray_tpu_torch.data.block import VALUE_COL, BlockAccessor
from ray_tpu_torch.data.dataset import Dataset
from ray_tpu_torch.data._internal.plan import ExecutionPlan

DEFAULT_PARALLELISM = 8


def _put_blocks(blocks: List[Any]) -> Dataset:
    import ray_tpu_torch
    refs = [ray_tpu_torch.put(b) for b in blocks]
    return Dataset(ExecutionPlan(refs))


def _chunk(n: int, parallelism: int) -> List[tuple]:
    parallelism = max(1, min(parallelism, n) if n else 1)
    per = n // parallelism
    rem = n % parallelism
    out, start = [], 0
    for i in builtins.range(parallelism):
        size = per + (1 if i < rem else 0)
        out.append((start, start + size))
        start += size
    return out


def range(n: int, *, parallelism: int = DEFAULT_PARALLELISM) -> Dataset:
    blocks = [{VALUE_COL: np.arange(s, e, dtype=np.int64)}
              for s, e in _chunk(n, parallelism)]
    return _put_blocks(blocks)


def range_tensor(n: int, *, shape: tuple = (1,),
                 parallelism: int = DEFAULT_PARALLELISM) -> Dataset:
    blocks = []
    for s, e in _chunk(n, parallelism):
        base = np.arange(s, e, dtype=np.int64).reshape((-1,) + (1,) * len(shape))
        blocks.append({VALUE_COL: np.broadcast_to(
            base, (e - s,) + tuple(shape)).copy()})
    return _put_blocks(blocks)


def from_items(items: List[Any], *,
               parallelism: int = DEFAULT_PARALLELISM) -> Dataset:
    blocks = [list(items[s:e]) for s, e in _chunk(len(items), parallelism)]
    return _put_blocks(blocks)


def from_numpy(arr, *, parallelism: int = DEFAULT_PARALLELISM) -> Dataset:
    if isinstance(arr, dict):
        n = len(next(iter(arr.values())))
        blocks = [{k: np.asarray(v)[s:e] for k, v in arr.items()}
                  for s, e in _chunk(n, parallelism)]
    else:
        arr = np.asarray(arr)
        blocks = [{VALUE_COL: arr[s:e]}
                  for s, e in _chunk(len(arr), parallelism)]
    return _put_blocks(blocks)


def from_pandas(dfs) -> Dataset:
    import pyarrow as pa
    if not isinstance(dfs, list):
        dfs = [dfs]
    return _put_blocks([pa.Table.from_pandas(df) for df in dfs])


def from_arrow(tables) -> Dataset:
    if not isinstance(tables, list):
        tables = [tables]
    return _put_blocks(list(tables))


# ------------------------------------------------------------ file readers


def _expand_paths(paths, suffix: Optional[str] = None) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            pat = os.path.join(p, f"*{suffix}" if suffix else "*")
            out.extend(sorted(_glob.glob(pat)))
        elif any(c in p for c in "*?["):
            out.extend(sorted(_glob.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files matched {paths}")
    return out


def _read_files(paths, reader: Callable[[str], Any],
                parallelism: int) -> Dataset:
    """One task per file, coalesced to at most ``parallelism`` tasks when
    there are more files than that (a task then reads its group of files
    into one block). Splitting a single file across tasks is not supported."""
    import ray_tpu_torch

    def _read_group(group):
        blocks = [BlockAccessor.batch_to_block(reader(p)) for p in group]
        return blocks[0] if len(blocks) == 1 else BlockAccessor.concat(blocks)

    if len(paths) > parallelism > 0:
        groups = [paths[s:e] for s, e in _chunk(len(paths), parallelism)]
    else:
        groups = [[p] for p in paths]
    t = ray_tpu_torch.remote(_read_group)
    return Dataset(ExecutionPlan([t.remote(g) for g in groups]))


def read_parquet(paths, *, parallelism: int = DEFAULT_PARALLELISM,
                 columns: Optional[List[str]] = None) -> Dataset:
    files = _expand_paths(paths, ".parquet")

    def _r(path):
        import pyarrow.parquet as pq
        return pq.read_table(path, columns=columns)
    return _read_files(files, _r, parallelism)


def read_csv(paths, *, parallelism: int = DEFAULT_PARALLELISM) -> Dataset:
    files = _expand_paths(paths, ".csv")

    def _r(path):
        import pyarrow.csv as pcsv
        return pcsv.read_csv(path)
    return _read_files(files, _r, parallelism)


def read_json(paths, *, parallelism: int = DEFAULT_PARALLELISM) -> Dataset:
    files = _expand_paths(paths, ".json")

    def _r(path):
        import pyarrow.json as pjson
        return pjson.read_json(path)
    return _read_files(files, _r, parallelism)


def read_numpy(paths, *, parallelism: int = DEFAULT_PARALLELISM) -> Dataset:
    files = _expand_paths(paths, ".npy")

    def _r(path):
        return {VALUE_COL: np.load(path)}
    return _read_files(files, _r, parallelism)


def read_images(paths, *, parallelism: int = DEFAULT_PARALLELISM,
                size: Optional[tuple] = None,
                mode: str = "RGB",
                include_paths: bool = False) -> Dataset:
    """Decode image files into an ``image`` column of HxWxC uint8
    arrays (reference: data/read_api.py read_images over
    ImageDatasource). ``size=(h, w)`` resizes on read — decode-time
    resize keeps the block memory bounded and the downstream arrays
    static-shaped (what a TPU input pipeline wants)."""
    exts = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp")
    files = [f for f in _expand_paths(paths)
             if f.lower().endswith(exts)]
    if not files:
        raise ValueError(
            f"read_images: no files with extensions {exts} under "
            f"{paths!r}")

    def _r(path):
        from PIL import Image
        with Image.open(path) as im:
            im = im.convert(mode)
            if size is not None:
                im = im.resize((size[1], size[0]))
            arr = np.asarray(im, dtype=np.uint8)
        if arr.ndim == 2:  # grayscale modes keep the HxWxC contract
            arr = arr[:, :, None]
        row = {"image": arr}
        if include_paths:
            row["path"] = path
        return [row]
    return _read_files(files, _r, parallelism)


def read_mongo(uri: str, database: str, collection: str, *,
               parallelism: int = DEFAULT_PARALLELISM,
               pipeline: Optional[List[dict]] = None) -> Dataset:
    """Read a MongoDB collection (reference: read_api.py read_mongo over
    MongoDatasource). Gated on pymongo, which does not ship in this
    image — exactly like the reference gates on its connectors.

    The documents are materialized on the driver before blocking (the
    reference's MongoDatasource partitions by _id range into remote
    read tasks); acceptable for the modest collections this connector
    targets — use the file readers for bulk data."""
    try:
        import pymongo
    except ImportError as e:
        raise RuntimeError(
            "read_mongo requires pymongo (not installed)") from e
    client = pymongo.MongoClient(uri)
    try:
        coll = client[database][collection]
        docs = list(coll.aggregate(pipeline) if pipeline
                    else coll.find())
    finally:
        client.close()
    for d in docs:
        d.pop("_id", None)
    return from_items(docs, parallelism=parallelism)


def read_text(paths, *, parallelism: int = DEFAULT_PARALLELISM) -> Dataset:
    files = _expand_paths(paths)

    def _r(path):
        with open(path) as f:
            return [line.rstrip("\n") for line in f]
    return _read_files(files, _r, parallelism)


def read_binary_files(paths, *,
                      parallelism: int = DEFAULT_PARALLELISM) -> Dataset:
    files = _expand_paths(paths)

    def _r(path):
        with open(path, "rb") as f:
            return [{"path": path, "bytes": f.read()}]
    return _read_files(files, _r, parallelism)


class Datasource:
    """Custom source ABC (reference: data/datasource/datasource.py).
    Implement ``get_read_tasks(parallelism) -> list of zero-arg callables``,
    each returning one block."""

    def get_read_tasks(self, parallelism: int) -> List[Callable[[], Any]]:
        raise NotImplementedError


def read_datasource(source: Datasource, *,
                    parallelism: int = DEFAULT_PARALLELISM) -> Dataset:
    import ray_tpu_torch

    def _run(fn):
        return BlockAccessor.batch_to_block(fn())
    t = ray_tpu_torch.remote(_run)
    tasks = source.get_read_tasks(parallelism)
    return Dataset(ExecutionPlan([t.remote(fn) for fn in tasks]))
