"""ray_tpu_torch.data — distributed datasets over the object store.

Reference analogue: python/ray/data (Dataset over blocks, read API,
transforms, shuffle, split, batch iteration). The port's copy of
``ray_tpu/data``: tensor-dict blocks, static-shape batch padding, and
``Dataset.iter_device_batches``, which prefetches torch tensors to the
card through pinned memory on a side CUDA stream.

Iteration runs on the streaming executor by default (RTT_DATA_STREAMING,
see _internal/streaming_executor.py): pending stages execute as a
pull-based pipeline with object-store backpressure, so the first batch
yields after the first block chain completes and the in-flight footprint
stays bounded.  ``materialize()`` and the all-to-all barriers keep the
bulk path; RTT_DATA_STREAMING=0 falls back to it wholesale.
"""

from ray_tpu_torch.data.block import Block, BlockAccessor, BlockMetadata
from ray_tpu_torch.data._internal.compute import (ActorPoolStrategy,
                                                  TaskPoolStrategy)
from ray_tpu_torch.data._internal.streaming_executor import (StreamingConfig,
                                                             streaming_enabled)
from ray_tpu_torch.data.dataset import Dataset
from ray_tpu_torch.data.dataset_pipeline import DatasetPipeline
from ray_tpu_torch.data.grouped_data import GroupedData
from ray_tpu_torch.data.read_api import (Datasource, from_arrow, from_items,
                                         from_numpy, from_pandas, range,
                                         range_tensor, read_binary_files, read_csv,
                                         read_datasource, read_images, read_json,
                                         read_mongo, read_numpy, read_parquet,
                                         read_text)

__all__ = [
    "Dataset", "DatasetPipeline", "GroupedData", "Block", "BlockAccessor",
    "BlockMetadata", "Datasource", "range", "range_tensor", "from_items",
    "from_numpy", "from_pandas", "from_arrow", "read_parquet", "read_csv",
    "read_json", "read_numpy", "read_text", "read_binary_files",
    "read_images", "read_mongo",
    "read_datasource", "ActorPoolStrategy", "TaskPoolStrategy",
    "StreamingConfig", "streaming_enabled",
]
