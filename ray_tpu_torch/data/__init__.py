from ray_tpu_torch.data.block import Block, BlockAccessor
from ray_tpu_torch.data.dataset import DataIterator, Dataset
from ray_tpu_torch.data.read_api import (
    from_arrow,
    from_items,
    from_numpy,
    from_pandas,
    range,  # noqa: A004
    range_tensor,
    read_binary_files,
    read_csv,
    read_images,
    read_json,
    read_numpy,
    read_parquet,
    read_text,
    read_tfrecords,
    read_webdataset,
)

__all__ = [
    "Block",
    "BlockAccessor",
    "DataIterator",
    "Dataset",
    "from_arrow",
    "from_items",
    "from_numpy",
    "from_pandas",
    "range",
    "range_tensor",
    "read_binary_files",
    "read_csv",
    "read_images",
    "read_json",
    "read_numpy",
    "read_parquet",
    "read_text",
    "read_tfrecords",
    "read_webdataset",
]
