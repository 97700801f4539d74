"""Data layer of the port: Delta-log access, sharded Parquet streaming with a
host decode pool, and a feeder thread that stages batches on the device.
Port of ``dss_ml_at_scale_tpu/data/`` cut to the training slice."""

from .delta import DeltaTable, write_delta
from .prefetch import Feeder
from .reader import ParquetShardReader, batch_loader, make_batch_reader
from .sharding import RowGroupUnit, list_row_groups, shard_units
from .transform import TransformSpec, imagenet_transform_spec

__all__ = [
    "DeltaTable",
    "Feeder",
    "ParquetShardReader",
    "RowGroupUnit",
    "TransformSpec",
    "batch_loader",
    "imagenet_transform_spec",
    "list_row_groups",
    "make_batch_reader",
    "shard_units",
    "write_delta",
]
