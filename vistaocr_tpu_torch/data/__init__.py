from .buckets import BucketSpec, ShapeContract, make_ladder
from .pipeline import Batch, BatchPipeline
from .shards import (ConcatLineDataset, ShardedLineDataset, ShardWriter,
                     open_dataset, write_manifest)
from .transforms import maybe_invert, to_grayscale

__all__ = ["Batch", "BatchPipeline", "BucketSpec", "ConcatLineDataset",
           "ShapeContract", "ShardWriter", "ShardedLineDataset",
           "make_ladder", "maybe_invert", "open_dataset", "to_grayscale",
           "write_manifest"]
