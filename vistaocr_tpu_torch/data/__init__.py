from .buckets import BucketSpec, ShapeContract, make_ladder
from .pipeline import Batch, BatchPipeline
from .shards import (ConcatLineDataset, ShardedLineDataset, ShardWriter,
                     open_dataset, write_manifest)
from .transforms import (height_normalize, maybe_invert, normalize_line,
                         to_grayscale)

__all__ = ["Batch", "BatchPipeline", "BucketSpec", "ConcatLineDataset",
           "ShapeContract", "ShardWriter", "ShardedLineDataset",
           "height_normalize", "make_ladder", "maybe_invert",
           "normalize_line", "open_dataset", "to_grayscale",
           "write_manifest"]
