from .buckets import BucketSpec, ShapeContract
from .transforms import maybe_invert, to_grayscale

__all__ = ["BucketSpec", "ShapeContract", "maybe_invert", "to_grayscale"]
