"""Model layer: the stereo matcher and the serving engine."""

from custereomatching_tpu_torch.models.engine import (
    DEFAULT_BUCKETS,
    StereoEngine,
)
from custereomatching_tpu_torch.models.stereo import (
    StereoMatcher,
    StereoOutput,
    entry,
)

__all__ = [
    "DEFAULT_BUCKETS",
    "StereoEngine",
    "StereoMatcher",
    "StereoOutput",
    "entry",
]
