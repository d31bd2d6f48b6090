"""Model layer: the stereo matcher, the pyramid matcher, the serving
engine and camera optimisation."""

from custereomatching_tpu_torch.models.engine import (
    DEFAULT_BUCKETS,
    StereoEngine,
)
from custereomatching_tpu_torch.models.optimize import (
    StepMetrics,
    TrainState,
    adam,
    disparity_loss,
    init_state,
    make_train_step,
    optimize_camera,
    train_state_from_jax,
)
from custereomatching_tpu_torch.models.pyramid import PyramidStereoMatcher
from custereomatching_tpu_torch.models.stereo import (
    StereoMatcher,
    StereoOutput,
    entry,
)

__all__ = [
    "DEFAULT_BUCKETS",
    "PyramidStereoMatcher",
    "StereoEngine",
    "StereoMatcher",
    "StepMetrics",
    "StereoOutput",
    "TrainState",
    "adam",
    "disparity_loss",
    "entry",
    "init_state",
    "make_train_step",
    "optimize_camera",
    "train_state_from_jax",
]
