"""custereomatching_tpu_torch — the PyTorch / CUDA port of custereomatching_tpu.

The serving slice of the stereo-matching engine on an NVIDIA Hopper card:
the banded ZNCC cost volume (kernel K1, ``csrc/zncc_banded.cu``), the
fused volume-free disparity pipeline (kernel K3,
``csrc/fused_pipeline.cu``), the disparity head, the batched matcher and
the bucketed serving engine.  Every kernel has a plain PyTorch version
beside it, which CPU tensors take.  The package imports torch and numpy,
never jax.
"""

from custereomatching_tpu_torch.config import StereoConfig, config_from_jax
from custereomatching_tpu_torch.models import (
    StereoEngine,
    StereoMatcher,
    StereoOutput,
)
from custereomatching_tpu_torch.ops import (
    DisparityResult,
    PipelineMaps,
    disparity_to_depth,
    extract_disparity,
    soft_argmax,
    stereo_matching,
)
from custereomatching_tpu_torch.utils import Timer, TimerError, benchmark
from custereomatching_tpu_torch.version import __version__

__all__ = [
    "DisparityResult",
    "PipelineMaps",
    "StereoConfig",
    "StereoEngine",
    "StereoMatcher",
    "StereoOutput",
    "Timer",
    "TimerError",
    "__version__",
    "benchmark",
    "config_from_jax",
    "disparity_to_depth",
    "extract_disparity",
    "soft_argmax",
    "stereo_matching",
]
