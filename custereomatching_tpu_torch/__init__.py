"""custereomatching_tpu_torch — the PyTorch / CUDA port of custereomatching_tpu.

The serving and training slices of the stereo-matching engine on an NVIDIA
Hopper card: the banded ZNCC cost volume (kernel K1,
``csrc/zncc_banded.cu``), its closed-form camera VJP (K2,
``csrc/zncc_banded_bwd.cu``) and projector VJP (K7,
``csrc/zncc_banded_proj_bwd.cu``), the all-pairs volume (K8,
``csrc/zncc_allpairs.cu``), the fused volume-free disparity pipeline
(K3, ``csrc/fused_pipeline.cu``), its trainable form (K3w, the same
kernel writing the cost volume, and K4, ``csrc/fused_pipeline_bwd.cu``),
the disparity heads, the batched matcher, the bucketed serving engine and
camera optimisation.  Every kernel has a plain PyTorch version beside it,
which CPU tensors take.  The package imports torch and numpy, never jax.
"""

from custereomatching_tpu_torch.config import StereoConfig, config_from_jax
from custereomatching_tpu_torch.models import (
    StereoEngine,
    StereoMatcher,
    StereoOutput,
    TrainState,
    make_train_step,
    optimize_camera,
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
    "TrainState",
    "__version__",
    "benchmark",
    "config_from_jax",
    "disparity_to_depth",
    "extract_disparity",
    "make_train_step",
    "optimize_camera",
    "soft_argmax",
    "stereo_matching",
]
