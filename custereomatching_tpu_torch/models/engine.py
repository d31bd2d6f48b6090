"""Serving engine: warm, shape-bucketed stereo inference (PyTorch port).

The counterpart of ``custereomatching_tpu/models/engine.py``.  Frames are
zero-padded up to the smallest fitting (H, W) bucket and the maps are
cropped back.  Padding is exact: the ZNCC windows read zeros outside the
image, so extra zero rows and columns change no output pixel of the
frame.  Without jit, "warm" means the kernels are built and every bucket
has run once.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from custereomatching_tpu_torch.config import StereoConfig, entry_device
from custereomatching_tpu_torch.models.stereo import StereoMatcher
from custereomatching_tpu_torch.ops.cuda_pipeline import PipelineMaps
from custereomatching_tpu_torch.utils.timer import fence

# Default buckets: a small tile, VGA-scale and KITTI-scale.
DEFAULT_BUCKETS: Tuple[Tuple[int, int], ...] = (
    (128, 256), (384, 640), (384, 1280))


class StereoEngine:
    """Warm inference engine over a fixed set of (H, W) buckets.

    Example::

        engine = StereoEngine(StereoConfig(kernel_size=15,
                                           num_disparities=192),
                              device="cuda")
        engine.warmup()                          # build + run each bucket
        maps = engine.infer(camera, projector)   # numpy in, numpy out

    ``device`` defaults to the CUDA card; without a card the engine
    raises ``RuntimeError`` unless built with ``device="cpu"``.  ``lr_check``,
    ``retries`` and ``autotune`` are not ported yet (ROADMAP items 11 and
    12) and raise ``NotImplementedError`` when set.
    """

    def __init__(self, config: StereoConfig,
                 buckets: Sequence[Tuple[int, int]] = DEFAULT_BUCKETS,
                 lr_check: bool = False, retries: int = 0,
                 autotune: bool = False,
                 device: Optional[torch.device] = None):
        if config.num_disparities is None:
            raise ValueError("serving engine requires banded mode")
        if lr_check:
            raise NotImplementedError(
                "lr_check: the left-right check is ROADMAP item 11")
        if retries:
            raise NotImplementedError(
                "retries: the failsafe layer is ROADMAP item 12")
        if autotune:
            raise NotImplementedError(
                "autotune: tile autotuning is ROADMAP item 12")
        self.device = entry_device(device)
        config.resolved_backend(self.device)  # raises on cuda + CPU
        self.config = config
        self.model = StereoMatcher(config)
        self.buckets = sorted(tuple(b) for b in buckets)
        self.warm = set()

    def _bucket_for(self, H: int, W: int) -> Tuple[int, int]:
        for bh, bw in self.buckets:
            if H <= bh and W <= bw:
                return (bh, bw)
        raise ValueError(
            f"frame {H}x{W} exceeds every bucket {self.buckets}; "
            f"construct the engine with a larger bucket")

    @torch.no_grad()
    def warmup(self) -> None:
        """Build the kernels and run every bucket once."""
        for bh, bw in self.buckets:
            z = torch.zeros((1, bh, bw), dtype=torch.float32,
                            device=self.device)
            fence(self.model.disparity_maps(z, z))
            self.warm.add((bh, bw))

    @torch.no_grad()
    def infer(self, camera: np.ndarray,
              projector: np.ndarray) -> PipelineMaps:
        """Run one stereo pair (or a batch) through the pipeline.

        Accepts ``[H, W]`` or ``[B, H, W]`` arrays of any size fitting a
        bucket; returns numpy maps cropped to the input size.
        """
        cam = np.asarray(camera, np.float32)
        proj = np.asarray(projector, np.float32)
        if cam.shape != proj.shape:
            raise ValueError(f"shape mismatch {cam.shape} vs {proj.shape}")
        squeeze = cam.ndim == 2
        if squeeze:
            cam, proj = cam[None], proj[None]
        B, H, W = cam.shape
        bh, bw = self._bucket_for(H, W)
        pad = ((0, 0), (0, bh - H), (0, bw - W))
        maps = self.model.disparity_maps(
            torch.from_numpy(np.pad(cam, pad)).to(self.device),
            torch.from_numpy(np.pad(proj, pad)).to(self.device))

        def crop(x):
            x = x[:, :H, :W].cpu().numpy()
            return x[0] if squeeze else x

        return PipelineMaps(*(crop(m) for m in maps))
