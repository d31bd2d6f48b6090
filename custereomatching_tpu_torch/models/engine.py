"""Serving engine: warm, shape-bucketed stereo inference (PyTorch port).

The counterpart of ``custereomatching_tpu/models/engine.py``.  Frames are
zero-padded up to the smallest fitting (H, W) bucket and the maps are
cropped back.  Padding is exact: the ZNCC windows read zeros outside the
image, so extra zero rows and columns change no output pixel of the
frame.  Without jit, "warm" means the kernels are built and every bucket
has run once.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from custereomatching_tpu_torch.config import StereoConfig, entry_device
from custereomatching_tpu_torch.models.stereo import StereoMatcher
from custereomatching_tpu_torch.ops.cuda_pipeline import PipelineMaps
from custereomatching_tpu_torch.utils.failsafe import (
    device_healthcheck,
    with_retries,
)
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
    raises ``RuntimeError`` unless built with ``device="cpu"``.
    ``lr_check`` serves :meth:`StereoMatcher.disparity_maps_lr` (two K3
    launches a frame on the card); ``retries`` re-runs a frame after a
    transient device fault (``utils.failsafe.with_retries``: the op is
    stateless, so the same inputs give the same maps); :meth:`healthy` is
    a readiness probe.  ``autotune`` gives each bucket K3's tile tuned for
    its shape (``ops.tuning.autotune_pipeline_blocks``: derived
    candidates, the winners cached on disk per card), on first use or in
    :meth:`warmup`, instead of the config's; the maps are the same at
    every tile.  Off the ``cuda`` backend there is no tile and
    ``autotune`` does nothing.
    """

    def __init__(self, config: StereoConfig,
                 buckets: Sequence[Tuple[int, int]] = DEFAULT_BUCKETS,
                 lr_check: bool = False, retries: int = 0,
                 autotune: bool = False,
                 device: Optional[torch.device] = None):
        if config.num_disparities is None:
            raise ValueError("serving engine requires banded mode")
        self.device = entry_device(device)
        # Raises on cuda + CPU.
        backend = config.resolved_backend(self.device)
        self.config = config
        self.model = StereoMatcher(config)
        self.buckets = sorted(tuple(b) for b in buckets)
        self.lr_check = lr_check
        self.retries = retries
        self.autotune = autotune and backend == "cuda"
        self._fn = self._model_fn(self.model)
        self._bucket_fns: Dict[Tuple[int, int], object] = {}
        # K3's tile of each bucket tuned so far (None: the default tile,
        # where no tile runs its own blocks).
        self.tuned_tiles: Dict[Tuple[int, int],
                               Optional[Tuple[int, int]]] = {}
        self.warm = set()

    def _model_fn(self, model: StereoMatcher):
        return self._wrap(model.disparity_maps_lr if self.lr_check
                          else model.disparity_maps)

    def _fn_for(self, bucket: Tuple[int, int]):
        """The pipeline for a bucket: with ``autotune``, a matcher at the
        tile tuned for the bucket's shape (tuned on first use)."""
        if not self.autotune:
            return self._fn
        fn = self._bucket_fns.get(bucket)
        if fn is None:
            from custereomatching_tpu_torch.ops import tuning

            c = self.config
            blocks = tuning.autotune_pipeline_blocks(
                bucket[0], bucket[1], c.num_disparities, c.kernel_size)
            fn = self._model_fn(StereoMatcher(
                dataclasses.replace(c, pipeline_blocks=blocks)))
            self._bucket_fns[bucket] = fn
            self.tuned_tiles[bucket] = blocks
        return fn

    def _wrap(self, fn):
        if self.retries:
            # The op is stateless, so re-running it after a transient
            # device fault is safe (same inputs, same outputs).
            return with_retries(fn, retries=self.retries)
        return fn

    def healthy(self) -> bool:
        """Readiness probe: a tiny computation on the engine's device, read
        back and checked (``utils.failsafe.device_healthcheck``)."""
        return device_healthcheck(self.device)

    def _bucket_for(self, H: int, W: int) -> Tuple[int, int]:
        for bh, bw in self.buckets:
            if H <= bh and W <= bw:
                return (bh, bw)
        raise ValueError(
            f"frame {H}x{W} exceeds every bucket {self.buckets}; "
            f"construct the engine with a larger bucket")

    @torch.no_grad()
    def warmup(self) -> None:
        """Build the kernels (with ``autotune``, tune every bucket) and run
        every bucket once."""
        for bh, bw in self.buckets:
            z = torch.zeros((1, bh, bw), dtype=torch.float32,
                            device=self.device)
            fence(self._fn_for((bh, bw))(z, z))
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
        maps = self._fn_for((bh, bw))(
            torch.from_numpy(np.pad(cam, pad)).to(self.device),
            torch.from_numpy(np.pad(proj, pad)).to(self.device))

        def crop(x):
            x = x[:, :H, :W].cpu().numpy()
            return x[0] if squeeze else x

        return PipelineMaps(*(crop(m) for m in maps))
