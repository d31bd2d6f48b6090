"""Configuration of the stereo-matching engine (PyTorch port).

Field for field the counterpart of ``custereomatching_tpu/config.py``:
the same names, defaults and validation, so one configuration can drive
both packages (:func:`config_from_jax`).  The system has no weights; the
config is its whole state.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

BACKENDS = ("auto", "torch", "cuda")
# The kernels' default tile: 16 rows (of 64 columns) and planes a round 0,
# the kernel's own choice (csrc/common.cuh kTileH, fused_round).
DEFAULT_TILE = (16, 0)

# JAX backend name -> port backend name.
_JAX_BACKENDS = {
    "auto": "auto",
    "xla": "torch",
    "pallas_interpret": "torch",
    "pallas": "cuda",
}


@dataclasses.dataclass(frozen=True)
class StereoConfig:
    """Static configuration of the ZNCC stereo-matching op and pipeline.

    Attributes:
      kernel_size: side of the square correlation window (odd k >= 1).
      num_disparities: ``D``; the banded ``[H, W, D+1]`` volume, band d
        matching projector column ``w - d``.  ``None`` (the default, the
        reference's own op) selects the all-pairs ``[H, W, W]`` volume,
        the last axis the absolute projector column (kernel K8 on the
        ``cuda`` backend).  The fused pipelines are banded only.
      softargmax_beta: temperature of the soft-argmax head.
      cost_threshold: confidence threshold on the per-pixel max correlation.
      epsilon: added to the numerator and inside the square root of the
        denominator: ``cost = (exy + eps) / sqrt(ex2 * ey2 + eps)``.
      grad_projector: make the volume differentiable in the projector too.
        Banded on ``cuda``: K1 forward, K2 and K7 backward; otherwise
        autograd of the plain moments form.  The fused trainable pipeline
        is camera-only, so training then takes the volume path.
      precision: "highest" or "default", the JAX package's matrix-product
        knob ("default" lets the TPU take bf16 passes).  The port sums in
        exact fp32 for both: the banded path has no matrix product, and
        K8 runs fp32 FMAs on the CUDA cores (a TF32 variant is later
        work).
      backend: "cuda" runs the hand-written Hopper kernels and needs CUDA
        tensors; "torch" runs the plain PyTorch versions; "auto" picks
        "cuda" for CUDA tensors and "torch" otherwise.
      pipeline_blocks: ``(block_rows, block_disparities)``, on the
        ``cuda`` backend the tile of K3, K3w and K3m: tile rows (8, 16 or
        32, of 1024 / rows columns) and planes a round
        (:meth:`pipeline_tile`; ``None``: 16 rows and the kernel's own
        planes).  ``ops.tuning.autotune_pipeline_blocks`` finds the best
        for a shape.
      trainable_bwd_block_rows: on the ``cuda`` backend K4's tile rows
        (:meth:`bwd_tile_rows`; ``None``: 16); ``ops.tuning.
        autotune_trainable_bwd_blocks`` finds the best.  K5 has no tile.
        Both fields are validated as in the JAX package, so a JAX config
        carries over unchanged; a tile the card cannot run at the call's
        shape raises ``ValueError`` there, naming the tiles that run
        (``ops.tuning.candidate_blocks``), and is never changed for
        another.  The ``torch`` backend ignores them: its values are the
        same for every tile, as the kernels' are.  K1's tile is an
        argument of ``ops.cuda_zncc.cost_volume_banded_cuda``, as JAX's
        ``pallas_cost_volume_banded_hdw`` takes its blocks.
    """

    kernel_size: int = 15
    num_disparities: Optional[int] = None
    softargmax_beta: float = 50.0
    cost_threshold: float = 0.6
    epsilon: float = 1e-8
    grad_projector: bool = False
    precision: str = "highest"
    backend: str = "auto"
    pipeline_blocks: Optional[Tuple[int, int]] = None
    trainable_bwd_block_rows: Optional[int] = None

    def __post_init__(self):
        if self.kernel_size < 1 or self.kernel_size % 2 != 1:
            raise ValueError(
                f"kernel_size must be odd and >= 1, got {self.kernel_size}")
        if self.num_disparities is not None and self.num_disparities < 0:
            raise ValueError(
                f"num_disparities must be None or >= 0, got "
                f"{self.num_disparities}")
        if self.precision not in ("highest", "default"):
            raise ValueError(f"unknown precision {self.precision!r}")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.pipeline_blocks is not None:
            pb = tuple(self.pipeline_blocks)
            if (len(pb) != 2 or not all(isinstance(v, int) and v > 0
                                        for v in pb)):
                raise ValueError(
                    f"pipeline_blocks must be two positive ints, got "
                    f"{self.pipeline_blocks!r}")
            object.__setattr__(self, "pipeline_blocks", pb)
        bb = self.trainable_bwd_block_rows
        if bb is not None and (not isinstance(bb, int) or bb <= 0):
            raise ValueError(
                f"trainable_bwd_block_rows must be None or a positive "
                f"int, got {bb!r}")

    def pipeline_tile(self) -> Tuple[int, int]:
        """K3's (K3w's, K3m's) tile on the card, ``(tile_rows, planes)``:
        ``pipeline_blocks``, or the default 16 rows and planes 0 (the
        kernel's own choice)."""
        return (tuple(self.pipeline_blocks) if self.pipeline_blocks
                else DEFAULT_TILE)

    def bwd_tile_rows(self) -> int:
        """K4's tile rows on the card: ``trainable_bwd_block_rows``, or the
        default 16."""
        return self.trainable_bwd_block_rows or DEFAULT_TILE[0]

    def resolved_backend(self, device: torch.device) -> str:
        """The concrete backend for tensors on ``device``.

        Raises ``ValueError`` for ``backend="cuda"`` with a non-CUDA
        device: nothing falls back to the plain version."""
        device = torch.device(device)
        if self.backend == "auto":
            return "cuda" if device.type == "cuda" else "torch"
        if self.backend == "cuda" and device.type != "cuda":
            raise ValueError(
                f"backend='cuda' needs CUDA tensors, got device {device}")
        return self.backend

    @property
    def pad(self) -> int:
        """Half-window (halo) size: rows/cols of context a window needs."""
        return self.kernel_size // 2

    def volume_shape(self, H: int, W: int) -> Tuple[int, int, int]:
        """Shape of the cost volume this config produces for an HxW pair."""
        if self.num_disparities is None:
            return (H, W, W)
        return (H, W, self.num_disparities + 1)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for the sharded pipeline: frames shard over
    ``data``; image rows shard over ``space`` with a halo exchange of
    ``kernel_size//2`` rows (``parallel/``).  One rank a device."""

    data: int = 1
    space: int = 1
    axis_names: Tuple[str, str] = ("data", "space")

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.data, self.space)

    @property
    def num_devices(self) -> int:
        return self.data * self.space


def entry_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when the caller names
    one, else the CUDA card.  Raises ``RuntimeError`` when that is CUDA and
    no card is present: nothing carries on on the CPU unless asked."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" (--device cpu "
            "in the examples) to run on the CPU with the plain versions")
    return device


def config_from_jax(jax_cfg_fields: dict):
    """A port config from ``dataclasses.asdict`` of a JAX ``StereoConfig``
    or ``MeshConfig``.

    The fields of a ``MeshConfig`` (``data``, ``space``, ``axis_names``)
    give a :class:`MeshConfig` as they are.  For a ``StereoConfig`` the
    backend maps ``xla`` and ``pallas_interpret`` to ``torch`` and
    ``pallas`` to ``cuda``; every other field carries over as it is.
    """
    fields = dict(jax_cfg_fields)
    mesh_fields = {f.name for f in dataclasses.fields(MeshConfig)}
    if fields and set(fields) <= mesh_fields:
        fields["axis_names"] = tuple(fields.get("axis_names",
                                                ("data", "space")))
        return MeshConfig(**fields)
    backend = fields.get("backend", "auto")
    if backend not in _JAX_BACKENDS:
        raise ValueError(f"unknown JAX backend {backend!r}")
    fields["backend"] = _JAX_BACKENDS[backend]
    return StereoConfig(**fields)
