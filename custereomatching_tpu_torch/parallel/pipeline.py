"""Pipeline parallelism: stream frames through disparity-range stages.

The counterpart of ``custereomatching_tpu/parallel/pipeline.py``:

* The work is split along the **disparity axis**: stage ``s`` of ``S``
  (one rank each) owns planes ``[s·(D+1)/S, (s+1)·(D+1)/S)``.  Every stage
  runs the same op, so the load is balanced by construction.
* What flows between stages is a frame's online-softmax **head state**,
  four ``[H, W]`` maps ``(m, am, s, t)``, sent with ``isend``/``irecv``.
  The merge is the associative logsumexp combine the fused kernel runs
  inside, so a frame that has visited every stage carries the full-range
  result: soft argmax ``t/s``, confidence ``m/β`` and the first-max hard
  argmax (ties go to the lower disparity).
* Schedule: GPipe.  At tick ``i`` stage ``s`` works on frame ``i − s``;
  a ``T``-frame stream takes ``T + S − 1`` ticks of 1/S-range work.

A stage's chunk is the fused volume-free forward (K3m on the card, its
plain version on CPU tensors) against a right-shifted projector:
correlating ``camera`` with ``shift_right(projector, off)`` over ``Dc``
bands enumerates global disparities ``off .. off + Dc`` (the zero fill is
the out-of-view convention).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from custereomatching_tpu_torch.config import StereoConfig
from custereomatching_tpu_torch.ops.cuda_pipeline import (
    PipelineMaps,
    fused_pipeline_train_cuda,
    fused_pipeline_train_reference,
    unnormalized_head,
)
from custereomatching_tpu_torch.parallel.multihost import world_size


class HeadState(NamedTuple):
    """Partial online-softmax disparity-head state (all ``[H, W]``).

    ``m``: running max of ``β·cost``; ``am``: its (global) disparity;
    ``s``/``t``: softmax sum and first moment relative to ``e^m``.
    """

    m: torch.Tensor
    am: torch.Tensor
    s: torch.Tensor
    t: torch.Tensor


def empty_state(shape, dtype=torch.float32, device=None) -> HeadState:
    return HeadState(m=torch.full(shape, -3.0e38, dtype=dtype, device=device),
                     am=torch.zeros(shape, dtype=dtype, device=device),
                     s=torch.zeros(shape, dtype=dtype, device=device),
                     t=torch.zeros(shape, dtype=dtype, device=device))


def shift_right(img: torch.Tensor, off: int) -> torch.Tensor:
    """``out[..., x] = img[..., x - off]`` with zero fill (``off >= 0``)."""
    if off == 0:
        return img
    if off >= img.shape[-1]:             # every column reads the fill
        return torch.zeros_like(img)
    return F.pad(img[..., :img.shape[-1] - off], (off, 0))


def chunk_state(camera: torch.Tensor, projector: torch.Tensor,
                d_offset: int, chunk: int, config: StereoConfig
                ) -> HeadState:
    """Head state of disparity planes ``d_offset .. d_offset + chunk - 1``
    of one ``[H, W]`` pair.

    One launch of the fused forward without the volume (K3m,
    ``fused_pipeline_train_cuda(..., save_volume=False)`` at the config's
    ``pipeline_blocks`` tile, on the ``cuda`` backend; its plain version
    otherwise) over ``chunk - 1`` bands, on the camera and the
    right-shifted projector, both padded by the largest stage offset
    ``(D + 1) − chunk`` so right-edge windows still read the projector's
    last columns.  Its raw ``(am, conf, s, t)``
    are the state: ``m = β·conf``; under the unnormalized head ``s`` and
    ``t`` are absolute sums and are rescaled by ``e^{−m}``; then they are
    lifted to global disparities (``am + off``, ``t + off·s``).
    """
    H, W = camera.shape
    c = config
    pad_r = (c.num_disparities + 1) - chunk
    cam_p = F.pad(camera, (0, pad_r))[None]
    proj_sh = shift_right(F.pad(projector, (0, pad_r)), d_offset)[None]
    cuda = c.resolved_backend(camera.device) == "cuda"
    beta = c.softargmax_beta
    args = (cam_p, proj_sh, chunk - 1, c.kernel_size, c.epsilon, beta,
            c.cost_threshold, False)
    if cuda:
        _, res = fused_pipeline_train_cuda(*args, *c.pipeline_tile())
    else:
        _, res = fused_pipeline_train_reference(*args)
    am, conf, s, t = (x[0, :, :W] for x in (res.am, res.confidence, res.s,
                                              res.t))
    m = beta * conf
    if unnormalized_head(beta, chunk - 1):
        scale = torch.exp(-m)
        s = s * scale
        t = t * scale
    return HeadState(m=m, am=am + d_offset, s=s, t=t + d_offset * s)


def merge_states(low: HeadState, high: HeadState) -> HeadState:
    """Merge two partial states; ``low`` covers the LOWER disparities.

    Associative logsumexp combine; ties in the max resolve to ``low``
    (first-max semantics of the argmax).
    """
    m = torch.maximum(low.m, high.m)
    el = torch.exp(low.m - m)
    eh = torch.exp(high.m - m)
    take_low = low.m >= high.m
    return HeadState(m=m, am=torch.where(take_low, low.am, high.am),
                     s=low.s * el + high.s * eh,
                     t=low.t * el + high.t * eh)


def finalize_state(state: HeadState, config: StereoConfig) -> PipelineMaps:
    conf = state.m / config.softargmax_beta
    mask = (conf > config.cost_threshold).to(conf.dtype)
    soft = torch.where(state.s > 0, state.t / state.s,
                       torch.zeros_like(state.s)) * mask
    return PipelineMaps(disparity=state.am * mask, soft_disparity=soft,
                        mask=mask, confidence=conf)


def _stage_chunks(num_disparities: int, num_stages: int) -> int:
    """Planes per stage."""
    return -(-(num_disparities + 1) // num_stages)


def _require_lazy_nccl(group) -> None:
    """The stage hand-off's sends need a lazily initialised NCCL group (one
    made without ``device_id``, as :func:`..multihost.initialize_multihost`
    makes it), where each pair of stages gets a communicator of its own.
    On a group bound to its card the sends share the group's communicator
    with its collectives, and the pipeline hung on four H100s, with batched
    sends as well as unbatched: raise rather than hang."""
    if (dist.get_backend(group) == "nccl"
            and getattr(group, "bound_device_id", None) is not None):
        raise RuntimeError(
            "pipelined_video_maps needs a lazily initialised NCCL process "
            "group: initialise it without device_id (initialize_multihost "
            "does)")


def pipelined_video_maps(cameras: torch.Tensor, projectors: torch.Tensor,
                         config: StereoConfig, mesh: DeviceMesh,
                         axis_name: str = "stage") -> PipelineMaps:
    """Run a ``[T, H, W]`` frame stream through the stage pipeline.

    Every rank of ``mesh`` calls it with the whole stream (only the four
    head-state maps travel between stages).  ``config.num_disparities``
    is the full range; each stage searches ``(D+1)/S`` of it.

    Returns ``PipelineMaps`` of ``[T, H, W]`` maps, on every rank (the
    last stage's result, broadcast), equal to fp rounding to the
    full-range single-device result.
    """
    if config.num_disparities is None:
        raise ValueError("pipeline parallelism requires banded mode")
    T, H, W = cameras.shape
    S = mesh.size(mesh.mesh_dim_names.index(axis_name))
    D = config.num_disparities
    if (D + 1) % S != 0:
        # Exact tiling keeps stages duplicate-free: an overlapping plane
        # would contribute twice to the softmax sums.
        raise ValueError(
            f"num_disparities+1 ({D + 1}) must divide evenly into "
            f"{S} stages; pad D so (D+1) % S == 0")
    chunk = _stage_chunks(D, S)
    group = mesh.get_group(axis_name)
    if S > 1:
        _require_lazy_nccl(group)
    stage = dist.get_rank(group)
    prev = dist.get_global_rank(group, stage - 1) if stage > 0 else None
    nxt = dist.get_global_rank(group, stage + 1) if stage + 1 < S else None
    last = dist.get_global_rank(group, S - 1)
    out = cameras.new_empty((4, T, H, W))
    pending = []
    for i in range(T + S - 1):
        f = i - stage                    # the frame this stage works on
        if not 0 <= f < T:
            continue
        part = chunk_state(cameras[f], projectors[f], stage * chunk, chunk,
                           config)
        if prev is None:
            merged = part
        else:
            incoming = cameras.new_empty((4, H, W))
            dist.recv(incoming, prev, group=group)
            merged = merge_states(HeadState(*incoming.unbind(0)), part)
        if nxt is None:
            out[:, f] = torch.stack(tuple(finalize_state(merged, config)))
        else:
            for req, _ in pending:
                req.wait()
            buf = torch.stack(tuple(merged))
            pending = [(dist.isend(buf, nxt, group=group), buf)]
    for req, _ in pending:
        req.wait()
    if S > 1:
        dist.broadcast(out, last, group=group)
    return PipelineMaps(*out.unbind(0))


def stage_mesh(num_stages: int, device_type: str = "cuda") -> DeviceMesh:
    """A one-dimensional ``stage`` mesh over the first ``num_stages``
    ranks (``device_type`` ``"cuda"`` unless the caller asks for
    ``"cpu"``)."""
    if world_size() < num_stages:
        raise ValueError(f"{num_stages} stages need {num_stages} ranks, "
                         f"have {world_size()}")
    return DeviceMesh(device_type, torch.arange(num_stages),
                      mesh_dim_names=("stage",))


__all__ = ["HeadState", "chunk_state", "empty_state", "finalize_state",
           "merge_states", "pipelined_video_maps", "shift_right",
           "stage_mesh"]
