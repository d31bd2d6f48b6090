"""Training loop: gradient-based camera-image optimisation (PyTorch port).

The counterpart of ``custereomatching_tpu/models/optimize.py``: Adam over
the camera frames so that the differentiable (soft-argmax) disparity
matches a target map.  On CUDA tensors with the default backend the loss
runs the trainable fused pipeline (kernels K3w forward, K4 backward; where
the saved cost volume would not fit on the card, K3m forward and K5
backward, which keep no volume: ``models.stereo.keeps_volume``); on CPU
tensors, or with ``backend="torch"``, the plain volume op and head.
With a ``(data, space)`` mesh the loss runs the sharded volume
(``parallel/sharded.py``: K1 forward, K2 backward on each rank's
halo-extended block) and the plain head, as in the JAX package; the
camera is a ``DTensor``, the loss its global mean, and Adam updates each
rank's own block.

``torch.optim.Adam`` takes the place of ``optax.adam``, with the same
defaults (beta1 0.9, beta2 0.999, eps 1e-8 added outside the square root)
and the same update.  A torch optimizer holds its parameter, so the
camera is a leaf tensor that the step updates in place (no copy of the
frames per step), and :class:`TrainState` carries the optimizer.
:func:`train_state_from_jax` carries an optax Adam state across, so a run
begun in the JAX package continues here.
"""

from __future__ import annotations

import functools
from typing import Callable, List, NamedTuple, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from custereomatching_tpu_torch.models.stereo import StereoMatcher
from custereomatching_tpu_torch.parallel.sharded import (
    shard_batch,
    sharded_disparity,
)
from custereomatching_tpu_torch.utils.profiling import span

OptimizerFactory = Callable[[List[torch.Tensor]], torch.optim.Optimizer]


class TrainState(NamedTuple):
    """Optimisation state: the camera frames are the parameters."""

    camera: torch.Tensor                # [B, H, W] leaf, requires grad
    optimizer: torch.optim.Optimizer    # Adam over [camera]
    step: int


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    grad_norm: torch.Tensor


def adam(learning_rate: float) -> OptimizerFactory:
    """Adam with optax's defaults, as a factory over the parameter list."""
    return functools.partial(torch.optim.Adam, lr=learning_rate,
                             betas=(0.9, 0.999), eps=1e-8)


def init_state(camera: torch.Tensor,
               optimizer: OptimizerFactory) -> TrainState:
    """A :class:`TrainState` from initial camera frames (copied)."""
    leaf = camera.detach().clone().requires_grad_(True)
    return TrainState(camera=leaf, optimizer=optimizer([leaf]), step=0)


def train_state_from_jax(camera: np.ndarray, count, mu: np.ndarray,
                         nu: np.ndarray, learning_rate: float,
                         device=None) -> TrainState:
    """The port's state from an optax ``ScaleByAdamState`` (``count``,
    ``mu``, ``nu``, as numpy) and the JAX ``TrainState.camera``.

    optax's ``count`` is torch's ``step``, ``mu`` its ``exp_avg`` and
    ``nu`` its ``exp_avg_sq``; the next step then makes the update optax
    would have made.
    """
    state = init_state(torch.as_tensor(np.array(camera), device=device),
                       adam(learning_rate))
    sd = state.optimizer.state_dict()
    sd["state"] = {0: {
        "step": torch.tensor(float(np.asarray(count))),
        "exp_avg": torch.as_tensor(np.array(mu), device=device),
        "exp_avg_sq": torch.as_tensor(np.array(nu), device=device),
    }}
    state.optimizer.load_state_dict(sd)
    return state._replace(step=int(np.asarray(count)))


def _full(x: torch.Tensor) -> torch.Tensor:
    """A plain tensor of a (replicated or sharded) ``DTensor``'s value."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def disparity_loss(model: StereoMatcher, camera: torch.Tensor,
                   projector: torch.Tensor, target_disparity: torch.Tensor,
                   mesh=None) -> torch.Tensor:
    """Mean-squared error of the soft disparity against a target map.

    With ``mesh`` the volume is sharded
    (:meth:`StereoMatcher.sharded_cost_volume`) and the plain head runs on
    each block; the result is a replicated ``DTensor``, the global mean.  Plain tensors are distributed with the
    pipeline's placements (:func:`..parallel.sharded.shard_batch`)."""
    c = model.config
    if mesh is not None:
        camera, projector, target_disparity = shard_batch(
            (camera, projector, target_disparity), mesh)
        cv = model.sharded_cost_volume(camera, projector, mesh)
        d = sharded_disparity(cv, c)
    elif c.resolved_backend(camera.device) == "cuda":
        # The fused pipeline where it applies (no cost-volume cotangent in
        # memory), else the volume path: the method chooses.
        d = model.trainable_disparity_maps(camera, projector)
    else:
        d = model.disparity(model.cost_volume(camera, projector))
    err = d.soft_disparity - target_disparity
    return torch.mean(err * err)


def make_train_step(model: StereoMatcher, mesh=None):
    """A train step ``(state, projector, target) -> (state, metrics)``.

    The optimizer comes with the state (:func:`init_state`).  The step
    updates ``state.camera`` in place and returns the state with its
    count advanced.  With ``mesh`` the loss runs the sharded volume path;
    ``state.camera`` is then a ``DTensor`` (``init_state`` of
    :func:`..parallel.sharded.shard_batch`'s camera), each rank's Adam
    updates its own block, and the metrics are global plain tensors.
    A step is the span ``custereo.train.step``, its loss (the forward)
    ``custereo.train.loss``.
    """

    def step(state: TrainState, projector: torch.Tensor,
             target_disparity: torch.Tensor
             ) -> Tuple[TrainState, StepMetrics]:
        with span("custereo.train.step"):
            state.optimizer.zero_grad(set_to_none=True)
            with span("custereo.train.loss"):
                loss = disparity_loss(model, state.camera, projector,
                                      target_disparity, mesh)
            loss.backward()
            grad = state.camera.grad
            grad_norm = torch.sqrt(torch.sum(grad * grad))
            state.optimizer.step()
            return (state._replace(step=state.step + 1),
                    StepMetrics(loss=_full(loss.detach()),
                                grad_norm=_full(grad_norm)))

    return step


def optimize_camera(model: StereoMatcher, camera0: torch.Tensor,
                    projector: torch.Tensor,
                    target_disparity: torch.Tensor, *,
                    learning_rate: float = 1e-2, num_steps: int = 100,
                    mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Convenience loop: ``num_steps`` of Adam; returns the optimised
    camera (detached; with ``mesh`` gathered into a plain tensor on every
    rank) and the ``[num_steps]`` losses."""
    if mesh is not None:
        camera0, projector, target_disparity = shard_batch(
            (camera0, projector, target_disparity), mesh)
    state = init_state(camera0, adam(learning_rate))
    step_fn = make_train_step(model, mesh)
    losses = []
    for _ in range(num_steps):
        state, metrics = step_fn(state, projector, target_disparity)
        losses.append(metrics.loss)
    return _full(state.camera.detach()), torch.stack(losses)
