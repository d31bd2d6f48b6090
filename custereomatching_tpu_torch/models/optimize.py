"""Training loop: gradient-based camera-image optimisation (PyTorch port).

The counterpart of ``custereomatching_tpu/models/optimize.py``: Adam over
the camera frames so that the differentiable (soft-argmax) disparity
matches a target map.  On CUDA tensors with the default backend the loss
runs the trainable fused pipeline (kernels K3w forward, K4 backward); on
CPU tensors, or with ``backend="torch"``, the plain volume op and head.

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

from custereomatching_tpu_torch.models.stereo import StereoMatcher

MESH_TODO = ("mesh: the parallel layer is not ported yet (ROADMAP, modules "
             "to port: parallel/)")

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


def disparity_loss(model: StereoMatcher, camera: torch.Tensor,
                   projector: torch.Tensor, target_disparity: torch.Tensor,
                   mesh=None) -> torch.Tensor:
    """Mean-squared error of the soft disparity against a target map."""
    if mesh is not None:
        raise NotImplementedError(MESH_TODO)
    c = model.config
    if (c.num_disparities is not None and not c.grad_projector
            and c.resolved_backend(camera.device) == "cuda"):
        # Trainable fused pipeline: no cost-volume cotangent in memory.
        d = model.trainable_disparity_maps(camera, projector)
    else:
        d = model.disparity(model.cost_volume(camera, projector))
    err = d.soft_disparity - target_disparity
    return torch.mean(err * err)


def make_train_step(model: StereoMatcher, mesh=None):
    """A train step ``(state, projector, target) -> (state, metrics)``.

    The optimizer comes with the state (:func:`init_state`).  The step
    updates ``state.camera`` in place and returns the state with its
    count advanced; ``mesh`` raises ``NotImplementedError``.
    """
    if mesh is not None:
        raise NotImplementedError(MESH_TODO)

    def step(state: TrainState, projector: torch.Tensor,
             target_disparity: torch.Tensor
             ) -> Tuple[TrainState, StepMetrics]:
        state.optimizer.zero_grad(set_to_none=True)
        loss = disparity_loss(model, state.camera, projector,
                              target_disparity)
        loss.backward()
        grad = state.camera.grad
        grad_norm = torch.sqrt(torch.sum(grad * grad))
        state.optimizer.step()
        return (state._replace(step=state.step + 1),
                StepMetrics(loss=loss.detach(), grad_norm=grad_norm))

    return step


def optimize_camera(model: StereoMatcher, camera0: torch.Tensor,
                    projector: torch.Tensor,
                    target_disparity: torch.Tensor, *,
                    learning_rate: float = 1e-2, num_steps: int = 100,
                    mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Convenience loop: ``num_steps`` of Adam; returns the optimised
    camera (detached) and the ``[num_steps]`` losses."""
    if mesh is not None:
        raise NotImplementedError(MESH_TODO)
    state = init_state(camera0, adam(learning_rate))
    step_fn = make_train_step(model)
    losses = []
    for _ in range(num_steps):
        state, metrics = step_fn(state, projector, target_disparity)
        losses.append(metrics.loss)
    return state.camera.detach(), torch.stack(losses)
