"""Halo exchange of image border rows between spatial shards.

The counterpart of ``custereomatching_tpu/parallel/halo.py``: a k x k
windowed correlation split over row shards needs ``k//2`` rows of
context from each neighbour.  JAX ships them with two ``lax.ppermute``
rings; here each rank sends its edge rows to its neighbours in the
``space`` process group with ``dist.batch_isend_irecv`` (NCCL on cards,
so the rows never pass through the host; gloo on the CPU).

Boundary semantics: a rank with no neighbour on a side receives zeros
there, as ``ppermute`` delivers, which is the zero padding the ops apply
at true image borders.  A computation on the halo-extended block is
therefore the unsharded one.

Differentiable: the backward sends each halo slab's cotangent back to the
rank that owns those rows, which adds it onto its own edge rows (the
transposed ``ppermute``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _neighbours(group):
    """(rank in group, group size, global rank above or None, below or
    None)."""
    r = dist.get_rank(group)
    n = dist.get_world_size(group)
    up = dist.get_global_rank(group, r - 1) if r > 0 else None
    down = dist.get_global_rank(group, r + 1) if r + 1 < n else None
    return up, down


def _swap(to_up, to_down, group):
    """Send ``to_up`` to the rank above and ``to_down`` to the rank below;
    return what the rank above and the rank below sent (zeros where there
    is none)."""
    up, down = _neighbours(group)
    from_up = torch.zeros_like(to_down)
    from_down = torch.zeros_like(to_up)
    ops = []
    if up is not None:
        ops += [dist.P2POp(dist.isend, to_up, up, group),
                dist.P2POp(dist.irecv, from_up, up, group)]
    if down is not None:
        ops += [dist.P2POp(dist.isend, to_down, down, group),
                dist.P2POp(dist.irecv, from_down, down, group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return from_up, from_down, up is not None, down is not None


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, halo, group, axis):
        ctx.halo, ctx.group, ctx.axis = halo, group, axis
        size = x.shape[axis]
        top = x.narrow(axis, 0, halo).contiguous()
        bottom = x.narrow(axis, size - halo, halo).contiguous()
        # My top rows are the upper neighbour's bottom halo; my bottom
        # rows the lower neighbour's top halo.
        from_up, from_down, _, _ = _swap(top, bottom, group)
        return torch.cat([from_up, x, from_down], dim=axis)

    @staticmethod
    def backward(ctx, g):
        halo, group, axis = ctx.halo, ctx.group, ctx.axis
        size = g.shape[axis] - 2 * halo
        g_up = g.narrow(axis, 0, halo).contiguous()
        g_down = g.narrow(axis, halo + size, halo).contiguous()
        grad = g.narrow(axis, halo, size).clone()
        # The cotangent of my top halo belongs to the rank above (its
        # bottom rows), that of my bottom halo to the rank below.
        from_up, from_down, has_up, has_down = _swap(g_up, g_down, group)
        if has_up:
            grad.narrow(axis, 0, halo).add_(from_up)
        if has_down:
            grad.narrow(axis, size - halo, halo).add_(from_down)
        return grad, None, None, None


def halo_exchange(x: torch.Tensor, halo: int, group, axis: int = 1
                  ) -> torch.Tensor:
    """Extend a row-sharded block with ``halo`` rows from each neighbour.

    Every rank of ``group`` (the ``space`` process group, e.g.
    ``mesh.get_group("space")``) calls it on its own block.

    Args:
      x: the local block, e.g. ``[B, H_local, W]``.
      halo: context rows needed on each side (``kernel_size // 2``).
      group: the process group the rows are sharded over, ranks in row
        order.
      axis: the axis of ``x`` that holds the sharded rows.

    Returns:
      The block extended to ``H_local + 2*halo`` rows along ``axis``:
      ``[rows from above | local rows | rows from below]``, zeros where no
      neighbour exists (the true image border).
    """
    if halo == 0:
        return x
    size = x.shape[axis]
    if halo > size:
        raise ValueError(
            f"halo ({halo}) exceeds local shard extent ({size}); use fewer "
            f"'space' shards or a smaller kernel")
    if dist.get_world_size(group) == 1:
        # No neighbour on either side: both halos are the border's zero
        # fill, a plain pad with no collective.
        pad = [0, 0] * (x.ndim - 1 - axis % x.ndim) + [halo, halo]
        return torch.nn.functional.pad(x, pad)
    return _HaloExchange.apply(x, halo, group, axis)


__all__ = ["halo_exchange"]
