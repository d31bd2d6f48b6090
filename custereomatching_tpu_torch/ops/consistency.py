"""Left-right consistency checking for disparity maps (PyTorch port).

The counterpart of ``custereomatching_tpu/ops/consistency.py``: match in
both directions and invalidate the pixels whose two estimates disagree.
The right match is the left match of the horizontally flipped pair, so
it runs the same kernel (K3 on the ``cuda`` backend).  The gather
``d_R(x - d_L(x))`` is one ``torch.gather`` (:func:`_select_shifted_f`,
which the pyramid's warp uses too).
"""

from __future__ import annotations

import torch


def _select_shifted_f(src: torch.Tensor, k_map: torch.Tensor, lo: int,
                      hi: int) -> torch.Tensor:
    """``out[..., y, x] = src[..., y, x - k_map[..., y, x]]`` for integer
    ``k_map`` values in ``[lo, hi]``; zero where the source column is out
    of view or ``k_map`` lies outside ``[lo, hi]``.  ``k_map`` is cut to
    integers toward zero, as the JAX ``astype(int32)``.

    The JAX package selects with ``hi - lo + 1`` where-passes over
    statically shifted copies, a TPU choice (XLA's lane gathers are slow
    there).  Here it is one ``torch.gather`` with two masks; the selection
    is exact.  Each range test is a clamp compared with what it clamped,
    and the clamped column is the gather's index, so that the selection
    takes ten passes over the map."""
    W = src.shape[-1]
    k = k_map.to(torch.int64)
    cols = torch.arange(W, device=src.device) - k
    index = cols.clamp(0, W - 1)
    valid = (index == cols) & (k.clamp(lo, hi) == k)
    return torch.where(valid, torch.gather(src, -1, index), 0.0)


def lr_consistency_mask(disparity_left: torch.Tensor,
                        disparity_right: torch.Tensor,
                        num_disparities: int,
                        tolerance: float = 1.0) -> torch.Tensor:
    """``1.0`` where ``|d_L(x) - d_R(x - round(d_L(x)))| <= tolerance``.

    Args:
      disparity_left: ``[..., H, W]`` camera-side disparity (left match).
      disparity_right: ``[..., H, W]`` projector-side disparity (right
        match), in the same convention (positive, leftward in camera
        coordinates).
      num_disparities: maximum disparity: shifts outside ``[0, D]`` read 0.
      tolerance: the largest allowed ``|d_L - d_R|`` in pixels.

    ``torch.round`` rounds half to even, as ``jnp.round`` does.
    """
    d_round = torch.round(disparity_left)
    d_r_at = _select_shifted_f(disparity_right, d_round, 0,
                               int(num_disparities))
    ok = torch.abs(disparity_left - d_r_at) <= tolerance
    return ok.to(disparity_left.dtype)


def matched_pair_right(camera: torch.Tensor, projector: torch.Tensor):
    """The flipped pair whose left match is the right match of the
    original: the flipped projector as the new camera, the flipped camera
    as the new projector.  Flip the maps back with :func:`flip_back`."""
    return projector.flip(-1), camera.flip(-1)


def flip_back(x: torch.Tensor) -> torch.Tensor:
    """Undo the horizontal flip on a map made from the flipped pair."""
    return x.flip(-1)
