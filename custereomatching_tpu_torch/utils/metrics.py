"""Stereo evaluation metrics: end-point error and bad-pixel rates.

The counterpart of ``custereomatching_tpu/utils/metrics.py``, on torch
tensors (numpy arrays are accepted and converted).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def end_point_error(pred: torch.Tensor, truth: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean absolute disparity error over (optionally masked) pixels."""
    err = torch.abs(torch.as_tensor(pred) - torch.as_tensor(truth))
    if mask is None:
        return torch.mean(err)
    m = torch.as_tensor(mask).to(err.dtype)
    return torch.sum(err * m) / torch.clamp_min(torch.sum(m), 1.0)


def bad_pixel_rate(pred: torch.Tensor, truth: torch.Tensor,
                   threshold: float = 3.0,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fraction of (masked) pixels whose error exceeds ``threshold`` px
    (KITTI's D1 metric uses 3 px)."""
    err = torch.abs(torch.as_tensor(pred) - torch.as_tensor(truth))
    bad = (err > threshold).to(torch.float32)
    if mask is None:
        return torch.mean(bad)
    m = torch.as_tensor(mask).to(bad.dtype)
    return torch.sum(bad * m) / torch.clamp_min(torch.sum(m), 1.0)


def disparity_metrics(pred: torch.Tensor, truth: torch.Tensor,
                      mask: Optional[torch.Tensor] = None
                      ) -> Dict[str, float]:
    """EPE + bad-1px/3px rates + coverage, as plain floats for reporting."""
    out = {
        "epe": float(end_point_error(pred, truth, mask)),
        "bad1": float(bad_pixel_rate(pred, truth, 1.0, mask)),
        "bad3": float(bad_pixel_rate(pred, truth, 3.0, mask)),
    }
    if mask is not None:
        out["coverage"] = float(torch.mean(
            torch.as_tensor(mask).to(torch.float32)))
    return out
