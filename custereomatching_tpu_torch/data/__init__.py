"""Synthetic stereo data (numpy only)."""

from custereomatching_tpu_torch.data.synthetic import (
    box_scene_disparity,
    make_stereo_pair,
    render_camera,
    slanted_plane_disparity,
    speckle_pattern,
)

__all__ = [
    "box_scene_disparity",
    "make_stereo_pair",
    "render_camera",
    "slanted_plane_disparity",
    "speckle_pattern",
]
