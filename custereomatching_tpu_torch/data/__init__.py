"""Data layer (numpy only): synthetic structured-light scenes, stereo-pair
and image IO, and the KITTI data path."""

from custereomatching_tpu_torch.data.io import (
    load_image_gray,
    load_stereo_pair_npy,
    save_disparity_png,
    save_stereo_pair_npz,
)
from custereomatching_tpu_torch.data import kitti
from custereomatching_tpu_torch.data.synthetic import (
    box_scene_disparity,
    make_stereo_pair,
    make_video_batch,
    render_camera,
    slanted_plane_disparity,
    speckle_pattern,
)

__all__ = [
    "box_scene_disparity",
    "kitti",
    "load_image_gray",
    "load_stereo_pair_npy",
    "make_stereo_pair",
    "make_video_batch",
    "render_camera",
    "save_disparity_png",
    "save_stereo_pair_npz",
    "slanted_plane_disparity",
    "speckle_pattern",
]
