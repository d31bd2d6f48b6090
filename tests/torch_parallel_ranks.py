"""Rank bodies of the port's parallel tests: each runs on every spawned
gloo rank (``custereomatching_tpu_torch.parallel.spawn_ranks``) and
returns numpy results, which the tests hold against the JAX package's
shard_map functions in the pytest process.

This module imports torch and the port only, so a spawned rank does not
import JAX.  Sharded results are gathered (full) on every rank of their
mesh; a rank outside a mesh leaves its entry out.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from custereomatching_tpu_torch.config import MeshConfig, StereoConfig
from custereomatching_tpu_torch.models import (
    StereoMatcher,
    adam,
    init_state,
    make_train_step,
    optimize_camera,
)
from custereomatching_tpu_torch.parallel import (
    halo_exchange,
    initialize_multihost,
    make_global_mesh,
    make_mesh,
    pipelined_video_maps,
    process_local_batch_slice,
    shard_batch,
    sharded_cost_volume,
    sharded_disparity_maps,
    stage_mesh,
)

MESHES = [(1, 1), (2, 1), (1, 4), (2, 2)]


@contextlib.contextmanager
def world_of_one():
    """A gloo world of one in this process, destroyed on exit."""
    initialize_multihost(device="cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()


def _np(x):
    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.detach().numpy()


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _in(mesh) -> bool:
    return mesh.get_coordinate() is not None


def halo_rows(x, halo: int):
    """Forward and backward of halo_exchange on a (1, 4) mesh: each
    rank's extended block, and the gradient of sum(w * blocks)."""
    mesh = make_mesh(MeshConfig(1, 4), "cpu")
    group = mesh.get_group(1)
    block = shard_batch(_t(x), mesh).to_local().clone().requires_grad_(True)
    ext = halo_exchange(block, halo, group, axis=1)
    r = dist.get_rank()
    w = torch.from_numpy(np.random.default_rng(r).random(
        tuple(ext.shape), dtype=np.float32))
    (ext * w).sum().backward()
    return ext.detach().numpy(), w.numpy(), block.grad.numpy()


def parallel_suite(vol_inputs, grad_inputs, pallas_inputs, fused_inputs,
                   train_inputs, opt_inputs):
    """Every check of test_torch_parallel.py on 4 ranks."""
    out = {"volume": {}, "volume_plain": {}}
    cam, proj = (_t(a) for a in vol_inputs)
    for shape in MESHES:
        mesh = make_mesh(MeshConfig(*shape), "cpu")
        for D in (6, None):
            cfg = StereoConfig(kernel_size=5, num_disparities=D)
            if _in(mesh):
                got = _np(sharded_cost_volume(cam, proj, cfg, mesh))
                out["volume"][shape, D] = got
                out["volume_plain"][shape, D] = bool(np.array_equal(
                    got, StereoMatcher(cfg).cost_volume(cam, proj).numpy()))

    mesh = make_mesh(MeshConfig(1, 4), "cpu")
    out["halo"] = halo_rows(np.arange(32 * 16, dtype=np.float32)
                            .reshape(1, 32, 16), 3)
    try:
        z = torch.zeros((1, 16, 12))
        sharded_cost_volume(z, z, StereoConfig(kernel_size=15,
                                               num_disparities=4), mesh)
        out["halo_raises"] = None
    except ValueError as e:
        out["halo_raises"] = str(e)

    # Camera gradient of sum(volume^2) through the sharded volume.
    cam_g, proj_g = (_t(a) for a in grad_inputs)
    cfg = StereoConfig(kernel_size=3, num_disparities=4)
    c, p = shard_batch((cam_g, proj_g), mesh)
    c.requires_grad_(True)
    (sharded_cost_volume(c, p, cfg, mesh) ** 2).sum().backward()
    out["grad"] = _np(c.grad)

    # optimize_camera with the mesh lowers the loss.
    o_cam0, o_proj, o_target = (_t(a) for a in opt_inputs)
    _, losses = optimize_camera(
        StereoMatcher(StereoConfig(kernel_size=5, num_disparities=6)),
        o_cam0, o_proj, o_target, learning_rate=1e-3, num_steps=30,
        mesh=mesh)
    out["opt_losses"] = losses.numpy()

    mesh = make_mesh(MeshConfig(2, 2), "cpu")
    # The JAX suite's Pallas-shape volume.
    cam_p, proj_p = (_t(a) for a in pallas_inputs)
    cfg = StereoConfig(kernel_size=5, num_disparities=6)
    out["pallas_volume"] = _np(sharded_cost_volume(cam_p, proj_p, cfg, mesh))

    # Fused pipeline: maps, and the gradient of a mean loss (trainable).
    cam_f, proj_f = (_t(a) for a in fused_inputs)
    maps = sharded_disparity_maps(cam_f, proj_f, cfg, mesh)
    out["fused"] = [_np(m) for m in maps]
    plain = StereoMatcher(cfg).disparity_maps(cam_f, proj_f)
    out["fused_plain"] = all(np.array_equal(_np(a), b.numpy())
                             for a, b in zip(maps, plain))
    c, p, target = shard_batch((cam_f, proj_f, torch.zeros_like(cam_f)),
                               mesh)
    c.requires_grad_(True)
    r = sharded_disparity_maps(c, p, cfg, mesh, trainable=True)
    ((r.soft_disparity - target) ** 2).mean().backward()
    out["fused_grad"] = _np(c.grad)

    # One train step with the mesh.
    t_cam, t_proj = (_t(a) for a in train_inputs)
    model = StereoMatcher(StereoConfig(kernel_size=3, num_disparities=4))
    cam_s, proj_s, tgt_s = shard_batch(
        (t_cam, t_proj, torch.zeros_like(t_cam)), mesh)
    state = init_state(cam_s, adam(1e-2))
    state, metrics = make_train_step(model, mesh)(state, proj_s, tgt_s)
    out["train"] = (float(metrics.loss), float(metrics.grad_norm),
                    state.step)
    return out


def pipeline_suite(cams, projs, D: int, k: int):
    """pipelined_video_maps at S = 2 and 4 on 4 ranks, and the
    divisibility check."""
    out = {}
    cams, projs = _t(cams), _t(projs)
    cfg = StereoConfig(kernel_size=k, num_disparities=D)
    for S in (2, 4):
        mesh = stage_mesh(S, "cpu")
        if _in(mesh):
            got = pipelined_video_maps(cams, projs, cfg, mesh)
            out[S] = [m.numpy() for m in got]
    mesh = stage_mesh(2, "cpu")
    if _in(mesh):
        try:
            pipelined_video_maps(cams[:2], projs[:2],
                                 StereoConfig(kernel_size=5,
                                              num_disparities=8), mesh)
            out["tiling"] = None
        except ValueError as e:
            out["tiling"] = str(e)
    return out


def multihost_suite(step_inputs):
    """The multihost surface on 4 ranks: the global mesh, the batch
    slices, and one sharded train step on the global mesh."""
    out = {"world": dist.get_world_size(),
           "slice": process_local_batch_slice(16)}
    mesh = make_global_mesh(MeshConfig(2, 2), "cpu")
    out["mesh"] = (mesh.mesh_dim_names, tuple(mesh.mesh.shape),
                   sorted(mesh.mesh.flatten().tolist()))
    try:
        make_global_mesh(MeshConfig(1, 1), "cpu")
        out["partial"] = None
    except ValueError as e:
        out["partial"] = str(e)
    cam, proj = (_t(a) for a in step_inputs)
    model = StereoMatcher(StereoConfig(kernel_size=5, num_disparities=8))
    cam_s, proj_s, tgt_s = shard_batch((cam, proj, torch.zeros_like(cam)),
                                       mesh)
    state = init_state(cam_s, adam(1e-2))
    _, metrics = make_train_step(model, mesh)(state, proj_s, tgt_s)
    out["loss"] = float(metrics.loss)
    return out


def fail_on_rank_one():
    """Rank 1 raises; rank 0 waits on it."""
    if dist.get_rank() == 1:
        raise RuntimeError("rank one fails on purpose")
    dist.recv(torch.zeros(1), 1)


def hang():
    """Never returns (a rank stuck in a collective)."""
    time.sleep(600)
