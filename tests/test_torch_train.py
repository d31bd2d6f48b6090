"""PyTorch port, training slice: the closed-form camera VJP, the trainable
fused pipeline's plain twin, the model's trainable maps, torch Adam steps
and the trainer example, held against the JAX package on the CPU (its
Pallas kernels in interpret mode, or its XLA op)."""

import dataclasses
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from custereomatching_tpu.config import StereoConfig as JaxStereoConfig
from custereomatching_tpu.data import synthetic as jax_synthetic
from custereomatching_tpu.models import StereoMatcher as JaxStereoMatcher
from custereomatching_tpu.models import optimize as jax_optimize
from custereomatching_tpu.ops import zncc as jax_zncc
from custereomatching_tpu.ops.pallas_pipeline import (
    PipelineMaps as JaxPipelineMaps,
    stereo_pipeline_trainable as jax_pipeline_trainable,
)
from custereomatching_tpu.ops.pallas_zncc import stereo_matching_pallas
from custereomatching_tpu.utils import metrics as jax_metrics
from custereomatching_tpu_torch import (
    StereoConfig,
    StereoMatcher,
    config_from_jax,
)
from custereomatching_tpu_torch.data import synthetic
from custereomatching_tpu_torch.examples import train as train_example
from custereomatching_tpu_torch.models import optimize
from custereomatching_tpu_torch.ops import stereo_matching
from custereomatching_tpu_torch.ops.cuda_pipeline import (
    fused_pipeline_bwd_cuda,
    fused_pipeline_train_cuda,
    stereo_pipeline_reference,
    stereo_pipeline_trainable,
    stereo_pipeline_trainable_reference,
)
from custereomatching_tpu_torch.ops.cuda_zncc import camera_grad_banded_cuda
from custereomatching_tpu_torch.ops.disparity import extract_disparity
from custereomatching_tpu_torch.ops.zncc import (
    camera_grad_banded,
    forward_banded,
)
from custereomatching_tpu_torch.utils import metrics
from custereomatching_tpu_torch.utils.profiling import COUNTS

# The JAX suite's gradient tolerance (tests/test_pallas_bwd.py:89).
GRAD_TOL = dict(rtol=1e-3, atol=1e-6)


def _pair(seed, *shape):
    rng = np.random.default_rng(seed)
    return (rng.random(shape, dtype=np.float32),
            rng.random(shape, dtype=np.float32))


@pytest.mark.parametrize("shape", [
    (24, 150, 10, 5),      # the shapes of tests/test_pallas_bwd.py:41
    (16, 100, 37, 7),
    (10, 30, 4, 1),        # k = 1 stays on the plain path
])
def test_closed_form_vjp_matches_jax(shape):
    """The CPU op's backward is the closed form (not autograd of the
    forward), and it is jax.grad of the XLA op and of the Pallas op."""
    H, W, D, K = shape
    cam, proj = _pair(0, H, W)
    g = np.random.default_rng(1).standard_normal(
        (H, W, D + 1)).astype(np.float32)
    jcam, jproj, jg = jnp.asarray(cam), jnp.asarray(proj), jnp.asarray(g)
    wants = [jax.grad(lambda c: jnp.sum(
        jax_zncc.stereo_matching(c, jproj, D, K) * jg))(jcam)]
    if K >= 3:
        wants.append(jax.grad(lambda c: jnp.sum(stereo_matching_pallas(
            c, jproj, D, K, 1e-8, True) * jg))(jcam))

    cam_t = torch.from_numpy(cam).requires_grad_(True)
    before = COUNTS.copy()
    (stereo_matching(cam_t, torch.from_numpy(proj), D, K)
     * torch.from_numpy(g)).sum().backward()
    assert COUNTS - before == Counter({"plain.forward_banded": 1,
                                       "plain.camera_grad_banded": 1})
    for want in wants:
        np.testing.assert_allclose(cam_t.grad.numpy(), np.asarray(want),
                                   **GRAD_TOL)


def test_k2_wrapper_cpu_takes_closed_form():
    B, H, W, D, K = 2, 12, 30, 5, 3
    cam, proj = (torch.from_numpy(a) for a in _pair(2, B, H, W))
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B, D + 1, H, W)).astype(np.float32))
    cost = forward_banded(cam, proj, D, K).permute(0, 3, 1, 2)
    before = COUNTS.copy()
    got = camera_grad_banded_cuda(cam, proj, cost, g, D, K)
    assert COUNTS - before == Counter({"plain.camera_grad_banded": 1})
    want = camera_grad_banded(cam, proj, g.permute(0, 2, 3, 1), D, K)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="plane-major"):
        camera_grad_banded_cuda(cam, proj, cost[:, :-1], g, D, K)


def _cotangents(seed, H, W):
    """Random soft-disparity and confidence cotangents at the scale a mean
    loss gives them (1 / (H W)), the regime of the JAX suite's gradient
    tolerance (its test_fused_trainable_pipeline_grad)."""
    rng = np.random.default_rng(seed)
    scale = np.float32(1.0 / (H * W))
    return (rng.standard_normal((H, W)).astype(np.float32) * scale,
            rng.standard_normal((H, W)).astype(np.float32) * scale)


def _assert_grad_close(got, want):
    np.testing.assert_allclose(got, want, **GRAD_TOL)
    assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)


def _torch_grad(fn, cam, proj, gs, gc):
    cam_t = torch.from_numpy(cam)[None].requires_grad_(True)
    maps = fn(cam_t, torch.from_numpy(proj)[None])
    loss = ((maps.soft_disparity[0] * torch.from_numpy(gs)).sum()
            + (maps.confidence[0] * torch.from_numpy(gc)).sum())
    (grad,) = torch.autograd.grad(loss, cam_t)
    return maps, grad[0].numpy()


@pytest.mark.parametrize("shape,beta", [
    ((24, 150, 10, 5), 50.0),   # unnormalized head
    ((16, 100, 37, 7), 80.0),   # rescaled head: 80 + ln(37*38) > 85
])
def test_trainable_reference_matches_jax(shape, beta):
    """The plain twin's maps and camera gradient (soft and confidence
    cotangents) against the JAX trainable pipeline in interpret mode; the
    autograd node over the K3w/K4 wrappers takes the same plain pieces on
    CPU tensors and agrees."""
    H, W, D, K = shape
    cam, proj = _pair(4, H, W)
    gs, gc = _cotangents(5, H, W)
    jproj = jnp.asarray(proj)
    jmaps, vjp = jax.vjp(lambda c: jax_pipeline_trainable(
        c, jproj, D, K, 1e-8, beta, 0.6, True), jnp.asarray(cam))
    zeros = jnp.zeros((H, W), jnp.float32)
    (want,) = vjp(JaxPipelineMaps(disparity=zeros,
                                  soft_disparity=jnp.asarray(gs),
                                  mask=zeros, confidence=jnp.asarray(gc)))

    def ref(c, p):
        return stereo_pipeline_trainable_reference(c, p, D, K, 1e-8, beta,
                                                   0.6)

    def node(c, p):
        return stereo_pipeline_trainable(c, p, D, K, 1e-8, beta, 0.6)

    maps, got = _torch_grad(ref, cam, proj, gs, gc)
    _assert_grad_close(got, np.asarray(want))
    np.testing.assert_array_equal(maps.disparity[0].numpy(),
                                  np.asarray(jmaps.disparity))
    np.testing.assert_array_equal(maps.mask[0].numpy(),
                                  np.asarray(jmaps.mask))
    np.testing.assert_allclose(maps.confidence[0].detach().numpy(),
                               np.asarray(jmaps.confidence), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(maps.soft_disparity[0].detach().numpy(),
                               np.asarray(jmaps.soft_disparity), rtol=1e-3,
                               atol=1e-3)
    _, got_node = _torch_grad(node, cam, proj, gs, gc)
    np.testing.assert_allclose(got_node, got, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("beta,D", [(50.0, 6), (80.0, 37)])
def test_trainable_reference_matches_autograd(beta, D):
    """On tie-free random inputs the explicit head cotangent (first-argmax
    convention) is torch autograd through the plain volume and head."""
    H, W, K = 12, 40, 5
    cam, proj = _pair(6, H, W)
    gs, gc = _cotangents(7, H, W)

    def autograd_path(c, p):
        return extract_disparity(forward_banded(c, p, D, K), D, 0.6, beta)

    def ref(c, p):
        return stereo_pipeline_trainable_reference(c, p, D, K, 1e-8, beta,
                                                   0.6)

    _, want = _torch_grad(autograd_path, cam, proj, gs, gc)
    _, got = _torch_grad(ref, cam, proj, gs, gc)
    _assert_grad_close(got, want)


def test_train_wrappers_cpu_take_plain_versions():
    B, H, W, D, K = 2, 10, 36, 5, 5
    cam, proj = (torch.from_numpy(a) for a in _pair(8, B, H, W))
    gs, gc = (torch.from_numpy(a) for a in _cotangents(9, B * H, W))
    gs, gc = gs.reshape(B, H, W), gc.reshape(B, H, W)
    before = COUNTS.copy()
    maps, res = fused_pipeline_train_cuda(cam, proj, D, K)
    grad = fused_pipeline_bwd_cuda(cam, proj, res, gs, gc, D, K)
    assert COUNTS - before == Counter({
        "plain.fused_pipeline_train_reference": 1,
        "plain.fused_pipeline_bwd_reference": 1,
        "plain.forward_banded": 1, "plain.camera_grad_banded": 1})
    assert grad.shape == (B, H, W) and bool(torch.isfinite(grad).all())
    # K3w's plain twin: the plain volume, plane-major, and the serving maps.
    torch.testing.assert_close(res.volume.permute(0, 2, 3, 1),
                               forward_banded(cam, proj, D, K), rtol=0,
                               atol=0)
    serving = stereo_pipeline_reference(cam, proj, D, K)
    for name in ("disparity", "mask"):
        torch.testing.assert_close(getattr(maps, name),
                                   getattr(serving, name), rtol=0, atol=0)
    for name in ("soft_disparity", "confidence"):
        torch.testing.assert_close(getattr(maps, name),
                                   getattr(serving, name), rtol=1e-5,
                                   atol=1e-5)
    torch.testing.assert_close(maps.disparity, res.am * maps.mask, rtol=0,
                               atol=0)


def test_model_trainable_maps_match_jax():
    B, H, W, D, K = 1, 16, 48, 6, 5
    jcfg = JaxStereoConfig(kernel_size=K, num_disparities=D,
                           backend="pallas_interpret")
    cam, proj = _pair(10, B, H, W)
    gs, _ = _cotangents(11, H, W)
    jproj = jnp.asarray(proj)

    def jloss(c):
        r = JaxStereoMatcher(jcfg).trainable_disparity_maps(c, jproj)
        return jnp.sum(r.soft_disparity[0] * jnp.asarray(gs)), r

    (_, jmaps), want = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(cam))
    model = StereoMatcher(config_from_jax(dataclasses.asdict(jcfg)))
    cam_t = torch.from_numpy(cam).requires_grad_(True)
    maps = model.trainable_disparity_maps(cam_t, torch.from_numpy(proj))
    (maps.soft_disparity[0] * torch.from_numpy(gs)).sum().backward()
    np.testing.assert_allclose(cam_t.grad.numpy(), np.asarray(want),
                               **GRAD_TOL)
    np.testing.assert_array_equal(maps.disparity.numpy(),
                                  np.asarray(jmaps.disparity))
    np.testing.assert_allclose(maps.soft_disparity.detach().numpy(),
                               np.asarray(jmaps.soft_disparity), rtol=1e-3,
                               atol=1e-3)


def _train_setup(B=1, H=16, W=48, D=8, K=5):
    cams, projs, _ = jax_synthetic.make_video_batch(B, H, W, d_min=2.0,
                                                    d_max=6.0, seed=3)
    jcfg = JaxStereoConfig(kernel_size=K, num_disparities=D, backend="xla")
    jmodel = JaxStereoMatcher(jcfg)
    target = np.array(jmodel.disparity_maps(
        jnp.asarray(cams), jnp.asarray(projs)).soft_disparity)
    noise = np.random.default_rng(0).standard_normal(cams.shape)
    camera0 = (cams + 0.05 * noise).astype(np.float32)
    model = StereoMatcher(config_from_jax(dataclasses.asdict(jcfg)))
    return jmodel, model, camera0, projs, target


def _jax_steps(jmodel, camera0, projs, target, n, lr):
    opt = optax.adam(lr)
    state = jax_optimize.init_state(jnp.asarray(camera0), opt)
    step = jax_optimize.make_train_step(jmodel, opt)
    losses = []
    for _ in range(n):
        state, m = step(state, jnp.asarray(projs), jnp.asarray(target))
        losses.append(float(m.loss))
    return state, losses


def test_train_steps_match_optax():
    """Three Adam steps from one camera: torch Adam tracks optax."""
    lr = 1e-2
    jmodel, model, camera0, projs, target = _train_setup()
    jstate, jlosses = _jax_steps(jmodel, camera0, projs, target, 3, lr)

    state = optimize.init_state(torch.from_numpy(camera0), optimize.adam(lr))
    step = optimize.make_train_step(model)
    losses, norms = [], []
    for _ in range(3):
        state, m = step(state, torch.from_numpy(projs),
                        torch.from_numpy(target))
        losses.append(float(m.loss))
        norms.append(float(m.grad_norm))
    assert state.step == 3 and int(jstate.step) == 3
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    np.testing.assert_allclose(state.camera.detach().numpy(),
                               np.asarray(jstate.camera), rtol=0,
                               atol=1e-4)
    assert all(np.isfinite(norms))

    cam, losses_t = optimize.optimize_camera(
        model, torch.from_numpy(camera0), torch.from_numpy(projs),
        torch.from_numpy(target), learning_rate=lr, num_steps=3)
    np.testing.assert_allclose(losses_t.numpy(), losses, rtol=1e-6)
    torch.testing.assert_close(cam, state.camera.detach(), rtol=0, atol=0)


@pytest.mark.parametrize("cfg", [
    dict(num_disparities=4),
    dict(num_disparities=4, grad_projector=True),
    dict(num_disparities=None),
], ids=["banded", "grad_projector", "all_pairs"])
def test_disparity_loss_leaves_the_cuda_path_to_the_matcher(monkeypatch,
                                                            cfg):
    """On the ``cuda`` backend the loss takes
    ``trainable_disparity_maps`` whatever the config (the method picks the
    fused pipeline or the volume path); on ``torch`` it takes the volume
    path, ``disparity(cost_volume(...))``."""
    cam, proj = (torch.from_numpy(a) for a in _pair(11, 1, 10, 24))
    target = torch.full((1, 10, 24), 2.0)
    model = StereoMatcher(StereoConfig(kernel_size=3, **cfg))
    calls = []
    want = optimize.disparity_loss(model, cam, proj, target)
    maps = model._volume_maps(cam, proj)

    def trainable(self, camera, projector):
        calls.append((camera, projector))
        return maps

    monkeypatch.setattr(StereoMatcher, "trainable_disparity_maps", trainable)
    assert optimize.disparity_loss(model, cam, proj, target) == want
    assert calls == []
    monkeypatch.setattr(StereoConfig, "resolved_backend",
                        lambda self, device: "cuda")
    got = optimize.disparity_loss(model, cam, proj, target)
    assert len(calls) == 1 and calls[0][0] is cam and calls[0][1] is proj
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_train_state_from_jax_continues_optax():
    """Two optax steps, then the third in the port from the handed-over
    state, against the third optax step."""
    lr = 1e-2
    jmodel, model, camera0, projs, target = _train_setup()
    jstate2, _ = _jax_steps(jmodel, camera0, projs, target, 2, lr)
    jstate3, jlosses = _jax_steps(jmodel, camera0, projs, target, 3, lr)
    adam_state = jstate2.opt_state[0]
    state = optimize.train_state_from_jax(
        np.asarray(jstate2.camera), np.asarray(adam_state.count),
        np.asarray(adam_state.mu), np.asarray(adam_state.nu), lr)
    assert state.step == 2
    state, m = optimize.make_train_step(model)(
        state, torch.from_numpy(projs), torch.from_numpy(target))
    np.testing.assert_allclose(float(m.loss), jlosses[-1], rtol=1e-4)
    np.testing.assert_allclose(state.camera.detach().numpy(),
                               np.asarray(jstate3.camera), rtol=0,
                               atol=1e-4)


def test_mesh_not_ported():
    """Named for when ``mesh`` raised: now ``make_train_step(model, mesh)``
    runs a step on a 1 x 1 mesh of a gloo world of one, and the sharded
    loss is the unsharded one."""
    from custereomatching_tpu_torch.config import MeshConfig
    from custereomatching_tpu_torch.parallel import make_mesh, shard_batch
    from tests.torch_parallel_ranks import world_of_one

    model = StereoMatcher(config_from_jax({"num_disparities": 2,
                                           "kernel_size": 3}))
    rng = np.random.default_rng(21)
    cam, proj = (torch.from_numpy(rng.random((1, 6, 8), dtype=np.float32))
                 for _ in range(2))
    target = torch.zeros((1, 6, 8))
    want = optimize.disparity_loss(model, cam, proj, target)
    with world_of_one():
        mesh = make_mesh(MeshConfig(1, 1), "cpu")
        loss = optimize.disparity_loss(model, cam, proj, target, mesh=mesh)
        assert torch.equal(loss.full_tensor(), want)
        cam_s, proj_s, tgt_s = shard_batch((cam, proj, target), mesh)
        state = optimize.init_state(cam_s, optimize.adam(1e-2))
        state, m = optimize.make_train_step(model, mesh=mesh)(
            state, proj_s, tgt_s)
        assert state.step == 1
        assert torch.equal(m.loss, want)
        assert bool(torch.isfinite(m.grad_norm))


def test_video_batch_and_metrics_match_jax():
    got = synthetic.make_video_batch(3, 12, 40, d_min=2.0, d_max=9.0, seed=5)
    want = jax_synthetic.make_video_batch(3, 12, 40, d_min=2.0, d_max=9.0,
                                          seed=5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    rng = np.random.default_rng(12)
    pred = rng.uniform(0, 8, (2, 10, 12)).astype(np.float32)
    truth = rng.uniform(0, 8, (2, 10, 12)).astype(np.float32)
    mask = (rng.random((2, 10, 12)) > 0.3).astype(np.float32)
    for m in (None, mask):
        want_m = jax_metrics.disparity_metrics(
            jnp.asarray(pred), jnp.asarray(truth),
            None if m is None else jnp.asarray(m))
        got_m = metrics.disparity_metrics(
            torch.from_numpy(pred), torch.from_numpy(truth),
            None if m is None else torch.from_numpy(m))
        assert got_m.keys() == want_m.keys()
        for key, value in want_m.items():
            assert got_m[key] == pytest.approx(value, rel=1e-6, abs=1e-7)


def test_trainer_example_checkpoint_and_resume(tmp_path, capsys):
    argv = ["--height", "16", "--width", "40", "--frames", "1", "-D", "5",
            "-k", "5", "--ckpt-dir", str(tmp_path), "--ckpt-every", "1",
            "--device", "cpu"]
    train_example.main(argv + ["--steps", "2"])
    out = capsys.readouterr().out
    assert "checkpointed step 2" in out and "final disparity" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000001.pt", "step_00000002.pt"]
    train_example.main(argv + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "step     3" in out
    # Sharded over a 1 x 2 mesh of 2 spawned gloo ranks: resumes from the
    # single-device checkpoint and checkpoints the full state.
    train_example.main(argv + ["--steps", "4", "--mesh", "1x2", "--ranks",
                               "2"])
    out = capsys.readouterr().out
    assert "mesh: DeviceMesh" in out and "resumed from step 3" in out
    assert "checkpointed step 4" in out
    assert "step_00000004.pt" in [p.name for p in tmp_path.iterdir()]
    # --autotune on the CPU: nothing to tune (no tile), and it trains.
    train_example.main(argv + ["--steps", "5", "--autotune"])
    out = capsys.readouterr().out
    assert "autotune: nothing to tune on the torch backend" in out
    assert "resumed from step 4" in out and "step     5" in out
