"""PyTorch port, the volume head against the JAX package's: the plain twin
of K8h / K8hb's one-pass arithmetic (in ``test_torch_volume_head.py``)
and the autograd node of ``ops/cuda_head.py`` with the twin in its
kernels' place, held against
``custereomatching_tpu.ops.disparity.extract_disparity`` and its
``jax.vjp`` on the same volumes: exact ties, rows under and at
the threshold, all-pairs and banded, cotangents on the soft map, the
confidence and both.  JAX's ``max`` splits a tie's cotangent evenly, as
the twin's ``g_conf / ties`` does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custereomatching_tpu.ops import disparity as jax_disparity
from custereomatching_tpu_torch.ops import cuda_head
from custereomatching_tpu_torch.ops.cuda_head import VolumeHead
from custereomatching_tpu_torch.ops.disparity import DisparityResult
from tests.test_torch_volume_head import (
    BETA,
    CASES,
    FWD_TOL,
    THRESHOLD,
    _case_id,
    _cotangents,
    _grad_tol,
    _volume,
    volume_head_reference,
    volume_head_vjp_reference,
)


def _jax_head(cost: np.ndarray, D):
    """The JAX head on ``cost``, vmapped over a leading batch."""
    def head(v):
        return jax_disparity.extract_disparity(
            v, num_disparities=D, threshold=THRESHOLD, beta=BETA)
    return jax.vmap(head) if cost.ndim == 4 else head


def _jax_vjp(cost: torch.Tensor, D, g_soft, g_conf):
    """The JAX head's maps and its cost cotangent of ``g_soft`` and
    ``g_conf`` (None: a zero cotangent), in the volume's dtype."""
    x = cost.numpy()
    head = _jax_head(x, D)

    def soft_and_conf(v):
        r = head(v)
        return r.soft_disparity, r.confidence

    with jax.enable_x64(x.dtype == np.float64):
        v = jnp.asarray(x)
        maps = head(v)
        (soft, conf), pullback = jax.vjp(soft_and_conf, v)
        cot = tuple(jnp.zeros_like(o) if g is None
                    else jnp.asarray(g.numpy())
                    for o, g in ((soft, g_soft), (conf, g_conf)))
        (grad,) = pullback(cot)
        return ({name: torch.from_numpy(np.array(getattr(maps, name)))
                 for name in maps._fields},
                torch.from_numpy(np.array(grad)))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["fp64", "fp32"])
@pytest.mark.parametrize("which", ["soft", "conf", "both"])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_twin_matches_the_jax_head_and_its_vjp(case, which, dtype):
    """Hard map, mask and confidence bit for bit, the soft map within the
    head's tolerance, the closed-form cotangent (tie split included)
    within the gradient tolerance (fp32: plus the cancellation noise at
    the winning entries that ``_grad_tol`` admits)."""
    c = _volume(case).to(dtype)
    D = case[3]
    got, resid = volume_head_reference(c, D, THRESHOLD, BETA)
    g_soft, g_conf = (None if g is None else g.to(dtype)
                      for g in _cotangents(got, which))
    want, want_grad = _jax_vjp(c, D, g_soft, g_conf)
    for name in ("disparity", "mask", "confidence"):
        assert torch.equal(getattr(got, name), want[name]), name
    torch.testing.assert_close(got.soft_disparity, want["soft_disparity"],
                               **FWD_TOL)
    grad = volume_head_vjp_reference(c, got.confidence, resid, g_soft,
                                     g_conf, D is None, THRESHOLD, BETA)
    torch.testing.assert_close(grad, want_grad, **_grad_tol(want_grad))


@pytest.mark.parametrize("which", ["soft", "conf", "both"])
@pytest.mark.parametrize("case", [CASES[0], CASES[2], CASES[6],
                                  CASES[9]], ids=_case_id)
def test_node_matches_the_jax_head_and_its_vjp(case, which, monkeypatch):
    """The autograd node with the twin in its kernels' place: its maps and
    the cost gradient of the outputs a loss uses (the other's cotangent
    None) against JAX's, in fp32."""
    monkeypatch.setattr(
        cuda_head, "_head_forward",
        lambda cost, D, thr, beta, plane_major: volume_head_reference(
            cost, D, thr, beta))
    monkeypatch.setattr(
        cuda_head, "_head_vjp",
        lambda *args: volume_head_vjp_reference(*args[:-1]))
    c = _volume(case)
    D = case[3]
    leaf = c.clone().requires_grad_(True)
    out = VolumeHead.apply(leaf, D, THRESHOLD, BETA)
    g_soft, g_conf = _cotangents(DisparityResult(*out), which)
    want, want_grad = _jax_vjp(c, D, g_soft, g_conf)
    for got, name in zip(out, ("disparity", "soft_disparity", "mask",
                               "confidence")):
        tol = FWD_TOL if name == "soft_disparity" else dict(rtol=0, atol=0)
        torch.testing.assert_close(got.detach(), want[name], **tol)
    torch.autograd.backward(
        [o for o, g in ((out[1], g_soft), (out[3], g_conf))
         if g is not None],
        [g for g in (g_soft, g_conf) if g is not None])
    torch.testing.assert_close(leaf.grad, want_grad, **_grad_tol(want_grad))
