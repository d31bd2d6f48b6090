"""Plain PyTorch ZNCC cost volumes and their closed-form VJPs.

The twin of ``custereomatching_tpu/ops/zncc.py`` (``box2d``, ``box_rows``,
``_hankel_cols``, ``_image_moments``, the banded and all-pairs forwards
and camera VJPs, the ``_stereo_matching`` custom VJP and
``stereo_matching_with_proj_grad``), plus the closed-form projector VJP of
``pallas_zncc_bwd.py``: the CPU backend of the port, and the plain
versions that the CUDA kernels K1 (``csrc/zncc_banded.cu``), K2
(``csrc/zncc_banded_bwd.cu``), K7 (``csrc/zncc_banded_proj_bwd.cu``) and
K8 (``csrc/zncc_allpairs.cu``) are held against on the card.

Numerical contract: windows read zeros outside the image, means divide
by k^2 including the padding, and
``cost = (exy + eps) / sqrt(ex2 * ey2 + eps)`` in fp32.

The forwards take ``1 / sqrt`` as ``torch.rsqrt``.  ``torch.sqrt`` of a
large CPU tensor runs a vector-math library routine (MKL's, in MKL
builds) whose first call in a process has returned one thread's chunk
inexact, costs off by up to 2e-4; ``rsqrt`` is PyTorch's own division by
an exact square root.

Window sums are k shifted-slice adds over a zero-padded tensor, rows then
columns.  ``F.conv2d`` is avoided on purpose: cuDNN runs fp32
convolutions in TF32 by default, which would spoil every comparison on
the card.  For the same reason the all-pairs products are k shifted
broadcast multiply-adds, not ``torch.matmul``: they stay exact fp32
whatever the global TF32 flags say.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from custereomatching_tpu_torch.utils.profiling import COUNTS, span

EPSILON = 1e-8


def _box_axis(x: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """k-tap zero-padded ("same") windowed sum along ``dim``."""
    p = k // 2
    n = x.shape[dim]
    if p:
        zeros = x.new_zeros(x.shape[:dim] + (p,) + x.shape[dim + 1:])
        x = torch.cat([zeros, x, zeros], dim=dim)
    out = x.narrow(dim, 0, n).clone()
    for t in range(1, k):
        out += x.narrow(dim, t, n)
    return out


def box_rows(x: torch.Tensor, k: int, dim: int = 0) -> torch.Tensor:
    """k-tap zero-padded windowed sum along ``dim`` only (the vertical
    pass of the all-pairs cross term; the JAX ``box_rows`` at dim 0)."""
    return _box_axis(x, k, dim % x.ndim)


def _hankel_cols(img: torch.Tensor, k: int) -> torch.Tensor:
    """Row-wise Hankel view of ``[..., W]`` images: ``out[..., w, j] =
    img_padded[..., w + j - k//2]``, shape ``[..., W, k]``."""
    p = k // 2
    W = img.shape[-1]
    padded = F.pad(img, (p, p))
    return torch.stack([padded[..., j:j + W] for j in range(k)], dim=-1)


def box2d(x: torch.Tensor, k: int, dim: int = 0) -> torch.Tensor:
    """k x k windowed sum over axes ``dim`` and ``dim + 1``, zero-padded.

    ``out[h, w] = sum_{|i|, |j| <= k//2} x[h+i, w+j]`` with out-of-bounds
    terms zero.  With the default ``dim=0`` this is the JAX ``box2d``
    (leading two axes; trailing axes have window 1).
    """
    dim = dim % x.ndim
    return _box_axis(_box_axis(x, k, dim), k, dim + 1)


def _image_moments(img: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Window sum S and centered second moment E2 = sum (x - mu)^2 of a
    ``[B, H, W]`` batch, for every window center."""
    k2 = float(k * k)
    s = box2d(img, k, dim=1)
    s2 = box2d(img * img, k, dim=1)
    return s, s2 - s * s / k2


def _band_index(W: int, D: int, device: torch.device) -> torch.Tensor:
    """[W, D+1] indices into a left-extended (by D) column axis: entry
    (w, d) addresses original column (w - d), always in range."""
    w = torch.arange(W, device=device)[:, None]
    d = torch.arange(D + 1, device=device)[None, :]
    return w - d + D


def _banded_stats(camera: torch.Tensor, projector: torch.Tensor, D: int,
                  k: int):
    """Window statistics of the banded forward, for ``[B, H, W]`` pairs;
    the band tensors are ``[B, H, W, D+1]``."""
    k2 = float(k * k)
    sx, ex2 = _image_moments(camera, k)
    # Left-extend the projector by D zero columns so column (w - d) is a
    # plain gather; the zeros reproduce the out-of-image reads.
    proj_ext = F.pad(projector, (D, 0))
    sy_ext, ey2_ext = _image_moments(proj_ext, k)
    idx = _band_index(camera.shape[-1], D, camera.device)
    proj_band = proj_ext[:, :, idx]
    sy_band = sy_ext[:, :, idx]
    ey2_band = ey2_ext[:, :, idx]
    sxy = box2d(camera[..., None] * proj_band, k, dim=1)
    exy = sxy - sx[..., None] * sy_band / k2
    return sx, ex2, sy_band, ey2_band, proj_band, exy, k2


def forward_banded(camera: torch.Tensor, projector: torch.Tensor,
                   num_disparities: int, kernel_size: int = 15,
                   epsilon: float = EPSILON) -> torch.Tensor:
    """Banded cost volume of ``[B, H, W]`` pairs: ``[B, H, W, D+1]``, band
    d matching projector column ``w - d``.

    The plain version of K1 (the JAX ``_forward_banded``)."""
    COUNTS["plain.forward_banded"] += 1
    _, ex2, _, ey2_band, _, exy, _ = _banded_stats(
        camera, projector, int(num_disparities), int(kernel_size))
    return (exy + epsilon) * torch.rsqrt(ex2[..., None] * ey2_band + epsilon)


def _allpairs_cross(camera: torch.Tensor, projector: torch.Tensor,
                    k: int) -> torch.Tensor:
    """Raw all-pairs cross term of ``[B, H, W]`` pairs, ``[B, H, W, W]``:
    ``A[b, h, x, y] = sum_{i, j} cam_pad[h+i-p, x+j-p] proj_pad[h+i-p,
    y+j-p]``.  Each row's sum over j (products rounded, then added, j = 0
    first) comes first, then the rows' box; K8 sums in the same order."""
    hc, hp = _hankel_cols(camera, k), _hankel_cols(projector, k)
    g = hc[..., :, None, 0] * hp[..., None, :, 0]
    for j in range(1, k):
        g += hc[..., :, None, j] * hp[..., None, :, j]
    return box_rows(g, k, dim=-3)


def forward_allpairs(camera: torch.Tensor, projector: torch.Tensor,
                     kernel_size: int = 15,
                     epsilon: float = EPSILON) -> torch.Tensor:
    """All-pairs cost volume of ``[B, H, W]`` pairs: ``[B, H, W, W]``, the
    last axis the absolute projector column (the reference's own output).

    The plain version of K8 (the JAX ``_forward_allpairs``)."""
    COUNTS["plain.forward_allpairs"] += 1
    k = int(kernel_size)
    k2 = float(k * k)
    sx, ex2 = _image_moments(camera, k)
    sy, ey2 = _image_moments(projector, k)
    exy = (_allpairs_cross(camera, projector, k)
           - sx[..., :, None] * sy[..., None, :] / k2)
    return (exy + epsilon) * torch.rsqrt(ex2[..., :, None] * ey2[..., None, :]
                                         + epsilon)


def check_pair(camera: torch.Tensor, projector: torch.Tensor,
               kernel_size: int, min_kernel_size: int = 1) -> None:
    """Validate a stereo pair of matching ``[H, W]`` or ``[B, H, W]``
    images and an odd window size."""
    if camera.ndim not in (2, 3) or camera.shape != projector.shape:
        raise ValueError(
            f"expected matching [H, W] or [B, H, W] images, got "
            f"{tuple(camera.shape)} vs {tuple(projector.shape)}")
    if kernel_size < min_kernel_size or kernel_size % 2 != 1:
        raise ValueError(
            f"kernel_size must be odd and >= {min_kernel_size}, got "
            f"{kernel_size}")


def camera_grad_banded(camera: torch.Tensor, projector: torch.Tensor,
                       g: torch.Tensor, num_disparities: int,
                       kernel_size: int = 15,
                       epsilon: float = EPSILON) -> torch.Tensor:
    """Closed-form camera VJP of the banded volume: ``[B, H, W]`` pairs and
    a ``[B, H, W, D+1]`` cotangent to a ``[B, H, W]`` gradient.

    With ``n = exy + eps`` and ``r = (ex2 ey2 + eps)^{-1/2}``::

        cam_grad = A1 - box2d(GRMU) + box2d(B mux) - cam * box2d(B)
        B = sum_d g n r^3 ey2,  GRMU = sum_d g r muy,
        A1 = sum_d box2d(g r) proj(x - d)

    The plain version of K2 (the JAX ``_camera_grad_banded``)."""
    COUNTS["plain.camera_grad_banded"] += 1
    D, k = int(num_disparities), int(kernel_size)
    sx, ex2, sy_band, ey2_band, proj_band, exy, k2 = _banded_stats(
        camera, projector, D, k)
    mux = sx / k2
    muy_band = sy_band / k2
    r = torch.rsqrt(ex2[..., None] * ey2_band + epsilon)
    n = exy + epsilon
    gr = g * r
    b = torch.sum(g * n * (r * r * r) * ey2_band, dim=-1)
    grmu = torch.sum(gr * muy_band, dim=-1)
    a1 = torch.sum(box2d(gr, k, dim=1) * proj_band, dim=-1)
    return (a1 - box2d(grmu, k, dim=1) + box2d(b * mux, k, dim=1)
            - camera * box2d(b, k, dim=1))


def camera_grad_allpairs(camera: torch.Tensor, projector: torch.Tensor,
                         g: torch.Tensor, cost: torch.Tensor,
                         kernel_size: int = 15,
                         epsilon: float = EPSILON) -> torch.Tensor:
    """Closed-form camera VJP of the all-pairs volume: ``[B, H, W]`` pairs,
    the cotangent ``g`` and the forward volume ``cost`` (both ``[B, H, W,
    W]``) to a ``[B, H, W]`` gradient (the JAX ``_camera_grad_allpairs``).

    With the cost residual ``n r = c`` the B term is ``g c r^2 ey2`` (no
    cross-term recompute).  A1 goes through the row box ``G2 =
    box_rows(g r)``: ``A1[y, x] = sum_j E[y, x + p - j, j]`` with ``E[y] =
    G2[y] @ _hankel_cols(proj)[y]``, the JAX per-row ``[W, W] @ [W, k]``
    product, written as k broadcast multiply-reductions (exact fp32 whatever
    the global TF32 flags say).  The plain version of K8b
    (``cuda_allpairs.camera_grad_allpairs_cuda``; the JAX package leaves
    this backward to XLA), inside the span ``custereo.vjp.allpairs`` as
    K8b's launch is."""
    COUNTS["plain.camera_grad_allpairs"] += 1
    with span("custereo.vjp.allpairs"):
        k = int(kernel_size)
        p = k // 2
        k2 = float(k * k)
        W = camera.shape[-1]
        sx, ex2 = _image_moments(camera, k)
        sy, ey2 = _image_moments(projector, k)
        mux = sx / k2
        muy = sy / k2
        r = torch.rsqrt(ex2[..., :, None] * ey2[..., None, :] + epsilon)
        gr = g * r
        b = torch.sum(g * cost * (r * r) * ey2[..., None, :], dim=-1)
        grmu = torch.sum(gr * muy[..., None, :], dim=-1)
        g2 = box_rows(gr, k, dim=-3)
        hp = _hankel_cols(projector, k)
        a1 = torch.zeros_like(camera)
        for j in range(k):
            s = p - j                    # a1[x] += E[x + s, j] in range
            if abs(s) >= W:              # no x in range: JAX's e_pad zeros
                continue
            e_j = torch.sum(g2 * hp[..., None, :, j], dim=-1)
            if s >= 0:
                a1[..., :W - s] += e_j[..., s:]
            else:
                a1[..., -s:] += e_j[..., :W + s]
        return (a1 - box2d(grmu, k, dim=1) + box2d(b * mux, k, dim=1)
                - camera * box2d(b, k, dim=1))


def _projector_index(W: int, D: int, p: int, device: torch.device):
    """Gather of a band field into projector coordinates on the extended
    column axis e = x + p, x in [-p, W): entry (e, d) addresses camera
    column x + d, in range where ``inside``.  Returns ``(w, d, inside)``,
    each ``[W + p, D + 1]``."""
    e = torch.arange(W + p, device=device)[:, None]
    d = torch.arange(D + 1, device=device)[None, :]
    w = e - p + d
    inside = (w >= 0) & (w < W)
    return w.clamp(0, W - 1), d.expand_as(w), inside


def projector_grad_banded(camera: torch.Tensor, projector: torch.Tensor,
                          cost: torch.Tensor, g: torch.Tensor,
                          num_disparities: int, kernel_size: int = 15,
                          epsilon: float = EPSILON) -> torch.Tensor:
    """Closed-form projector VJP of the banded volume: ``[B, H, W]`` pairs,
    the forward volume and its cotangent (both ``[B, H, W, D+1]``) to a
    ``[B, H, W]`` gradient.

    Every per-plane field shifted to projector coordinates, ``f~_d[h, x] =
    f_d[h, x + d]`` (``pallas_zncc_bwd.py:586-597``)::

        proj_grad = sum_d cam~_d box2d(g~r_d) - box2d(z2) - proj box2d(z3)
                    + box2d(muy z3)
        z2 = sum_d g~r_d mux~_d,  z3 = sum_d bp~_d,  bp = g c r^2 ex2

    z2 and z3 live on the extended columns x in [-p, W): a shifted field
    holds real values at x < 0 (camera columns x + d >= 0), and the boxes
    at x in [0, p) read them.  ``muy`` and ``ey2`` there are the statistics
    of the partial windows of the image widened left by p zero columns.
    The plain version of K7."""
    COUNTS["plain.projector_grad_banded"] += 1
    D, k = int(num_disparities), int(kernel_size)
    p = k // 2
    k2 = float(k * k)
    W = camera.shape[-1]
    sx, ex2 = _image_moments(camera, k)
    sy_e, ey2_e = _image_moments(F.pad(projector, (p, 0)), k)
    w, d, inside = _projector_index(W, D, p, camera.device)
    zero = camera.new_zeros(())

    def band(f):                          # [B, H, W, D+1] -> [B, H, W+p, D+1]
        return torch.where(inside, f[:, :, w, d], zero)

    def pixel(f):                         # [B, H, W] -> [B, H, W+p, D+1]
        return torch.where(inside, f[:, :, w], zero)

    g_s = band(g)
    ex2_s = pixel(ex2)
    r = torch.rsqrt(ex2_s * ey2_e[..., None] + epsilon)
    gr = g_s * r
    a1p = torch.sum(pixel(camera) * box2d(gr, k, dim=1), dim=-1)
    z2 = torch.sum(gr * pixel(sx / k2), dim=-1)
    z3 = torch.sum(g_s * band(cost) * (r * r) * ex2_s, dim=-1)
    t2 = box2d(z2, k, dim=1)[..., p:]
    t3 = projector * box2d(z3, k, dim=1)[..., p:]
    t4 = box2d(sy_e / k2 * z3, k, dim=1)[..., p:]
    return a1p[..., p:] - t2 - t3 + t4


class StereoMatchingFunction(torch.autograd.Function):
    """The plain op as an autograd node, the counterpart of the JAX
    ``_stereo_matching`` custom VJP: banded (``num_disparities`` an int)
    saves the two images and its backward is :func:`camera_grad_banded`;
    all-pairs (``None``) also saves the volume, and its backward is
    :func:`camera_grad_allpairs` (``n r = c``).  The projector gets no
    gradient (``None``)."""

    @staticmethod
    def forward(ctx, camera, projector, num_disparities, kernel_size,
                epsilon):
        ctx.args = (num_disparities, kernel_size, epsilon)
        if num_disparities is None:
            cost = forward_allpairs(camera, projector, kernel_size, epsilon)
            ctx.save_for_backward(camera, projector, cost)
            return cost
        ctx.save_for_backward(camera, projector)
        return forward_banded(camera, projector, num_disparities,
                              kernel_size, epsilon)

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None
        D, k, eps = ctx.args
        if D is None:
            camera, projector, cost = ctx.saved_tensors
            cam_grad = camera_grad_allpairs(camera, projector, grad, cost,
                                            k, eps)
        else:
            camera, projector = ctx.saved_tensors
            cam_grad = camera_grad_banded(camera, projector, grad, D, k, eps)
        return cam_grad, None, None, None, None


def _batched(fn, camera, projector, num_disparities, kernel_size):
    """Validate a pair and run ``fn`` on it as a ``[B, H, W]`` batch;
    ``[H, W]`` images give an unbatched volume."""
    check_pair(camera, projector, kernel_size)
    if num_disparities is not None and num_disparities < 0:
        raise ValueError(f"num_disparities must be >= 0, got "
                         f"{num_disparities}")
    single = camera.ndim == 2
    if single:
        camera, projector = camera[None], projector[None]
    cost = fn(camera, projector)
    return cost[0] if single else cost


def stereo_matching_torch(camera: torch.Tensor, projector: torch.Tensor,
                          num_disparities: Optional[int],
                          kernel_size: int = 15,
                          epsilon: float = EPSILON) -> torch.Tensor:
    """The plain ZNCC op on any device: ``[H, W]`` or ``[B, H, W]`` pairs
    to ``[..., H, W, D+1]`` banded volumes, or ``[..., H, W, W]`` all-pairs
    volumes with ``num_disparities=None``.

    Differentiable in the camera through the closed-form VJPs
    (:class:`StereoMatchingFunction`), as the JAX XLA op is; the projector
    receives no gradient (the JAX op's camera-only contract).  k = 1 is
    accepted, as in the JAX XLA op.
    """
    D = None if num_disparities is None else int(num_disparities)
    return _batched(
        lambda c, p: StereoMatchingFunction.apply(c, p, D, int(kernel_size),
                                                  epsilon),
        camera, projector, num_disparities, kernel_size)


def stereo_matching_with_proj_grad(camera: torch.Tensor,
                                   projector: torch.Tensor,
                                   num_disparities: Optional[int],
                                   kernel_size: int = 15,
                                   epsilon: float = EPSILON) -> torch.Tensor:
    """The ZNCC op differentiable in both images, banded or all-pairs: torch
    autograd through the moments-form forward, as the JAX
    ``stereo_matching_with_proj_grad`` is XLA autodiff of it.  The
    patch-mean chain terms cancel exactly, so it equals the closed forms.
    Any device; k = 1 is accepted."""
    k = int(kernel_size)
    if num_disparities is None:
        def fn(c, p):
            return forward_allpairs(c, p, k, epsilon)
    else:
        def fn(c, p):
            return forward_banded(c, p, int(num_disparities), k, epsilon)
    return _batched(fn, camera, projector, num_disparities, kernel_size)
