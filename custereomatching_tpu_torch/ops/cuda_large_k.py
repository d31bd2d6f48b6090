"""The large-k route: the banded kernels (K1-K7) and K8 where their blocks
do not fit the card's shared memory.

The rounds kernels stage a halo'd 16 x 64 tile and a plane's buffers in
shared memory; from k = 129 not one plane fits (K8's strip from k = 145,
``box_stats_kernel`` from k = 187), and the halo alone passes the 227 KB
a block may hold at k = 239.  JAX's kernels take every odd k (K7 every
odd k <= 129), so the port takes the route here wherever
``kernel_model.large_k_route``, at the card's opt-in shared memory
(``cuda_zncc.smem_floats``), says the kernel's own blocks do not: the
wrappers of ``cuda_zncc``, ``cuda_pipeline`` and ``cuda_allpairs`` call
the functions below.

The route is a chain of kernels (``csrc/large_k.cu``) that separate the
window, so what a block holds grows with k and not with k^2, each one
step of the plain forms of ``ops/zncc.py``: windowed sums along one axis
(two make ``box2d``; a block stages its lines in shared memory), the
window statistics, K1's cost planes a slab of ``COST_CHUNK`` planes at a
time, K3's head carried across the slabs, the camera VJP's fields (the
cotangent read, or formed from the head's maps as ``head_cotangent``
does) and its combine, K7's fields in projector columns, and K8's row
products, row sums and normalisation.

Every step is a function here that launches its kernel on a CUDA tensor
(``large_k.<step>`` in ``profiling.COUNTS``) and runs its plain form on a
CPU tensor, so the chains themselves run on the CPU against the plain ops.
A route function counts each call, on either device, as ``route.<K>``, K
the kernel it stands in for.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from custereomatching_tpu_torch.ops import _build
from custereomatching_tpu_torch.ops._build import ptr, stream_of
from custereomatching_tpu_torch.ops.zncc import _box_axis
from custereomatching_tpu_torch.utils.kernel_model import (
    cost_slabs,
    large_k_scratch,
)
from custereomatching_tpu_torch.utils.profiling import COUNTS


def _cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type != "cpu":
        raise ValueError(f"the large-k route runs on CUDA or (plain) CPU "
                         f"tensors, got {t.device}")
    return False


def _p(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(None) if t is None else ptr(t)


def _dense(*ts):
    """The tensors contiguous (None kept): the kernels index their operands
    as dense row-major arrays."""
    return tuple(None if t is None else t.contiguous() for t in ts)


def _launch(step: str, *args, device) -> None:
    """Launch the route's kernel ``step`` (C entry ``custereo_lk_<step>``)
    on ``device``'s current stream."""
    entry = f"custereo_lk_{step}"
    with torch.cuda.device(device):
        _build.launch(f"large_k.{step}", entry, *args, stream_of(device),
                      what=f"large-k {entry} launch")


# ---------------------------------------------------------------------------
# The steps: a kernel each on CUDA tensors, its plain form on CPU tensors
# ---------------------------------------------------------------------------

def box_axis(x: torch.Tensor, k: int, axis: int,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """k-tap zero-padded windowed sum of an ``[N, H, W]`` stack along H
    (``axis`` 0) or W (1): ``ops/zncc.py::_box_axis``."""
    N, H, W = x.shape
    if not _cuda(x):
        y = _box_axis(x, k, 1 + axis)
        return y if out is None else out.copy_(y)
    out = torch.empty_like(x) if out is None else out
    _launch("box_axis", ptr(x), ptr(out), N, H, W, k,
            axis, device=x.device)
    return out


def box2d_stack(x: torch.Tensor, k: int) -> torch.Tensor:
    """``box2d`` of each ``[H, W]`` plane of an ``[N, H, W]`` stack: rows,
    then columns, two :func:`box_axis` launches."""
    return box_axis(box_axis(x, k, 0), k, 1)


def pad_square(img: torch.Tensor, left: int) -> torch.Tensor:
    """``[2, N, H, W + left]``: the stack widened left by ``left`` zero
    columns, and its square."""
    N, H, W = img.shape
    if not _cuda(img):
        v = F.pad(img, (left, 0))
        return torch.stack([v, v * v])
    out = img.new_empty((2, N, H, W + left))
    _launch("pad_square", ptr(img), ptr(out), N, H,
            W, left, device=img.device)
    return out


def moments_finish(s: torch.Tensor, s2: torch.Tensor, k: int) -> None:
    """``s2 <- s2 - s s / k^2`` in place: the centred second moment."""
    k2 = float(k * k)
    if not _cuda(s):
        s2.copy_(s2 - s * s / k2)
        return
    _launch("moments_finish", ptr(s), ptr(s2),
            s.numel(), k2, device=s.device)


def moments(img: torch.Tensor, k: int, left: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Window sum S and centred second moment E2 of a ``[N, H, W]`` stack
    widened left by ``left`` zero columns (``_image_moments``), each
    ``[N, H, W + left]``."""
    N = img.shape[0]
    both = box2d_stack(pad_square(img, left).flatten(0, 1), k)
    s, s2 = both[:N], both[N:]
    moments_finish(s, s2, k)
    return s, s2


def band_products(cam: torch.Tensor, proj: torch.Tensor, d_lo: int,
                  P: int, out: torch.Tensor) -> torch.Tensor:
    """``out[b, j] = cam[b] * proj[b](x - d)``, d = d_lo + j, the
    projector zero left of column d; ``out`` ``[B, P, H, W]``."""
    B, H, W = cam.shape
    if not _cuda(cam):
        for j in range(P):
            d = d_lo + j
            out[:, j] = cam * F.pad(proj, (d, 0))[..., :W]
        return out
    _launch("band_products", ptr(cam), ptr(proj),
            ptr(out), B, H, W, d_lo, P, device=cam.device)
    return out


def band_cost(sxy: torch.Tensor, stats, out: torch.Tensor, out_lo: int,
              D: int, d_lo: int, k: int, eps: float) -> None:
    """Cost planes d_lo .. d_lo + P - 1 from their window sums ``sxy``
    ``[B, P, H, W]`` into plane ``d - out_lo`` of ``out``:
    ``(sxy - sx sy / k^2 + eps) * rsqrt(ex2 ey2 + eps)`` (forward_banded),
    the projector statistics on the columns widened left by D."""
    cam_s, cam_e2, proj_s, proj_e2 = stats
    B, P, H, W = sxy.shape
    k2 = float(k * k)
    if not _cuda(sxy):
        for j in range(P):
            d = d_lo + j
            sy = proj_s[..., D - d:D - d + W]
            ey2 = proj_e2[..., D - d:D - d + W]
            exy = sxy[:, j] - cam_s * sy / k2
            out[:, d - out_lo] = (exy + eps) * torch.rsqrt(cam_e2 * ey2
                                                           + eps)
        return
    _launch("band_cost", ptr(sxy), ptr(cam_s),
            ptr(cam_e2), ptr(proj_s), ptr(proj_e2), ptr(out), out.shape[1],
            out_lo, B, H, W, D, d_lo, P, k2, float(eps), device=sxy.device)


def online_head(cost: torch.Tensor, cost_lo: int, state: torch.Tensor,
                maps: torch.Tensor, d_lo: int, P: int, beta: float,
                threshold: float, unnormalized: bool, first: bool,
                last: bool, residuals: bool) -> None:
    """K3's head over planes d_lo .. d_lo + P - 1 of ``cost`` (plane d at
    index d - cost_lo), carried in ``state`` ``[4, B, H, W]`` (the maximum
    cost m, its first argmax, s and t) across slabs in plane order; the
    last slab writes ``maps`` ``[7, B, H, W]``: disparity, soft, mask,
    conf, and with ``residuals`` am, s, t (s and t raw, or relative to
    e^{beta m} where ``unnormalized`` is false, as ``head_residuals``)."""
    B, _, H, W = cost.shape
    if not _cuda(cost):
        m, am, s, t = (state if not first else
                       torch.stack([torch.full_like(cost[:, 0], -torch.inf),
                                    *torch.zeros_like(state[:3])])).clone()
        mb = beta * m
        for j in range(P):
            d = d_lo + j
            c = cost[:, d - cost_lo]
            bc = c * beta
            if unnormalized:
                u = torch.exp(bc)
                s, t = s + u, t + u * d
                new = c > m
            else:
                new = c > m
                scale = torch.where(m == -torch.inf, torch.zeros_like(m),
                                    torch.exp(mb - torch.where(new, bc, mb)))
                e = torch.exp(bc - mb)
                s = torch.where(new, s * scale + 1.0, s + e)
                t = torch.where(new, t * scale + d, t + e * d)
                mb = torch.where(new, bc, mb)
            m = torch.where(new, c, m)
            am = torch.where(new, torch.full_like(am, float(d)), am)
        if not last:
            state.copy_(torch.stack([m, am, s, t]))
            return
        mk = (m > threshold).to(m.dtype)
        maps[0], maps[1], maps[2], maps[3] = am * mk, (t / s) * mk, mk, m
        if residuals:
            maps[4], maps[5], maps[6] = am, s, t
        return
    res = (maps[4], maps[5], maps[6]) if residuals else (None,) * 3
    _launch("online_head", ptr(cost),
            cost.shape[1], cost_lo, ptr(state), *(ptr(m) for m in maps[:4]),
            *(_p(r) for r in res), B, H, W, d_lo, P, float(beta),
            float(threshold), int(unnormalized), int(first), int(last),
            device=cost.device)


def grad_fields(cost: torch.Tensor, cost_lo: int, g_vol, head, stats,
                gr: torch.Tensor, bm: torch.Tensor, grmu: torch.Tensor,
                D: int, d_lo: int, k: int, eps: float, first: bool) -> None:
    """The camera VJP's fields over planes d_lo .. d_lo + P - 1:
    ``gr[:, j] = g r`` and, continued in plane order, ``bm += g c r^2
    ey2``, ``grmu += gr sy / k^2``.  g is plane d of the plane-major
    ``g_vol``, or (``g_vol`` None) formed from ``head`` = (am, mask, conf,
    s, t, gsoft, gconf, beta, unnormalized) as ``head_cotangent`` does."""
    _, cam_e2, proj_s, proj_e2 = stats
    B, P, H, W = gr.shape
    k2 = float(k * k)
    if not _cuda(gr):
        b_acc = torch.zeros_like(bm) if first else bm.clone()
        m_acc = torch.zeros_like(grmu) if first else grmu.clone()
        if g_vol is None:
            am, mask, conf, s, t, gsoft, gconf, beta, unnorm = head
            inv_s = 1.0 / s
            tos = t * inv_s
            gs = gsoft * mask * beta
        for j in range(P):
            d = d_lo + j
            c = cost[:, d - cost_lo]
            if g_vol is not None:
                g = g_vol[:, d]
            else:
                arg = beta * c if unnorm else beta * (c - conf)
                w = torch.exp(arg) * inv_s
                g = gs * w * (d - tos) + gconf * (am == d).to(c.dtype)
            sy = proj_s[..., D - d:D - d + W]
            ey2 = proj_e2[..., D - d:D - d + W]
            r = torch.rsqrt(cam_e2 * ey2 + eps)
            gr[:, j] = g * r
            b_acc = b_acc + g * c * (r * r) * ey2
            m_acc = m_acc + gr[:, j] * (sy / k2)
        bm.copy_(b_acc)
        grmu.copy_(m_acc)
        return
    if g_vol is None:
        am, mask, conf, s, t, gsoft, gconf, beta, unnorm = head
        maps = (am, mask, conf, s, t, gsoft, gconf)
    else:
        maps, beta, unnorm = (None,) * 7, 1.0, False
    _launch("grad_fields", ptr(cost),
            cost.shape[1], cost_lo, _p(g_vol), *(_p(m) for m in maps),
            ptr(cam_e2), ptr(proj_s), ptr(proj_e2), ptr(gr), ptr(bm),
            ptr(grmu), B, H, W, D, d_lo, P, k2, float(eps), float(beta),
            int(unnorm), int(first), device=gr.device)


def grad_a1(box: torch.Tensor, proj: torch.Tensor, a1: torch.Tensor,
            d_lo: int, first: bool) -> None:
    """``a1 += sum_j box[:, j] proj(x - d)`` over the slab's planes in
    order (from zero where ``first``)."""
    B, P, H, W = box.shape
    if not _cuda(box):
        acc = torch.zeros_like(a1) if first else a1.clone()
        for j in range(P):
            acc = acc + box[:, j] * F.pad(proj, (d_lo + j, 0))[..., :W]
        a1.copy_(acc)
        return
    _launch("grad_a1", ptr(box), ptr(proj), ptr(a1), B,
            H, W, d_lo, P, int(first), device=box.device)


def grad_stack(bm: torch.Tensor, grmu: torch.Tensor, cam_s: torch.Tensor,
               k: int) -> torch.Tensor:
    """``[3, B, H, W]``: GRMU, B mux (mux = sx / k^2) and B, the three maps
    the combine box-filters."""
    k2 = float(k * k)
    if not _cuda(bm):
        return torch.stack([grmu, bm * (cam_s / k2), bm])
    out = bm.new_empty((3,) + tuple(bm.shape))
    _launch("grad_stack", ptr(bm), ptr(grmu),
            ptr(cam_s), ptr(out), bm.numel(), k2, device=bm.device)
    return out


def grad_combine(a1: torch.Tensor, boxes: torch.Tensor, cam: torch.Tensor
                 ) -> torch.Tensor:
    """``a1 - box(GRMU) + box(B mux) - cam box(B)`` (``boxes`` [3, ...])."""
    if not _cuda(a1):
        return a1 - boxes[0] + boxes[1] - cam * boxes[2]
    out = torch.empty_like(a1)
    _launch("grad_combine", ptr(a1), ptr(boxes),
            ptr(cam), ptr(out), a1.numel(), device=a1.device)
    return out


def _projector_columns(f: torch.Tensor, d: int, p: int) -> torch.Tensor:
    """``[B, H, W + p]``: camera map ``f`` at column w = e - p + d for each
    extended projector column e, zero where w lies outside the image."""
    W = f.shape[-1]
    s = d - p
    a = max(-s, 0)
    # Right pad d = s + p: the last column read, s + W + p - 1, may lie
    # past the image by more than W (d > W + p).
    return F.pad(f, (a, d))[..., s + a:s + a + W + p]


def proj_fields(cost: torch.Tensor, g: torch.Tensor, cam_stats,
                proj_e2e: torch.Tensor, gr: torch.Tensor, z2: torch.Tensor,
                z3: torch.Tensor, D: int, p: int, d_lo: int, k: int,
                eps: float, first: bool) -> None:
    """K7's fields on the extended projector columns e = x + p, x in
    [-p, W): with w = x + d the camera column (zero outside the image),
    ``gr[:, j] = g~ r``, r = rsqrt(ex2~ ey2e + eps), and in plane order
    ``z2 += gr sx~ / k^2``, ``z3 += g~ c~ r^2 ex2~``
    (``projector_grad_banded``)."""
    cam_s, cam_e2 = cam_stats
    B, P, H, We = gr.shape
    W = We - p
    k2 = float(k * k)
    if not _cuda(gr):
        a = torch.zeros_like(z2) if first else z2.clone()
        c3 = torch.zeros_like(z3) if first else z3.clone()
        for j in range(P):
            d = d_lo + j
            gs = _projector_columns(g[:, d], d, p)
            cs = _projector_columns(cost[:, d], d, p)
            ex2 = _projector_columns(cam_e2, d, p)
            mux = _projector_columns(cam_s / k2, d, p)
            r = torch.rsqrt(ex2 * proj_e2e + eps)
            gr[:, j] = gs * r
            a = a + gr[:, j] * mux
            c3 = c3 + gs * cs * (r * r) * ex2
        z2.copy_(a)
        z3.copy_(c3)
        return
    _launch("proj_fields", ptr(cost), ptr(g),
            ptr(cam_s), ptr(cam_e2), ptr(proj_e2e), ptr(gr), ptr(z2),
            ptr(z3), B, H, W, D, p, d_lo, P, k2, float(eps), int(first),
            device=gr.device)


def proj_a1(box: torch.Tensor, cam: torch.Tensor, a1p: torch.Tensor,
            p: int, d_lo: int, first: bool) -> None:
    """``a1p += sum_j cam~ box[:, j]`` over the slab's planes in order, cam~
    the camera at column e - p + d (zero outside)."""
    B, P, H, We = box.shape
    if not _cuda(box):
        acc = torch.zeros_like(a1p) if first else a1p.clone()
        for j in range(P):
            acc = acc + _projector_columns(cam, d_lo + j, p) * box[:, j]
        a1p.copy_(acc)
        return
    _launch("proj_a1", ptr(box), ptr(cam), ptr(a1p), B,
            H, We - p, p, d_lo, P, int(first), device=box.device)


def proj_stack(z2: torch.Tensor, z3: torch.Tensor, proj_se: torch.Tensor,
               k: int) -> torch.Tensor:
    """``[3, B, H, W + p]``: z2, sy~ / k^2 z3 and z3."""
    k2 = float(k * k)
    if not _cuda(z2):
        return torch.stack([z2, proj_se / k2 * z3, z3])
    out = z2.new_empty((3,) + tuple(z2.shape))
    _launch("proj_stack", ptr(z2), ptr(z3),
            ptr(proj_se), ptr(out), z2.numel(), k2, device=z2.device)
    return out


def proj_combine(a1p: torch.Tensor, boxes: torch.Tensor,
                 proj: torch.Tensor, p: int) -> torch.Tensor:
    """``a1p - box(z2) - proj box(z3) + box(sy~ z3 / k^2)``, each read at
    e = x + p: the ``[B, H, W]`` projector gradient."""
    if not _cuda(a1p):
        return (a1p[..., p:] - boxes[0][..., p:]
                - proj * boxes[2][..., p:] + boxes[1][..., p:])
    B, H, W = proj.shape
    out = torch.empty_like(proj)
    _launch("proj_combine", ptr(a1p), ptr(boxes),
            ptr(proj), ptr(out), B, H, W, p, device=proj.device)
    return out


def row_products(cam: torch.Tensor, proj: torch.Tensor, k: int,
                 out: torch.Tensor) -> torch.Tensor:
    """``out[b, h, x, y] = sum_j cam[b, h, x + j - p] proj[b, h, y + j -
    p]`` (zero outside the row), j from 0: ``_allpairs_cross`` before its
    row box.  ``out`` ``[B, H, W, W]``."""
    B, H, W = cam.shape
    if not _cuda(cam):
        from custereomatching_tpu_torch.ops.zncc import _hankel_cols
        hc, hp = _hankel_cols(cam, k), _hankel_cols(proj, k)
        g = hc[..., :, None, 0] * hp[..., None, :, 0]
        for j in range(1, k):
            g += hc[..., :, None, j] * hp[..., None, :, j]
        return out.copy_(g)
    _launch("row_products", ptr(cam), ptr(proj),
            ptr(out), B, H, W, k, device=cam.device)
    return out


def allpairs_cost(a: torch.Tensor, stats, k: int, eps: float,
                  out: torch.Tensor) -> torch.Tensor:
    """``(a - sx sy / k^2 + eps) * rsqrt(ex2 ey2 + eps)`` over ``[B, H, W,
    W]`` (forward_allpairs), into ``out``."""
    cam_s, cam_e2, proj_s, proj_e2 = stats
    B, H, W, _ = a.shape
    k2 = float(k * k)
    if not _cuda(a):
        exy = a - cam_s[..., :, None] * proj_s[..., None, :] / k2
        return out.copy_((exy + eps) * torch.rsqrt(
            cam_e2[..., :, None] * proj_e2[..., None, :] + eps))
    _launch("allpairs_cost", ptr(a), ptr(cam_s),
            ptr(cam_e2), ptr(proj_s), ptr(proj_e2), ptr(out), B, H, W, k2,
            float(eps), device=a.device)
    return out


# ---------------------------------------------------------------------------
# The routes
# ---------------------------------------------------------------------------

def banded_stats(camera: torch.Tensor, projector: torch.Tensor, D: int,
                 k: int):
    """(sx, ex2) of the camera ``[B, H, W]`` and (sy, ey2) of the projector
    widened left by D zero columns ``[B, H, W + D]``."""
    return moments(camera, k) + moments(projector, k, D)


class _Slabs:
    """Scratch of the slab loop (``kernel_model.large_k_scratch``), each
    buffer ``[B, COST_CHUNK, H, width]`` at most, viewed at a slab's
    planes: ``a`` and ``b`` for products (or gr) and their row sums, and
    where the route recomputes the costs a third, ``c``, for a slab of
    them."""

    def __init__(self, like: torch.Tensor, kernel: str, D: int, k: int):
        B, H, W = like.shape
        size = large_k_scratch(kernel, H, W, D, k)
        self.shape = (B, H, size["width"])
        n = B * size["planes"] * H * size["width"]
        bufs = like.new_empty((size["buffers"], n)).unbind(0)
        self.a, self.b = bufs[:2]
        self.c = bufs[2] if size["buffers"] > 2 else None

    def view(self, buf: torch.Tensor, P: int) -> torch.Tensor:
        B, H, W = self.shape
        return buf[:B * P * H * W].view(B, P, H, W)

    def box(self, x: torch.Tensor, k: int) -> torch.Tensor:
        """box2d of each plane of ``x`` (a view of ``a``), rows pass in
        ``b``, result in ``a``."""
        B, P, H, W = x.shape
        tmp = self.view(self.b, P).view(B * P, H, W)
        box_axis(x.view(B * P, H, W), k, 0, tmp)
        return box_axis(tmp, k, 1, x.view(B * P, H, W)).view(B, P, H, W)


def _cost_planes(camera, projector, stats, D, k, eps, scratch: _Slabs,
                 lo: int, P: int, out: torch.Tensor, out_lo: int) -> None:
    """K1's cost planes lo .. lo + P - 1 into ``out`` (plane d at d -
    out_lo): products, box2d, normalisation."""
    prod = band_products(camera, projector, lo, P, scratch.view(scratch.a, P))
    band_cost(scratch.box(prod, k), stats, out, out_lo, D, lo, k, eps)


def banded_volume_large(camera: torch.Tensor, projector: torch.Tensor,
                        D: int, k: int, eps: float) -> torch.Tensor:
    """K1 on the large-k route: the plane-major volume ``[B, D+1, H, W]``
    of ``forward_banded``, a slab of planes at a time."""
    COUNTS["route.K1"] += 1
    camera, projector = _dense(camera, projector)
    B, H, W = camera.shape
    stats = banded_stats(camera, projector, D, k)
    out = camera.new_empty((B, D + 1, H, W))
    scratch = _Slabs(camera, "K1", D, k)
    for lo, hi in cost_slabs(D):
        _cost_planes(camera, projector, stats, D, k, eps, scratch, lo,
                     hi - lo + 1, out, 0)
    return out


def fused_pipeline_large(camera: torch.Tensor, projector: torch.Tensor,
                         D: int, k: int, eps: float, beta: float,
                         threshold: float, unnormalized: bool,
                         residuals: bool = False, volume: bool = False
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K3 (and with ``residuals`` K3m, with ``volume`` too K3w) on the
    large-k route: K1's cost planes a slab at a time (into the volume for
    K3w, else a slab), the head carried across the slabs.  Returns the
    maps ``[7, B, H, W]`` (disparity, soft, mask, conf, am, s, t; the last
    three only with ``residuals``) and the volume or None."""
    COUNTS["route.K3w" if volume else "route.K3m" if residuals
           else "route.K3"] += 1
    camera, projector = _dense(camera, projector)
    B, H, W = camera.shape
    stats = banded_stats(camera, projector, D, k)
    maps = camera.new_empty((7, B, H, W))
    state = camera.new_empty((4, B, H, W))
    vol = camera.new_empty((B, D + 1, H, W)) if volume else None
    scratch = _Slabs(camera, "K3w" if volume else "K3", D, k)
    slab = scratch.c
    parts = cost_slabs(D)
    for i, (lo, hi) in enumerate(parts):
        P = hi - lo + 1
        if volume:
            out, out_lo = vol, 0
        else:
            out, out_lo = scratch.view(slab, P), lo
        _cost_planes(camera, projector, stats, D, k, eps, scratch, lo, P,
                     out, out_lo)
        online_head(out, out_lo, state, maps, lo, P, beta, threshold,
                    unnormalized, i == 0, i == len(parts) - 1,
                    residuals or volume)
    return maps, vol


def camera_grad_large(camera: torch.Tensor, projector: torch.Tensor,
                      cost: Optional[torch.Tensor],
                      cotangent: Optional[torch.Tensor], D: int, k: int,
                      eps: float, head=None) -> torch.Tensor:
    """The camera VJP on the large-k route (``camera_grad_banded``): K2
    (the plane-major ``cost`` and ``cotangent``), K6 (``cost`` None: K1's
    planes recomputed a slab at a time), K4 (``head`` = (am, mask, conf,
    s, t, gsoft, gconf, beta, unnormalized) and ``cost``: the cotangent
    formed per plane) or K5 (``head``, ``cost`` None)."""
    if head is None:
        COUNTS["route.K2" if cost is not None else "route.K6"] += 1
    else:
        COUNTS["route.K4" if cost is not None else "route.K5"] += 1
    camera, projector, cost, cotangent = _dense(camera, projector, cost,
                                                cotangent)
    if head is not None:
        head = _dense(*head[:7]) + tuple(head[7:])
    B, H, W = camera.shape
    stats = banded_stats(camera, projector, D, k)
    a1, bm, grmu = camera.new_empty((3, B, H, W)).unbind(0)
    scratch = _Slabs(camera, "K2" if cost is not None else "K6", D, k)
    for i, (lo, hi) in enumerate(cost_slabs(D)):
        P = hi - lo + 1
        if cost is None:
            src, src_lo = scratch.view(scratch.c, P), lo
            _cost_planes(camera, projector, stats, D, k, eps, scratch, lo, P,
                         src, src_lo)
        else:
            src, src_lo = cost, 0
        gr = scratch.view(scratch.a, P)
        grad_fields(src, src_lo, cotangent, head, stats, gr, bm, grmu, D, lo,
                    k, eps, i == 0)
        grad_a1(scratch.box(gr, k), projector, a1, lo, i == 0)
    boxes = box2d_stack(grad_stack(bm, grmu, stats[0], k).flatten(0, 1), k)
    return grad_combine(a1, boxes.view(3, B, H, W), camera)


def projector_grad_large(camera: torch.Tensor, projector: torch.Tensor,
                         cost: torch.Tensor, cotangent: torch.Tensor, D: int,
                         k: int, eps: float) -> torch.Tensor:
    """K7 on the large-k route (``projector_grad_banded``): the camera's
    statistics and the projector's over the image widened left by p, the
    fields in projector columns a slab at a time, their boxes over the
    extended columns, then the combine."""
    COUNTS["route.K7"] += 1
    camera, projector, cost, cotangent = _dense(camera, projector, cost,
                                                cotangent)
    B, H, W = camera.shape
    p = k // 2
    cam_stats = moments(camera, k)
    proj_se, proj_e2e = moments(projector, k, p)
    a1p, z2, z3 = camera.new_empty((3, B, H, W + p)).unbind(0)
    scratch = _Slabs(camera, "K7", D, k)
    for i, (lo, hi) in enumerate(cost_slabs(D)):
        P = hi - lo + 1
        gr = scratch.view(scratch.a, P)
        proj_fields(cost, cotangent, cam_stats, proj_e2e, gr, z2, z3, D, p,
                    lo, k, eps, i == 0)
        proj_a1(scratch.box(gr, k), camera, a1p, p, lo, i == 0)
    boxes = box2d_stack(proj_stack(z2, z3, proj_se, k).flatten(0, 1), k)
    return proj_combine(a1p, boxes.view(3, B, H, W + p), projector, p)


def allpairs_volume_large(camera: torch.Tensor, projector: torch.Tensor,
                          k: int, eps: float):
    """K8 on the large-k route (``forward_allpairs``): the row products into
    the output, their windowed sum over k rows, then the normalisation
    back into the output.  Returns the ``[B, H, W, W]`` volume and the
    window statistics it was made from (``cam_s``, ``cam_e2``, ``proj_s``,
    ``proj_e2``, each ``[B, H, W]``), which K8b reads."""
    COUNTS["route.K8"] += 1
    camera, projector = _dense(camera, projector)
    B, H, W = camera.shape
    stats = moments(camera, k) + moments(projector, k)
    out = camera.new_empty((B, H, W, W))
    row_products(camera, projector, k, out)
    rows = box_axis(out.view(B, H, W * W), k, 0).view(B, H, W, W)
    return allpairs_cost(rows, stats, k, eps, out), stats
