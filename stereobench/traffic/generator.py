"""The one generator of the benchmark's inputs: seeded speckle scenes.

A frozen copy of the arithmetic of ``data/synthetic.py`` in the port
(a random-dot projector pattern blurred by a small Gaussian and scaled to
a peak of 1; a camera view ``camera[y, x] = projector[y, x - d(y, x)]``
with linear interpolation and zeros left of the image), written in
PyTorch so that a whole batch of frames is made on the card in a few
large calls from one ``torch.Generator``.  Every scene is a slanted
disparity plane whose ends are drawn per frame from the configuration's
range; every seed gives frames of the same sizes, so the work of a run
does not depend on the seed, only the content does.

A mix file (``traffic/<mix>.json``) and a configuration file
(``configs/<config>.json``) hold every parameter; nothing here is
specific to one cell.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Scenes(NamedTuple):
    camera: torch.Tensor       # [n, H, W] rendered view, noise added
    projector: torch.Tensor    # [n, H, W] speckle pattern
    disparity: torch.Tensor    # [n, H, W] the scene's disparity


def generator(seed: int, device: torch.device,
              stream: int = 0) -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` (any whole number
    below 2**62) and a stream number, so that two uses of one seed draw
    independent numbers."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 8 + int(stream)) % (2 ** 63))
    return gen


def _blur_axis(x: torch.Tensor, taps: torch.Tensor, dim: int
               ) -> torch.Tensor:
    """Zero-padded ("same") convolution along ``dim`` with symmetric
    ``taps``, as shifted multiply-adds (deterministic, no TF32)."""
    r = (taps.numel() - 1) // 2
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = r
    z = x.new_zeros(shape)
    xp = torch.cat([z, x, z], dim=dim)
    out = xp.narrow(dim, 0, n) * taps[0]
    for t in range(1, taps.numel()):
        out += xp.narrow(dim, t, n) * taps[t]
    return out


def speckle(gen: torch.Generator, n: int, H: int, W: int, *,
            dot_density: float, dot_sigma: float) -> torch.Tensor:
    """``[n, H, W]`` random-dot patterns in [0, 1] (``speckle_pattern``)."""
    img = (torch.rand((n, H, W), generator=gen, device=gen.device)
           < dot_density).to(torch.float32)
    if dot_sigma > 0:
        radius = max(1, min(int(3 * dot_sigma), (min(H, W) - 1) // 2))
        x = torch.arange(-radius, radius + 1, dtype=torch.float32,
                         device=gen.device)
        g = torch.exp(-0.5 * (x / dot_sigma) ** 2)
        g = g / g.sum()
        img = _blur_axis(_blur_axis(img, g, 2), g, 1)
    peak = img.amax(dim=(1, 2), keepdim=True)
    return torch.where(peak > 0, img / peak.clamp_min(1e-30), img)


def render(projector: torch.Tensor, disparity: torch.Tensor) -> torch.Tensor:
    """``camera[y, x] = projector[y, x - d]``, linear between columns, zero
    where the source lies outside the image (``render_camera``)."""
    W = projector.shape[-1]
    xs = torch.arange(W, dtype=torch.float32,
                      device=projector.device) - disparity
    x0 = torch.floor(xs)
    frac = xs - x0
    x0 = x0.to(torch.int64)

    def sample(col):
        valid = (col >= 0) & (col < W)
        v = torch.gather(projector, -1, col.clamp(0, W - 1))
        return torch.where(valid, v, torch.zeros_like(v))

    return (1.0 - frac) * sample(x0) + frac * sample(x0 + 1)


def scenes(seed: int, n: int, H: int, W: int, scene: dict,
           device: torch.device) -> Scenes:
    """``n`` frames of ``H x W`` from ``seed``.  ``scene`` holds
    ``d_min`` and ``d_max`` (the range the planes' ends are drawn from),
    ``dot_density``, ``dot_sigma`` and ``noise`` (the camera's additive
    Gaussian noise)."""
    gen = generator(seed, device)
    proj = speckle(gen, n, H, W, dot_density=scene["dot_density"],
                   dot_sigma=scene["dot_sigma"])
    ends = torch.rand((n, 2), generator=gen, device=device)
    lo, hi = float(scene["d_min"]), float(scene["d_max"])
    ends = lo + (hi - lo) * ends
    ramp = torch.linspace(0.0, 1.0, W, device=device)
    disp = ends[:, :1] + (ends[:, 1:] - ends[:, :1]) * ramp     # [n, W]
    disp = disp[:, None, :].expand(n, H, W).contiguous()
    cam = render(proj, disp)
    noise = float(scene.get("noise", 0.0))
    if noise > 0:
        cam = cam + noise * torch.randn((n, H, W), generator=gen,
                                        device=device)
    return Scenes(camera=cam.contiguous(), projector=proj.contiguous(),
                  disparity=disp)


def perturbation(seed: int, shape, std: float,
                 device: torch.device) -> torch.Tensor:
    """Gaussian noise of ``std`` from the seed's second stream: the start
    of a camera optimisation is the rendered view plus this."""
    gen = generator(seed, device, stream=1)
    return std * torch.randn(tuple(shape), generator=gen, device=device)
