"""Synthetic inspection scenes, made on the device from a generator.

The benchmark's own copy of the port's ``data/synthetic.py`` generator
(``generate_detection_image``), laid out for large images and made in a few
large calls on the card: a smooth background colour with a lighting plane,
small elliptical defects of classes 1 and 2 (2-7 px across) and
background-labelled clutter speckle, and sensor noise N(0, 12). The
appearance constants are the generator's. Defects sit one to a 64 x 64
cell with probability ``defect_share``, in its upper half; clutter in its
lower half, so no clutter touches a defect, as the generator's moat rule
has it. A grayscale scene is the mean of the RGB scene's channels before
the noise.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_BACKGROUND = (44.0, 110.0, 44.0)
_SHIFT = {1: (34.0, -10.0, 2.0), 2: (46.0, -42.0, 6.0)}
_CLUTTER = (16.0, -5.0, 1.0)
_CELL = 64


def _uniform(gen, size, lo, hi, device):
    return lo + (hi - lo) * torch.rand(size, generator=gen, device=device)


def make_scenes(gen: torch.Generator, n: int, height: int, width: int, channels: int,
                defect_share: float = 0.25) -> Tuple[np.ndarray, np.ndarray]:
    """n scenes: (images uint8 [n, H, W, channels], labels uint16 [n, H, W])
    on the host, drawn on the generator's device."""
    device = gen.device
    cy, cx = -(-height // _CELL), -(-width // _CELL)
    y = torch.arange(height, device=device, dtype=torch.float32)
    x = torch.arange(width, device=device, dtype=torch.float32)
    iy, ix = (y // _CELL).long(), (x // _CELL).long()
    ry_cell = y[:, None] - (iy * _CELL).float()[:, None]  # row inside the cell
    rx_cell = x[None, :] - (ix * _CELL).float()[None, :]
    shift = torch.tensor([_SHIFT[1], _SHIFT[2]], device=device)
    images = torch.empty((n, height, width, channels), dtype=torch.uint8, device=device)
    labels = torch.empty((n, height, width), dtype=torch.int32, device=device)
    for i in range(n):
        # per cell: defect present, class, centre, radii, colour jitter
        present = torch.rand((cy, cx), generator=gen, device=device) < defect_share
        cls = 1 + (torch.rand((cy, cx), generator=gen, device=device) < 0.5).long()
        radii = _uniform(gen, (2, cy, cx), 1.2, 3.5, device)
        centre_y = _uniform(gen, (cy, cx), 8.0, 24.0, device)
        centre_x = _uniform(gen, (cy, cx), 8.0, 56.0, device)
        jitter = _uniform(gen, (cy, cx, 3), -10.0, 10.0, device)
        c_radii = _uniform(gen, (2, cy, cx), 0.8, 2.2, device)
        c_y = _uniform(gen, (cy, cx), 40.0, 56.0, device)
        c_x = _uniform(gen, (cy, cx), 8.0, 56.0, device)
        c_jitter = _uniform(gen, (cy, cx, 3), -6.0, 6.0, device)

        def cell(t):  # a per-cell map -> per pixel
            return t[iy[:, None], ix[None, :]]

        inside = (((ry_cell - cell(centre_y)) / cell(radii[0])) ** 2
                  + ((rx_cell - cell(centre_x)) / cell(radii[1])) ** 2) <= 1.0
        defect = inside & cell(present)
        clutter = (((ry_cell - cell(c_y)) / cell(c_radii[0])) ** 2
                   + ((rx_cell - cell(c_x)) / cell(c_radii[1])) ** 2) <= 1.0
        label = torch.where(defect, cell(cls), 0)

        base = torch.tensor(_BACKGROUND, device=device) + _uniform(gen, (3,), -12, 12, device)
        g = _uniform(gen, (2,), -20.0, 20.0, device)
        light = (y[:, None] / height - 0.5) * g[0] + (x[None, :] / width - 0.5) * g[1]
        img = base + light[..., None]
        img = img + torch.where(defect[..., None],
                                shift[(cell(cls) - 1).clamp(0, 1)] + cell(jitter), 0.0)
        img = img + torch.where(clutter[..., None],
                                torch.tensor(_CLUTTER, device=device) + cell(c_jitter), 0.0)
        if channels == 1:
            img = img.mean(dim=-1, keepdim=True)
        img = img + 12.0 * torch.randn(img.shape, generator=gen, device=device)
        images[i] = img.clamp_(0, 255).to(torch.uint8)
        labels[i] = label
    return images.cpu().numpy(), labels.cpu().numpy().astype(np.uint16)
