"""Weights from the seed, made on the device in one large call.

``train_tree``: a fresh training net's parameters, {"block/conv": HWIO,
"block/bnX/gamma", "block/bnX/beta", "head/w", "head/b"}, numpy f32:
He-normal kernels, gamma 1, beta 0, head bias 0.

Both sides of the comparison, the program and the reference, get these
same arrays.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from perfbench import roofline


def _kernels(config: Dict):
    """(name, HWIO shape) of every conv before the head."""
    for name, taps, cin, cout, _level in roofline.conv_layers(config):
        if name != "head":
            side = 2 if name.endswith("/up") else 3
            yield name, (side, side, cin, cout)


def _draw(gen: torch.Generator, config: Dict):
    """[(name, He-normal kernel)], the head's kernel and one flat normal
    draw, one uniform draw for the rest."""
    shapes = list(_kernels(config))
    w0, k = roofline.width(config, 0), config["class_count"]
    sizes = [int(np.prod(s)) for _n, s in shapes] + [w0 * k]
    normal = torch.randn(sum(sizes), generator=gen, device=gen.device).cpu().numpy()
    out, at = [], 0
    for (name, shape), size in zip(shapes + [("head", (1, 1, w0, k))], sizes):
        fan_in = shape[0] * shape[1] * shape[2]
        out.append((name, normal[at:at + size].reshape(shape) * np.float32((2.0 / fan_in) ** 0.5)))
        at += size
    return out


def train_tree(gen: torch.Generator, config: Dict) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    kernels = _draw(gen, config)
    for name, w in kernels[:-1]:
        block, conv = name.split("/")
        bn = "bnu" if conv == "up" else conv.replace("conv", "bn")
        c = w.shape[-1]
        out[name] = w.astype(np.float32)
        out[f"{block}/{bn}/gamma"] = np.ones(c, np.float32)
        out[f"{block}/{bn}/beta"] = np.zeros(c, np.float32)
    out["head/w"] = kernels[-1][1].astype(np.float32)
    out["head/b"] = np.zeros(config["class_count"], np.float32)
    return out
