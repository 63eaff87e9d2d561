"""The U-Net's shapes, counts and weights, from its configuration file.

The benchmark's own arithmetic, written against ``perfbench/configs`` and
not against the program (as ``perfbench/roofline.py`` is for annonet's
net): the counts depend on the shapes alone, whatever implements them.

  * ``conv_layers``: every conv of the net, the transpose convs and the 1x1
    head included, in forward order;
  * ``flop_per_pixel``: the forward's FLOP per input pixel (1,470,208 at
    the published widths and 3 classes);
  * ``bn_channels_per_pixel`` and ``bn_relu_bound_ms``: the batch norm +
    ReLU op's byte bound, a frozen copy of ``chip_smoke.py``'s
    ``bn_relu_bound`` arithmetic (each unit's values read and written in
    bf16: two passes forward, h in and y out, three backward, h and dy in
    and dh out, at 3.35 TB/s);
  * ``train_tree``: a fresh training net's parameters from a generator,
    both sides of the comparison getting the same arrays.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # one H100 SXM, NVIDIA's data sheet
BN_RELU_PASSES = 5  # forward 2, backward 3


def width(config: Dict, level: int) -> int:
    """Filters at level ``level``: base_width * 2**level, scaled, at least
    min_filter_count (the widths double at every level)."""
    return max(config["min_filter_count"],
               int(round(config["base_width"] * 2 ** level * config["width_scaler"])))


def conv_layers(config: Dict) -> Iterator[Tuple[str, int, int, int, int]]:
    """(name, taps, cin, cout, output level) of every conv, in forward
    order. A transpose conv's taps count 1: each output pixel takes one of
    its four taps. The decoder's conv0 reads the concat [up, skip]."""
    levels = config["level_count"]
    w0 = width(config, 0)
    yield "stem/conv0", 9, 1 if config["grayscale"] else 3, w0, 0
    yield "stem/conv1", 9, w0, w0, 0
    for i in range(1, levels + 1):
        cin, cout = width(config, i - 1), width(config, i)
        yield f"enc{i}/conv0", 9, cin, cout, i
        yield f"enc{i}/conv1", 9, cout, cout, i
    for i in range(levels, 0, -1):
        cin, cout = width(config, i), width(config, i - 1)
        yield f"dec{i}/up", 1, cin, cout, i - 1
        yield f"dec{i}/conv0", 9, 2 * cout, cout, i - 1
        yield f"dec{i}/conv1", 9, cout, cout, i - 1
    yield "head", 1, w0, config["class_count"], 0


def flop_per_pixel(config: Dict) -> float:
    """Forward FLOP per input pixel: 2 per multiply-add, every conv's
    output pixels at its level's resolution (4**-level per input pixel)."""
    return sum(2.0 * taps * cin * cout / 4 ** level
               for _name, taps, cin, cout, level in conv_layers(config))


def step_flop(config: Dict, pixels: int) -> float:
    """A training step's FLOP: forward, and a backward of twice the
    forward, over ``pixels`` input pixels."""
    return 3.0 * flop_per_pixel(config) * pixels


def bn_channels_per_pixel(config: Dict) -> float:
    """The batch norm units' channels per input pixel: one unit after each
    3x3 conv (none after the transpose convs)."""
    return sum(cout / 4 ** level for name, taps, _cin, cout, level in conv_layers(config)
               if taps == 9)


def bn_relu_bound_ms(config: Dict, pixels: int, element_bytes: int = 2) -> float:
    """The op's byte bound a step, ms: every unit's values, five passes."""
    values = bn_channels_per_pixel(config) * pixels
    return BN_RELU_PASSES * values * element_bytes / HBM_BYTES_PER_S * 1e3


def train_tree(gen: torch.Generator, config: Dict) -> Dict[str, np.ndarray]:
    """{"block/convX": HWIO, "block/bnX/gamma", "/beta", "decI/up" (HWIO),
    "decI/up_bias", "head/w", "head/b"}, numpy f32: He-normal kernels from
    one flat normal draw on the generator's device, gamma 1, beta 0,
    biases 0."""
    shapes = []
    for name, taps, cin, cout, _level in conv_layers(config):
        side = 1 if name == "head" else (2 if name.endswith("/up") else 3)
        shapes.append((name, (side, side, cin, cout)))
    sizes = [int(np.prod(s)) for _n, s in shapes]
    normal = torch.randn(sum(sizes), generator=gen, device=gen.device).cpu().numpy()
    out: Dict[str, np.ndarray] = {}
    at = 0
    for (name, shape), size in zip(shapes, sizes):
        fan_in = shape[0] * shape[1] * shape[2]
        w = (normal[at:at + size].reshape(shape) * np.float32((2.0 / fan_in) ** 0.5))
        at += size
        c = shape[-1]
        if name == "head":
            out["head/w"], out["head/b"] = w.astype(np.float32), np.zeros(c, np.float32)
        elif name.endswith("/up"):
            out[name] = w.astype(np.float32)
            out[f"{name}_bias"] = np.zeros(c, np.float32)
        else:
            block, conv = name.split("/")
            out[name] = w.astype(np.float32)
            out[f"{block}/{conv.replace('conv', 'bn')}/gamma"] = np.ones(c, np.float32)
            out[f"{block}/{conv.replace('conv', 'bn')}/beta"] = np.zeros(c, np.float32)
    return out


# the kernels of the device trace that the readers count, by name: the
# convolutions' (cuDNN's implicit GEMMs forward, data and weight gradient,
# their split-K reductions; the transpose convs run as data gradients), the
# batch norm + ReLU op's three (csrc/bn_relu.cu) and the max pools'
CONV_KERNELS = re.compile(r"conv|fprop|dgrad|wgrad|xmma|cutlass|gemm|splitk", re.IGNORECASE)
BN_RELU_KERNELS = ("bn_reduce_kernel", "bn_relu_apply_kernel", "bn_relu_grad_kernel")
POOL_KERNELS = re.compile(r"max_pool", re.IGNORECASE)


def kernel_seconds(trace, match) -> float:
    """The device seconds of the trace's kernels whose name ``match`` (a
    predicate on the name) accepts."""
    return sum(d for cat, name, _t, d in trace.device if cat == "kernel" and match(name))
