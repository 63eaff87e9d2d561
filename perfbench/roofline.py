"""The benchmark's own arithmetic of operations and peaks.

A frozen copy of how ``chip_smoke.py`` counts a net's operations
(``conv_bound``), written against the configuration files of
``perfbench/configs`` and not against the program: the counts depend on
the shapes alone, whatever implements them.

Peaks: one NVIDIA H100 SXM (80 GB HBM3), NVIDIA's data sheet, dense rates,
at the full 700 W power limit.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def width(config: Dict, level: int) -> int:
    """Filters at pyramid level ``level``: base_width * 2**min(level, 3),
    scaled, at least min_filter_count."""
    base = config["base_width"] * (2 ** min(level, 3))
    return max(config["min_filter_count"], int(round(base * config["width_scaler"])))


def in_channels(config: Dict) -> int:
    return 1 if config["grayscale"] else 3


def conv_layers(config: Dict) -> Iterator[Tuple[str, int, int, int, int]]:
    """(name, taps, cin, cout, output level) of every conv of the net, the
    1x1 head included, in forward order. The decoder's 3x3 conv reads the
    concat of the up layer's output and the skip."""
    levels = config["level_count"]
    w0 = width(config, 0)
    yield "stem/conv0", 9, in_channels(config), w0, 0
    yield "stem/conv1", 9, w0, w0, 0
    for i in range(1, levels + 1):
        cin, cout = width(config, i - 1), width(config, i)
        yield f"enc{i}/conv0", 9, cin, cout, i
        yield f"enc{i}/conv1", 9, cout, cout, i
    for i in range(levels, 0, -1):
        cin, cout = width(config, i), width(config, i - 1)
        yield f"dec{i}/up", 1, cin, cout, i - 1
        yield f"dec{i}/conv0", 9, 2 * cout, cout, i - 1
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
