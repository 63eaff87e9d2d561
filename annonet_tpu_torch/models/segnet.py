"""SegmentationNet runtime (inference) net in PyTorch.

The port of ``annonet_tpu/models/segnet.py``: the architecture config and
its dimension queries (pure Python, copied), a numpy initializer for the
BN-folded runtime tree (He init plus the BN fold, so an artifact can be
written on a machine without JAX), the conversion of that tree to device
tensors laid out as the kernels take them, and ``RuntimeSegNet``, the
counterpart of ``apply_runtime``.

Layout: NHWC activations, HWIO conv weights ([kh, kw, cin, cout], the JAX
layout, which is also what the hand-written kernels read), f32 biases.
The stem, encoder and decoder convs run through the fused conv + bias +
ReLU kernels of ``ops/conv.py``; the input normalisation and the 1x1 head
stay plain torch, as the JAX package computes both outside any kernel.

Topology (``L = level_count``):
    stem:   conv3x3 -> ReLU, conv3x3 -> ReLU                     (width w0)
    enc i:  conv3x3 s2 -> ReLU, conv3x3 -> ReLU                  (width wi)
    dec i:  2x2 transpose-conv s2 -> ReLU, concat skip,
            conv3x3 -> ReLU                                      (width w(i-1))
    head:   conv1x1 -> class_count logits (f32)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from annonet_tpu_torch.ops.conv import (
    conv3x3_bias_relu,
    conv3x3_s2_bias_relu,
    up2x2_bias_relu,
)

Params = Dict[str, Any]

_BN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class SegNetConfig:
    """Architecture configuration (field for field the JAX package's, so
    an artifact's ``model_config`` reads into either package)."""

    class_count: int = 2
    level_count: int = 2
    width_scaler: float = 1.0
    min_filter_count: int = 1
    grayscale: bool = False
    base_width: int = 16
    compute_dtype: str = "bfloat16"

    @property
    def in_channels(self) -> int:
        return 1 if self.grayscale else 3

    def width(self, level: int) -> int:
        """Filter count at pyramid level ``level`` (0 = full resolution)."""
        base = self.base_width * (2 ** min(level, 3))
        return max(self.min_filter_count, int(round(base * self.width_scaler)))

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "SegNetConfig":
        return SegNetConfig(**d)


def required_input_dimension(config: SegNetConfig) -> int:
    """Worst-case receptive field of one output pixel, in input pixels.

    Propagates the influence interval of one input pixel through the op
    sequence (a stride-2 3x3 conv pads (0, 1), so output o taps inputs
    2o..2o+2; a 2x2 stride-2 transpose conv maps u to {2u, 2u+1}),
    maximized over the 2**level_count parity classes.
    """
    L = config.level_count

    def conv3_s1(lo, hi):
        return lo - 1, hi + 1

    def conv3_s2(lo, hi):
        return -(-(lo - 2) // 2), hi // 2

    def up2(lo, hi):
        return 2 * lo, 2 * hi + 1

    best = 1
    base = 4 ** (L + 2)  # keep all intermediate indices positive
    for parity in range(2**L):
        lo = hi = base + parity
        lo, hi = conv3_s1(lo, hi)  # stem conv0
        lo, hi = conv3_s1(lo, hi)  # stem conv1
        for _ in range(L):
            lo, hi = conv3_s2(lo, hi)  # encoder downsample conv
            lo, hi = conv3_s1(lo, hi)  # encoder conv
        for _ in range(L):
            lo, hi = up2(lo, hi)  # decoder transpose conv
            lo, hi = conv3_s1(lo, hi)  # decoder conv
        best = max(best, hi - lo + 1)
    return best


def recommended_input_dimension(config: SegNetConfig, requested: int) -> int:
    """Round ``requested`` up so spatial dims divide by 2**level_count."""
    align = 2 ** config.level_count
    d = max(int(requested), align)
    return ((d + align - 1) // align) * align


# --------------------------------------------------------------------------
# The runtime parameter tree
# --------------------------------------------------------------------------


def conv_layers(config: SegNetConfig) -> Iterator[Tuple[str, str, tuple]]:
    """(block, conv, HWIO weight shape) of every conv before the head, in
    forward order. The decoder conv's input is the concat [up, skip]."""
    L = config.level_count
    w0 = config.width(0)
    yield "stem", "conv0", (3, 3, config.in_channels, w0)
    yield "stem", "conv1", (3, 3, w0, w0)
    for i in range(1, L + 1):
        cin, cout = config.width(i - 1), config.width(i)
        yield f"enc{i}", "conv0", (3, 3, cin, cout)
        yield f"enc{i}", "conv1", (3, 3, cout, cout)
    for i in range(L, 0, -1):
        cin, cout = config.width(i), config.width(i - 1)
        yield f"dec{i}", "up", (2, 2, cin, cout)
        yield f"dec{i}", "conv0", (3, 3, 2 * cout, cout)


def runtime_param_shapes(config: SegNetConfig) -> Dict[str, tuple]:
    """{"block/conv/leaf": shape} of the BN-folded runtime tree: the keys
    (under "params/") and shapes an artifact must hold."""
    shapes = {}
    for block, conv, shape in conv_layers(config):
        shapes[f"{block}/{conv}/w"] = shape
        shapes[f"{block}/{conv}/b"] = (shape[-1],)
    shapes["head/w"] = (1, 1, config.width(0), config.class_count)
    shapes["head/b"] = (config.class_count,)
    return shapes


def init_runtime_params(config: SegNetConfig, seed: int) -> Params:
    """A BN-folded runtime tree in the JAX layout, made with numpy.

    He-normal conv weights (std sqrt(2 / fan_in), as ``init_state``) and
    batch-norm statistics of a trained net (gamma, beta, running mean and
    variance drawn around their identity values), folded exactly like
    ``fold_batchnorm``: w * gamma / sqrt(var + eps), beta - mean * scale.
    The draws differ from ``jax.random``'s; the layout and the fold are
    the same, so the tree saves into an artifact either package reads.
    """
    rng = np.random.default_rng(seed)
    tree: Params = {}
    for block, conv, (kh, kw, cin, cout) in conv_layers(config):
        std = (2.0 / (kh * kw * cin)) ** 0.5
        w = rng.standard_normal((kh, kw, cin, cout)).astype(np.float32) * std
        gamma = rng.uniform(0.5, 1.5, cout).astype(np.float32)
        beta = (rng.standard_normal(cout) * 0.1).astype(np.float32)
        mean = (rng.standard_normal(cout) * 0.1).astype(np.float32)
        var = rng.uniform(0.5, 1.5, cout).astype(np.float32)
        scale = gamma / np.sqrt(var + np.float32(_BN_EPS))
        tree.setdefault(block, {})[conv] = {
            "w": (w * scale).astype(np.float32),
            "b": (beta - mean * scale).astype(np.float32),
        }
    w0, k = config.width(0), config.class_count
    tree["head"] = {
        "w": (rng.standard_normal((1, 1, w0, k)) * (2.0 / w0) ** 0.5).astype(
            np.float32
        ),
        "b": (rng.standard_normal(k) * 0.1).astype(np.float32),
    }
    return tree


def compute_dtype(config: SegNetConfig) -> torch.dtype:
    if config.compute_dtype == "bfloat16":
        return torch.bfloat16
    if config.compute_dtype == "float32":
        return torch.float32
    raise ValueError(f"unsupported compute_dtype {config.compute_dtype!r}")


def runtime_params_from_numpy(
    tree: Params, config: SegNetConfig, device
) -> Dict[str, torch.Tensor]:
    """The JAX runtime tree (numpy HWIO weights, f32 biases, head {w, b})
    -> {"block/conv/leaf": tensor} on ``device``, laid out for the kernels:
    conv weights contiguous HWIO in the compute dtype, biases f32, the
    head weight as a [C, K] matrix in the compute dtype."""
    dtype = compute_dtype(config)
    device = torch.device(device)
    out: Dict[str, torch.Tensor] = {}
    for key, shape in runtime_param_shapes(config).items():
        node = tree
        for part in key.split("/"):
            node = node[part]
        value = np.asarray(node, dtype=np.float32)
        if value.shape != shape:
            raise ValueError(f"{key} has shape {value.shape}, expected {shape}")
        t = torch.tensor(value)  # a copy: the tree's arrays may be read-only
        if key == "head/w":
            t = t.reshape(shape[2], shape[3])
        is_weight = key.endswith("/w")
        t = t.to(device=device, dtype=dtype if is_weight else torch.float32)
        out[key] = t.contiguous()
    return out


def normalize_input(x_uint8: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """uint8 [N,H,W,C] -> centered values in the compute dtype: normalised
    in f32 first, then cast (segnet.py's _normalize_input)."""
    return (x_uint8.to(torch.float32) * (1.0 / 255.0) - 0.5).to(dtype)


class RuntimeSegNet(nn.Module):
    """Inference forward on BN-folded params: [N,H,W,C] uint8 ->
    [N,H,W,K] f32 logits (the counterpart of ``apply_runtime``)."""

    def __init__(self, runtime_params: Params, config: SegNetConfig, *, device):
        super().__init__()
        self.config = config
        self.dtype = compute_dtype(config)
        for key, t in runtime_params_from_numpy(
            runtime_params, config, device
        ).items():
            self.register_buffer(key.replace("/", "_"), t)

    def weights(self, block: str, conv: str) -> Tuple[torch.Tensor, torch.Tensor]:
        return getattr(self, f"{block}_{conv}_w"), getattr(self, f"{block}_{conv}_b")

    def check_input(self, x: torch.Tensor) -> None:
        cfg = self.config
        if x.dim() != 4 or x.shape[-1] != cfg.in_channels:
            raise ValueError(
                f"expected input [N,H,W,{cfg.in_channels}] "
                f"({'grayscale' if cfg.grayscale else 'RGB'}), got {tuple(x.shape)}"
            )
        align = 2**cfg.level_count
        if x.shape[1] % align or x.shape[2] % align:
            raise ValueError(
                f"input H,W {x.shape[1]}x{x.shape[2]} must be multiples of "
                f"{align} (= 2**level_count); round sizes up with "
                f"recommended_input_dimension()"
            )
        if x.dtype != torch.uint8:
            raise ValueError(f"expected uint8 input, got {x.dtype}")

    def forward(
        self, x_uint8: torch.Tensor,
        tap: Optional[Callable[[str, torch.Tensor], None]] = None,
    ) -> torch.Tensor:
        """``tap(name, activation)``, when given, sees each conv and up
        layer's post-ReLU output ("stem/conv0", ..., "dec1/up", ...): the
        int8 calibration reads its per-channel maxima there."""
        self.check_input(x_uint8)
        L = self.config.level_count

        def out(name, x):
            if tap is not None:
                tap(name, x)
            return x

        x = normalize_input(x_uint8, self.dtype)
        x = out("stem/conv0", conv3x3_bias_relu(x, *self.weights("stem", "conv0")))
        x = out("stem/conv1", conv3x3_bias_relu(x, *self.weights("stem", "conv1")))
        skips: List[torch.Tensor] = [x]
        for i in range(1, L + 1):
            x = out(f"enc{i}/conv0",
                    conv3x3_s2_bias_relu(x, *self.weights(f"enc{i}", "conv0")))
            x = out(f"enc{i}/conv1",
                    conv3x3_bias_relu(x, *self.weights(f"enc{i}", "conv1")))
            if i < L:
                skips.append(x)
        for i in range(L, 0, -1):
            x = out(f"dec{i}/up", up2x2_bias_relu(x, *self.weights(f"dec{i}", "up")))
            # the decoder's concat([up, skip]) is the kernel's second input
            x = out(f"dec{i}/conv0", conv3x3_bias_relu(
                x, *self.weights(f"dec{i}", "conv0"), x2=skips.pop()
            ))
        # head: compute-dtype product (f32 accumulation inside), then the
        # f32 bias promotes the logits to f32 (segnet.py:459-462)
        return torch.matmul(x, self.head_w).to(torch.float32) + self.head_b
