"""The int8 inference net in PyTorch, unfolded.

The port of ``annonet_tpu/models/quantized_runtime.py``. The JAX package
quantizes its width-folded net (8 pixels x 16 channels in the TPU's 128
lanes); the fold only tiles per-channel vectors, so the same int8 weights,
scales and offsets apply to the plain NHWC net, and every int8 layer here
equals its folded counterpart bit for bit. The TPU lane artifacts are not
ported: the ``:pad4`` stem, the y-concat stem rewrite, the grayscale
``pad_input`` padding (it stays in the calibration layout as a zero-length
entry, so calibration files match) and the head-as-dot knob.

Scheme (symmetric static post-training quantization):
  * activations int8 in [0, 127] after each ReLU, one scale per channel,
    from per-channel maxima of the float net (calibration);
  * the input grid is exact: q = round(u * 254/255 - 127), scale 1/254;
  * each layer's input scales are folded into its weight rows before the
    per-output-channel weight scale is taken, so the decoder's concat of
    two differently scaled halves needs nothing but the weight rows;
  * each conv's epilogue is one requant ``fma(acc, scale, offset)``,
    clip [0, 127], truncation (ops/qconv.py); the ``up`` layers stay in
    the compute dtype with an int8 requant at their output (K3's requant
    mode), or, with ``quantize_up``, become int8 too (Q3), with weight
    scales per output-column parity and channel;
  * the head is an exact f32 product of the int8 activations and int8
    weights (width(0) * 127 * 127 < 2**24), then ``acc * s_w + b``.

Layer kernels: Q1 (stride-1 convs, the decoder's with the skip as a second
input), Q2 (stride-2 convs), K3's requant mode or Q3 (up layers); the
weights of Q1, Q2 and Q3 also packed once, as their tensor-core kernels
read them.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from annonet_tpu_torch.models.folded_runtime import folding_supported
from annonet_tpu_torch.models.segnet import (
    RuntimeSegNet,
    SegNetConfig,
    compute_dtype,
    require_segnet,
)
from annonet_tpu_torch.ops.conv import up2x2_requant
from annonet_tpu_torch.ops.qconv import (
    pack_q1_weights,
    pack_q3_weights,
    qconv3x3_requant,
    qconv3x3_s2_requant,
    qup2x2_requant,
)

# the exact input grid: q = round(a * 254) for a = u/255 - 0.5
INPUT_SCALE = 1.0 / 254.0


# the base fold of a plan, or 0 when its tile width does not fold: the JAX
# package runs int8 only on plans that fold and the float net on the
# others; the port keeps that rule, so the same images run int8 in both
int8_fold = folding_supported


def calibration_layout(config: SegNetConfig) -> List[Tuple[str, int]]:
    """(entry, vector length) of each calibration vector, in the JAX spec
    order (folded_runtime.fold_runtime_params): the grayscale ``pad_input``
    marker, each conv and up layer as ``block/conv`` with its output
    channel count, ``save_skip:i`` / ``concat_skip:i`` and the head; the
    bookkeeping entries and the head take zero-length vectors. This order
    makes calibration files interchangeable between the packages."""
    L = config.level_count
    w0 = config.width(0)
    layout: List[Tuple[str, int]] = []
    if config.grayscale:
        layout.append(("pad_input", 0))
    layout += [("stem/conv0", w0), ("stem/conv1", w0), ("save_skip:0", 0)]
    for i in range(1, L + 1):
        layout += [(f"enc{i}/conv0", config.width(i)),
                   (f"enc{i}/conv1", config.width(i))]
        if i < L:
            layout.append((f"save_skip:{i}", 0))
    for i in range(L, 0, -1):
        layout += [(f"dec{i}/up", config.width(i - 1)),
                   (f"concat_skip:{i - 1}", 0),
                   (f"dec{i}/conv0", config.width(i - 1))]
    layout.append(("head", 0))
    return layout


def collect_calibration(net: RuntimeSegNet, tiles_uint8: torch.Tensor) -> List[np.ndarray]:
    """Per-layer, per-channel post-ReLU maxima of the float net on a tile
    batch (f32 vectors in ``calibration_layout`` order, zero-length for the
    bookkeeping entries and the head), taken with a tap on the net's own
    forward, so the layers run through K1-K3."""
    maxima: Dict[str, np.ndarray] = {}

    def tap(name: str, x: torch.Tensor) -> None:
        maxima[name] = x.amax(dim=(0, 1, 2)).to(torch.float32).cpu().numpy()

    with torch.inference_mode():
        net(tiles_uint8, tap=tap)
    empty = np.zeros(0, np.float32)
    return [
        maxima[name] if length else empty
        for name, length in calibration_layout(net.config)
    ]


def _out_scale(cal):
    """(s_out, 1 / s_out) of a layer's per-channel maxima: the int8 grid
    [0, 127] spans [0, max]."""
    s_out = np.maximum(np.asarray(cal, np.float32), 1e-12) / 127.0
    return s_out, (1.0 / s_out).astype(np.float32)


def _weights(runtime_params, name: str):
    node = runtime_params
    for part in name.split("/"):
        node = node[part]
    return np.asarray(node["w"], np.float32), np.asarray(node["b"], np.float32)


def quantize_up_layer(w, s_in, inv, offset):
    """The int8 form of an ``up`` layer (int8_conv_mosaic.py:562-577,
    unfolded). The folded up kernel puts only ``w[q, 1-v]`` in output
    column ``2i+v`` (folded_runtime.py:105-122), so its weight scale is per
    column parity v and channel: returns (w_q [2,2,C,C'] int8,
    scale [2,C'] = s_w * inv, offset [2,C'])."""
    wf = np.asarray(w, np.float32) * np.asarray(s_in, np.float32)[None, None, :, None]
    # s_w[v, co] over the taps w[:, 1-v] that feed column parity v
    s_w = np.stack([
        np.maximum(np.max(np.abs(wf[:, 1 - v]), axis=(0, 1)) / 127.0, 1e-20)
        for v in range(2)
    ]).astype(np.float32)
    # tap w[:, kw] feeds column parity 1 - kw
    w_q = np.clip(np.rint(wf / s_w[::-1][None, :, None, :]), -127, 127)
    w_q = w_q.astype(np.int8)
    scale = (s_w * np.asarray(inv, np.float32)).astype(np.float32)
    return w_q, scale, np.stack([np.asarray(offset, np.float32)] * 2)


def quantize_net(
    runtime_params: Any,
    config: SegNetConfig,
    calibration,
    quantize_up: bool = False,
) -> Dict[str, Dict[str, np.ndarray]]:
    """Host-side (numpy, once per model and calibration) int8 parameters,
    the unfolded ``quantize_folded`` (quantized_runtime.py:161-289).

    Returns {layer: entry}: int8 convs {"w_q" int8 HWIO, "scale", "offset"
    [cout]}; ``up`` layers {"w" f32 HWIO, "s_in" [cin], "scale" (1/s_out),
    "offset" [cout]}, or with ``quantize_up`` {"w_q" int8, "scale",
    "offset" [2, cout]}; the head {"w_q" [C, K] int8, "s_w", "b" [K]}."""
    require_segnet(config, "int8 inference")
    layout = calibration_layout(config)
    if len(calibration) != len(layout):
        raise ValueError(
            f"calibration has {len(calibration)} layer vectors, model "
            f"expects {len(layout)} (wrong model?)"
        )
    for (name, length), cal in zip(layout, calibration):
        if np.shape(cal) != (length,):
            raise ValueError(
                f"calibration vector {name!r} has shape {np.shape(cal)}, "
                f"expected ({length},)"
            )
    # current activation scale per channel, carried through the skips
    s_cur = np.full(config.in_channels, INPUT_SCALE, np.float32)
    skip_scales: Dict[str, np.ndarray] = {}
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for (name, _length), cal in zip(layout, calibration):
        if name == "pad_input":
            continue
        if name.startswith("save_skip:"):
            skip_scales[name.split(":")[1]] = s_cur
            continue
        if name.startswith("concat_skip:"):
            s_cur = np.concatenate([s_cur, skip_scales[name.split(":")[1]]])
            continue
        w, b = _weights(runtime_params, name)
        if name.endswith("/up"):
            s_out, inv = _out_scale(cal)
            offset = b * inv + 0.5
            if quantize_up:
                w_q, scale, offset = quantize_up_layer(w, s_cur, inv, offset)
                out[name] = {"w_q": w_q, "scale": scale, "offset": offset}
            else:
                out[name] = {"w": w, "s_in": s_cur, "scale": inv, "offset": offset}
            s_cur = s_out
            continue
        # fold the input scales into the rows, per-output-channel scale
        w_scaled = w * s_cur[None, None, :, None]
        s_w = np.max(np.abs(w_scaled), axis=(0, 1, 2)) / 127.0
        s_w = np.maximum(s_w, 1e-20)
        w_q = np.clip(np.rint(w_scaled / s_w), -127, 127).astype(np.int8)
        if name == "head":
            out[name] = {"w_q": w_q[0, 0], "s_w": s_w, "b": b}
            continue
        s_out, inv = _out_scale(cal)
        out[name] = {"w_q": w_q, "scale": s_w * inv, "offset": b * inv + 0.5}
        s_cur = s_out
    return out


# float32(254 / 255): the input grid's slope
_INPUT_SLOPE = float(np.float32(254.0 / 255.0))


def quantize_input(x_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 [..., C] -> its int8 grid round(u * 254/255 - 127), rounded
    half to even, on the tensor's device (quantized_runtime.quantize_input,
    unfolded and unpadded). XLA fuses the multiply-add into an FMA; for
    every uint8 value the two roundings here give the same int8."""
    if x_uint8.dtype != torch.uint8:
        raise ValueError(f"quantize_input expects uint8, got {x_uint8.dtype}")
    return torch.round(x_uint8.to(torch.float32) * _INPUT_SLOPE - 127.0).to(torch.int8)


class QuantizedSegNet(nn.Module):
    """int8 inference forward: [N,H,W,C] int8 (``quantize_input``) ->
    [N,H,W,K] f32 logits (the counterpart of ``apply_folded_int8``)."""

    def __init__(self, qparams: Dict[str, Dict[str, np.ndarray]],
                 config: SegNetConfig, *, device):
        super().__init__()
        require_segnet(config, "int8 inference")
        self.config = config
        self.quantize_up = any(
            "w_q" in e for k, e in qparams.items() if k.endswith("/up")
        )
        dtype = compute_dtype(config)
        device = torch.device(device)
        self._names: Dict[str, List[str]] = {}
        for layer, entry in qparams.items():
            names = []
            for leaf, value in entry.items():
                t = torch.tensor(np.asarray(value))
                if layer == "head" and leaf == "w_q":
                    t = t.to(torch.float32)  # int8 values, exact in f32
                elif leaf == "w":
                    t = t.to(dtype)  # the up layer's compute-dtype weights
                elif t.dtype != torch.int8:
                    t = t.to(torch.float32)
                name = f"{layer.replace('/', '_')}_{leaf}"
                self.register_buffer(name, t.to(device).contiguous())
                names.append(name)
            self._names[layer] = names
        # the weights of Q1, Q2 and Q3 as their kernels read them, packed
        # once per layer
        for layer in self.q1_layers() + self.q2_layers():
            self.register_buffer(f"{layer.replace('/', '_')}_w_packed",
                                 pack_q1_weights(self._layer(layer)[0]))
        for layer in self.q3_layers():
            self.register_buffer(f"{layer.replace('/', '_')}_w_packed",
                                 pack_q3_weights(self._layer(layer)[0]))

    def q1_layers(self) -> List[str]:
        """The stride-1 int8 convs (Q1), in forward order."""
        L = self.config.level_count
        return (["stem/conv0", "stem/conv1"] + [f"enc{i}/conv1" for i in range(1, L + 1)]
                + [f"dec{i}/conv0" for i in range(L, 0, -1)])

    def q2_layers(self) -> List[str]:
        """The stride-2 int8 convs (Q2), in forward order."""
        return [f"enc{i}/conv0" for i in range(1, self.config.level_count + 1)]

    def q3_layers(self) -> List[str]:
        """The int8 up layers (Q3), in forward order: none without
        ``quantize_up``."""
        if not self.quantize_up:
            return []
        return [f"dec{i}/up" for i in range(self.config.level_count, 0, -1)]

    def _layer(self, layer: str):
        return [getattr(self, n) for n in self._names[layer]]

    def _packed(self, layer: str) -> torch.Tensor:
        return getattr(self, f"{layer.replace('/', '_')}_w_packed")

    def _q1(self, layer: str, x, x2=None):
        w_q, scale, offset = self._layer(layer)
        return qconv3x3_requant(x, w_q, scale, offset, x2=x2, packed=self._packed(layer))

    def _q2(self, layer: str, x):
        w_q, scale, offset = self._layer(layer)
        return qconv3x3_s2_requant(x, w_q, scale, offset, packed=self._packed(layer))

    def check_input(self, x: torch.Tensor) -> None:
        cfg = self.config
        if x.dim() != 4 or x.shape[-1] != cfg.in_channels or x.dtype != torch.int8:
            raise ValueError(
                f"expected int8 input [N,H,W,{cfg.in_channels}], got "
                f"{tuple(x.shape)} {x.dtype}"
            )
        align = 2**cfg.level_count
        if x.shape[1] % align or x.shape[2] % align:
            raise ValueError(
                f"input H,W {x.shape[1]}x{x.shape[2]} must be multiples of {align}"
            )

    def forward(
        self, x_q: torch.Tensor,
        tap: Optional[Callable[[str, torch.Tensor], None]] = None,
    ) -> torch.Tensor:
        self.check_input(x_q)
        L = self.config.level_count

        def out(name, x):
            if tap is not None:
                tap(name, x)
            return x

        x = out("stem/conv0", self._q1("stem/conv0", x_q))
        x = out("stem/conv1", self._q1("stem/conv1", x))
        skips: List[torch.Tensor] = [x]
        for i in range(1, L + 1):
            x = out(f"enc{i}/conv0", self._q2(f"enc{i}/conv0", x))
            x = out(f"enc{i}/conv1", self._q1(f"enc{i}/conv1", x))
            if i < L:
                skips.append(x)
        for i in range(L, 0, -1):
            up = self._layer(f"dec{i}/up")
            if self.quantize_up:
                x = qup2x2_requant(x, *up, packed=self._packed(f"dec{i}/up"))
            else:
                w, s_in, scale, offset = up
                x = up2x2_requant(x, s_in, w, scale, offset)
            x = out(f"dec{i}/up", x)
            # the decoder's concat([up, skip]) is Q1's second input
            x = out(f"dec{i}/conv0", self._q1(f"dec{i}/conv0", x, skips.pop()))
        w_q, s_w, b = self._layer("head")
        # exact: every partial sum is an integer below 2**24
        acc = torch.matmul(x.to(torch.float32), w_q)
        return acc * s_w + b
