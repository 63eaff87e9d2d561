"""int8 forward convolutions for training (straight-through estimator):
the port of ``annonet_tpu/ops/int8_train.py``.

Each 3x3 conv of the stem, encoder and decoder quantizes its operands
dynamically every step, symmetric abs-max, per tensor for the activation
and per output channel for the weights (``scale = max(amax, 1e-12) /
127``, round half to even, clip to +-127), sums the int8 products as
exact int32 on the int8 tensor cores (Q1's accumulator mode at stride 1,
``ops/qconv.py qconv3x3_acc``; Q2's at stride 2, ``qconv3x3_s2_acc``),
dequantizes (``float32(acc) * (sx * sw)``, cast to the compute dtype) and
routes the gradients through the exact conv at the unquantized operands
(cuDNN's convolution backward of ``models/segnet.py _conv_train``, asked
for the two gradients alone): the backward is the unquantized step's, only
the forward values carry the int8 grid's noise.
The decoder's conv quantizes its concatenated input with one scale. The
transpose convs and the head stay exact (``apply_train``'s ``conv_impl``).

The abs-max, the quantization and the dequantization are plain torch ops
(XLA does them outside any kernel in the JAX package); the quantization
writes the NHWC int8 operand the kernels read from the training
activation (NCHW, channels-last in memory, so the NHWC view is free).
Under data parallelism the activation's abs-max is the maximum over every
shard of the mesh, its processes' too (JAX's ``pmax``), so the sharded
int8 step computes the single-device int8 step's function.

On CPU tensors the kernels' wrappers run their plain versions (exact
float64 sums).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from annonet_tpu_torch.ops.qconv import qconv3x3_acc, qconv3x3_s2_acc

_EPS = 1e-12


def quantize_sym(v: torch.Tensor, amax: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of ``v`` on the grid of ``amax`` (a
    tensor broadcastable against ``v``): (q int8, scale f32), as
    ``_quantize_sym``."""
    scale = torch.clamp(amax.to(torch.float32), min=_EPS) / 127.0
    q = torch.clamp(torch.round(v.to(torch.float32) / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """HWIO kernel -> (int8 HWIO, f32 [cout] scales): per output channel."""
    amax = w.to(torch.float32).abs().amax(dim=(0, 1, 2))
    return quantize_sym(w, amax)


def quantize_activation(x: torch.Tensor, amax: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """NCHW activation -> (int8 NHWC, contiguous, as Q1 and Q2 read it; f32
    scalar scale), on the per-tensor grid of ``amax``."""
    q, scale = quantize_sym(x.permute(0, 2, 3, 1), amax)
    return q.contiguous(), scale


def int8_conv_forward(x: torch.Tensor, w: torch.Tensor, amax: torch.Tensor,
                      stride: int) -> torch.Tensor:
    """The quantized forward: NCHW ``x`` and HWIO ``w`` in the compute
    dtype, ``amax`` the activation's abs-max (f32 scalar) -> NCHW output
    in the compute dtype (a view of NHWC memory)."""
    xq, sx = quantize_activation(x, amax)
    wq, sw = quantize_weight(w)
    acc = qconv3x3_acc(xq, wq) if stride == 1 else qconv3x3_s2_acc(xq, wq)
    out = acc.to(torch.float32) * (sx * sw)
    return out.to(x.dtype).permute(0, 3, 1, 2)


class Int8ConvSTE(torch.autograd.Function):
    """int8 forward, the exact conv's gradients backward."""

    @staticmethod
    def forward(ctx, x, w, amax, stride: int):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        return int8_conv_forward(x, w, amax, stride)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        gx, gw = conv_grads(grad, x, w, ctx.stride)
        return gx, gw, None, None


def conv_grads(grad, x, w, stride: int):
    """The gradients of ``_conv_train(x, w, stride, w.dtype)`` at (x, w)
    for the output gradient ``grad``: autograd's own convolution backward
    (the same call, so the same values), asked for the input's and the
    kernel's gradients only, so no forward conv is run again."""
    wt = w.permute(3, 2, 0, 1)
    if stride == 2:
        xp, padding = F.pad(x, (0, 1, 0, 1)), (0, 0)
    else:
        xp, padding = x, (w.shape[0] // 2,) * 2
    gx, gwt, _ = torch.ops.aten.convolution_backward(
        grad, xp, wt, None, (stride, stride), padding, (1, 1), False, (0, 0), 1,
        (True, True, False))
    if stride == 2:
        gx = gx[:, :, :x.shape[2], :x.shape[3]]
    return gx, gwt.permute(2, 3, 1, 0)


def int8_convs(xs: List[torch.Tensor], ws: List[torch.Tensor], stride: int, dtype,
               reducer=None) -> List[torch.Tensor]:
    """``apply_train``'s ``conv_impl`` for int8 training: the straight-
    through int8 conv of every shard in ``xs`` (NCHW, compute dtype) with
    its f32 kernel in ``ws`` cast to ``dtype``; one activation scale over
    all shards (``reducer.max``) when the step is data-parallel."""
    amaxes = [x.detach().abs().amax().to(torch.float32) for x in xs]
    amax = amaxes[0] if reducer is None else reducer.max(amaxes)
    return [Int8ConvSTE.apply(x, w.to(dtype), amax.to(x.device), stride)
            for x, w in zip(xs, ws)]

