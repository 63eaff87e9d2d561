"""Fused conv + bias + ReLU: the three conv kernels of the runtime net.

Each op has a plain PyTorch version (``*_plain``) and a wrapper. The
wrapper checks its arguments; for tensors on the CPU it returns the plain
version, for CUDA tensors it launches the hand-written kernel on the
current stream (or raises: there is no fallback from a CUDA tensor to the
plain version) and adds one to its ``launches`` count. In bf16, K1 and K2
are the tensor-core implicit GEMM of ``csrc/conv_igemm.cu`` and K3 (both
modes) the tensor-core GEMM of ``csrc/up_igemm.cu``; in f32, K1 and K2 are
the implicit GEMM on the CUDA cores of ``csrc/conv.cu`` and K3 (both
modes) its GEMM on the CUDA cores.

Layouts: activations NHWC ([N, H, W, C], bf16 or f32, contiguous), conv
weights HWIO ([kh, kw, cin, cout], the activations' dtype), bias [cout]
f32. Output NHWC in the activations' dtype.

Rounding: the kernels accumulate in f32, add the f32 bias, apply ReLU and
round once to the output dtype. The plain versions follow the JAX net
(``segnet.py:438``): the conv result is rounded to the compute dtype
before the f32 bias is added, so in bf16 the two differ by up to one bf16
rounding of the pre-bias sum (relative 2**-8).

  K1 conv3x3_bias_relu      3x3, stride 1, zero padding (1, 1); optional
                            second input ``x2`` whose channels follow
                            ``x``'s (the decoder's concat([up, skip]))
  K2 conv3x3_s2_bias_relu   3x3, stride 2, zero padding (0, 1) on even H
                            and W (XLA SAME: output o taps inputs 2o+d)
  K3 up2x2_bias_relu        2x2 stride-2 transpose conv:
                            out[2i+u, 2j+v] = x[i, j] . w[1-u, 1-v]
     up2x2_bias             K3 without the ReLU: the U-Net's linear up
                            layer, the same rounding
     up2x2_requant          K3's requant mode, the int8 net's up layer
                            (quantized_runtime.py:480-487): int8 x times
                            s_in, rounded to w's dtype, through the same
                            transpose conv; the f32 sum rounded to w's
                            dtype (XLA's bf16 conv output), then
                            requantized to int8 as ops/qconv.py does
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from annonet_tpu_torch.ops import _build
from annonet_tpu_torch.ops.qconv import requant_plain

_DTYPES = (torch.float32, torch.bfloat16)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _epilogue(h_nchw: torch.Tensor, bias: torch.Tensor, dtype, relu: bool = True
              ) -> torch.Tensor:
    h = h_nchw.permute(0, 2, 3, 1).to(torch.float32) + bias
    return (torch.relu(h) if relu else h).to(dtype).contiguous()


def conv3x3_bias_relu_plain(x, w, bias, x2: Optional[torch.Tensor] = None):
    if x2 is not None:
        x = torch.cat([x, x2], dim=-1)
    h = F.conv2d(_nchw(x), w.permute(3, 2, 0, 1), padding=1)
    return _epilogue(h, bias, x.dtype)


def conv3x3_s2_bias_relu_plain(x, w, bias):
    # explicit (0, 1) padding: torch's padding=1 would pad (1, 1)
    xp = F.pad(_nchw(x), (0, 1, 0, 1))
    h = F.conv2d(xp, w.permute(3, 2, 0, 1), stride=2)
    return _epilogue(h, bias, x.dtype)


def _up2x2(x, w):
    # conv_transpose2d computes out[2i+u, 2j+v] = x[i, j] . W[:, :, u, v];
    # the net's transpose conv uses the flipped kernel w[1-u, 1-v]
    wt = torch.flip(w, dims=(0, 1)).permute(2, 3, 0, 1)  # [cin, cout, 2, 2]
    return F.conv_transpose2d(_nchw(x), wt, stride=2)


def up2x2_bias_relu_plain(x, w, bias):
    return _epilogue(_up2x2(x, w), bias, x.dtype)


def up2x2_bias_plain(x, w, bias):
    return _epilogue(_up2x2(x, w), bias, x.dtype, relu=False)


def up2x2_requant_plain(x_q, s_in, w, scale, offset):
    xf = x_q.to(w.dtype) * s_in.to(w.dtype)  # one rounding to w's dtype
    h = _up2x2(xf, w)  # summed in f32, rounded to w's dtype
    return requant_plain(h.permute(0, 2, 3, 1).to(torch.float32), scale, offset)


def _check(x, w, bias, kh, kw, cin, what):
    if x.dim() != 4 or w.dim() != 4 or bias.dim() != 1:
        raise ValueError(f"{what}: expected x [N,H,W,C], w [kh,kw,cin,cout], bias [cout]")
    if x.dtype not in _DTYPES or w.dtype != x.dtype or bias.dtype != torch.float32:
        raise ValueError(
            f"{what}: x and w must share a dtype in {_DTYPES} and bias must be "
            f"float32 (got {x.dtype}, {w.dtype}, {bias.dtype})"
        )
    if tuple(w.shape[:3]) != (kh, kw, cin) or bias.shape[0] != w.shape[3]:
        raise ValueError(
            f"{what}: weight {tuple(w.shape)} / bias {tuple(bias.shape)} do not "
            f"match a {kh}x{kw} conv over {cin} input channels"
        )
    for t in (x, w, bias):
        if t.device != x.device:
            raise ValueError(f"{what}: all tensors must be on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch_conv(x, x2, w, bias, stride):
    n, h, wd, c1 = x.shape
    c2 = 0 if x2 is None else x2.shape[3]
    cout = w.shape[3]
    out = torch.empty(
        (n, h // stride, wd // stride, cout), dtype=x.dtype, device=x.device
    )
    with torch.cuda.device(x.device):
        code = _build.lib().annonet_conv3x3_bias_relu(
            x.data_ptr(), 0 if x2 is None else x2.data_ptr(), w.data_ptr(),
            bias.data_ptr(), out.data_ptr(), n, h, wd, c1, c2, cout, stride,
            int(x.dtype == torch.bfloat16), _stream(x.device),
        )
    _build.check(code, "annonet_conv3x3_bias_relu")
    return out


def conv3x3_bias_relu(x, w, bias, x2: Optional[torch.Tensor] = None):
    """K1: relu(conv3x3_same([x, x2]) + bias), NHWC in and out."""
    c2 = 0
    if x2 is not None:
        if x2.dim() != 4 or x2.shape[:3] != x.shape[:3] or x2.dtype != x.dtype:
            raise ValueError(
                "conv3x3_bias_relu: x2 must match x in N, H, W and dtype"
            )
        if x2.device != x.device or not x2.is_contiguous():
            raise ValueError("conv3x3_bias_relu: x2 must be contiguous on x's device")
        c2 = x2.shape[3]
    _check(x, w, bias, 3, 3, x.shape[3] + c2, "conv3x3_bias_relu")
    if x.device.type == "cpu":
        return conv3x3_bias_relu_plain(x, w, bias, x2)
    conv3x3_bias_relu.launches += 1
    return _launch_conv(x, x2, w, bias, 1)


conv3x3_bias_relu.launches = 0


def conv3x3_s2_bias_relu(x, w, bias):
    """K2: relu(conv3x3 stride 2, padding (0, 1), + bias): [N,H,W,C] ->
    [N,H/2,W/2,C'] for even H and W."""
    _check(x, w, bias, 3, 3, x.shape[3], "conv3x3_s2_bias_relu")
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(
            f"conv3x3_s2_bias_relu: H and W must be even, got {tuple(x.shape)}"
        )
    if x.device.type == "cpu":
        return conv3x3_s2_bias_relu_plain(x, w, bias)
    conv3x3_s2_bias_relu.launches += 1
    return _launch_conv(x, None, w, bias, 2)


conv3x3_s2_bias_relu.launches = 0


def _launch_up(x, w, bias, relu: bool):
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    out = torch.empty((n, 2 * h, 2 * wd, cout), dtype=x.dtype, device=x.device)
    name = "annonet_up2x2_bias_relu" if relu else "annonet_up2x2_bias"
    with torch.cuda.device(x.device):
        code = getattr(_build.lib(), name)(
            x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
            n, h, wd, cin, cout, int(x.dtype == torch.bfloat16),
            _stream(x.device),
        )
    _build.check(code, name)
    return out


def up2x2_bias_relu(x, w, bias):
    """K3: relu(transpose conv 2x2 stride 2 + bias): [N,H,W,C] ->
    [N,2H,2W,C'], with out[2i+u, 2j+v] = x[i, j] . w[1-u, 1-v]."""
    _check(x, w, bias, 2, 2, x.shape[3], "up2x2_bias_relu")
    if x.device.type == "cpu":
        return up2x2_bias_relu_plain(x, w, bias)
    up2x2_bias_relu.launches += 1
    return _launch_up(x, w, bias, True)


up2x2_bias_relu.launches = 0


def up2x2_bias(x, w, bias):
    """K3 without the ReLU: transpose conv 2x2 stride 2 + bias, [N,H,W,C]
    -> [N,2H,2W,C'] (the U-Net's up layer)."""
    _check(x, w, bias, 2, 2, x.shape[3], "up2x2_bias")
    if x.device.type == "cpu":
        return up2x2_bias_plain(x, w, bias)
    up2x2_bias.launches += 1
    return _launch_up(x, w, bias, False)


up2x2_bias.launches = 0


def up2x2_requant(x_q, s_in, w, scale, offset):
    """K3 in requant mode: requant(up2x2(x_q * s_in, w)), [N,H,W,C] int8 ->
    [N,2H,2W,C'] int8. ``s_in`` [C], ``scale`` and ``offset`` [C'] f32;
    ``w`` [2,2,C,C'] in the compute dtype."""
    what = "up2x2_requant"
    if x_q.dim() != 4 or x_q.dtype != torch.int8:
        raise ValueError(f"{what}: x must be int8 [N,H,W,C]")
    if w.dim() != 4 or w.dtype not in _DTYPES or tuple(w.shape[:3]) != (2, 2, x_q.shape[3]):
        raise ValueError(
            f"{what}: w must be [2,2,{x_q.shape[3]},C'] in {_DTYPES}, got "
            f"{tuple(w.shape)} {w.dtype}"
        )
    for t, n in ((s_in, x_q.shape[3]), (scale, w.shape[3]), (offset, w.shape[3])):
        if t.dtype != torch.float32 or tuple(t.shape) != (n,):
            raise ValueError(f"{what}: s_in, scale and offset must be float32 vectors")
    for t in (x_q, s_in, w, scale, offset):
        if t.device != x_q.device or not t.is_contiguous():
            raise ValueError(f"{what}: all tensors must be contiguous on {x_q.device}")
    if x_q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x_q.device}")
    if x_q.device.type == "cpu":
        return up2x2_requant_plain(x_q, s_in, w, scale, offset)
    up2x2_requant.launches += 1
    n, h, wd, cin = x_q.shape
    cout = w.shape[3]
    out = torch.empty((n, 2 * h, 2 * wd, cout), dtype=torch.int8, device=x_q.device)
    with torch.cuda.device(x_q.device):
        code = _build.lib().annonet_up2x2_requant(
            x_q.data_ptr(), s_in.data_ptr(), w.data_ptr(), scale.data_ptr(),
            offset.data_ptr(), out.data_ptr(), n, h, wd, cin, cout,
            int(w.dtype == torch.bfloat16), _stream(x_q.device),
        )
    _build.check(code, "annonet_up2x2_requant")
    return out


up2x2_requant.launches = 0
