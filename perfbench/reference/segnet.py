"""The plain reference of annonet's SegNet, in float32 PyTorch.

The architecture of reunanen/annonet's dlib net as the configuration
files give it (``level_count`` L, widths ``base_width * 2**min(level, 3)``):

    stem:  conv3x3 -> ReLU, conv3x3 -> ReLU                     (w0)
    enc i: conv3x3 stride 2 -> ReLU, conv3x3 -> ReLU            (wi)
    dec i: 2x2 stride-2 transpose conv -> ReLU, concat [up, skip],
           conv3x3 -> ReLU                                      (w(i-1))
    head:  1x1 conv -> class_count logits

Inputs are uint8 pixels, normalised to x / 255 - 0.5. A stride-2 3x3 conv
pads one pixel at the bottom and the right only (SAME on even sizes); the
transpose conv writes out[2i + u, 2j + v] = x[i, j] . w[1 - u, 1 - v]. The
training net has batch norm after every conv and transpose conv (no conv
bias), over the batch's statistics, biased variance, eps 1e-5.

Every operation is float32 with TF32 off (``exact``). No kernel, cache or
batching of the program is used; nothing of the program is imported.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, Optional

import torch
import torch.nn.functional as F

BN_EPS = 1e-5


@contextlib.contextmanager
def exact() -> Iterator[None]:
    """float32 products stay float32 on the card: TF32 off inside."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """3x3 conv of NCHW ``x`` with an HWIO kernel."""
    k = w.permute(3, 2, 0, 1)
    if stride == 2:
        return F.conv2d(F.pad(x, (0, 1, 0, 1)), k, stride=2)
    return F.conv2d(x, k, padding=1)


def _up(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 transpose conv of NCHW ``x``: out[2i+u, 2j+v] =
    sum_c x[c, i, j] w[1-u, 1-v, c, :], written as one product."""
    n, _c, h, wd = x.shape
    flipped = torch.flip(w, dims=(0, 1))  # [u, v, cin, cout]
    out = torch.einsum("ncij,uvcd->ndiujv", x, flipped)
    return out.reshape(n, w.shape[3], 2 * h, 2 * wd)


def normalize(x_uint8: torch.Tensor) -> torch.Tensor:
    """[N, H, W, C] uint8 or 0..255 floats -> NCHW float32 in [-0.5, 0.5]."""
    return (x_uint8.to(torch.float32) / 255.0 - 0.5).permute(0, 3, 1, 2)


def _bn(h: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor):
    """(the normalised ``h``, its batch mean, its biased batch variance)."""
    mean = h.mean(dim=(0, 2, 3), keepdim=True)
    var = h.var(dim=(0, 2, 3), unbiased=False, keepdim=True)
    out = (h - mean) / torch.sqrt(var + BN_EPS) * gamma[:, None, None] + beta[:, None, None]
    return out, mean.flatten(), var.flatten()


def _round_scaled(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to the float8 ``dtype`` after scaling its largest
    magnitude to the format's largest, and scaled back."""
    amax = t.detach().abs().max()
    if not torch.isfinite(amax) or amax == 0:
        return t
    scale = torch.finfo(dtype).max / amax
    return (t * scale).to(dtype).to(t.dtype) / scale


class _Fp8(torch.autograd.Function):
    """A tensor the program keeps in bfloat16, kept in float8 instead: its
    value rounded to e4m3 in the forward, the gradient arriving at it
    rounded to e5m2 in the backward, each scaled by its largest magnitude
    first, as float8 training does."""

    @staticmethod
    def forward(ctx, t):
        return _round_scaled(t, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round_scaled(g, torch.float8_e5m2)


def fp8(t: torch.Tensor) -> torch.Tensor:
    """The control's rounding: the precision below bfloat16."""
    return _Fp8.apply(t)


def train_forward(p: Dict[str, torch.Tensor], config: Dict, x: torch.Tensor,
                  quant: Optional[Callable] = None, stats: Optional[Dict] = None
                  ) -> torch.Tensor:
    """The training net on a batch: [N, H, W, C] 0..255 floats -> [N, H,
    W, K] float32 logits, batch norm over this batch. ``p`` maps
    "block/convX" (HWIO), "block/bnX/gamma", "block/bnX/beta", "head/w",
    "head/b". ``quant`` (``fp8``: the control) rounds every tensor that
    the program keeps in its compute dtype: the normalised input, each
    kernel as the conv reads it, each conv's, batch norm's and ReLU's
    output, the logits, with the gradients arriving at them. ``stats``, if
    given, gets every batch norm's batch mean and variance as
    "block/bnX/mean" and "block/bnX/var"."""
    L = int(config["level_count"])
    q = quant or (lambda t: t)

    def unit(x, block, conv, stride=1, skip=None):
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        bn = "bnu" if conv == "up" else conv.replace("conv", "bn")
        w = q(p[f"{block}/{conv}"])
        h = q(_up(x, w) if conv == "up" else _conv(x, w, stride))
        y, mean, var = _bn(h, p[f"{block}/{bn}/gamma"], p[f"{block}/{bn}/beta"])
        if stats is not None:
            stats[f"{block}/{bn}/mean"], stats[f"{block}/{bn}/var"] = mean.detach(), var.detach()
        return q(torch.relu(q(y)))

    x = q(normalize(x))
    x = unit(unit(x, "stem", "conv0"), "stem", "conv1")
    skips = [x]
    for i in range(1, L + 1):
        x = unit(unit(x, f"enc{i}", "conv0", 2), f"enc{i}", "conv1")
        skips.append(x)
    skips.pop()
    for i in range(L, 0, -1):
        x = unit(unit(x, f"dec{i}", "up"), f"dec{i}", "conv0", skip=skips.pop())
    return q(torch.einsum("nchw,ck->nhwk", x, q(p["head/w"][0, 0]))) + p["head/b"]
