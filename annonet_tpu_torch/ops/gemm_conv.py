"""G1: the folded stride-1 3x3 conv + bias + ReLU as three GEMMs.

The counterpart of ``annonet_tpu/ops/pallas_conv.py``: the host-side
weight builder (a numpy copy of ``build_gemm_kernels_aligned``), the plain
PyTorch version of ``conv3x3_gemm_aligned``, and its wrapper, which checks
its arguments, returns the plain version for CPU tensors and launches the
hand-written kernel of ``csrc/gemm_conv.cu`` for CUDA tensors (or raises:
there is no fallback from a CUDA tensor to the plain version), adding one
to its ``launches`` count.

Layout (the folded layout of ``models/folded_runtime.py``): x is
[N, H, WB, fold*cin], ``fold`` width-adjacent pixels side by side in the
channel dim, which is a free view of contiguous NHWC [N, H, WB*fold, cin].
Wc, Wl and Wr are [3*fold*cin, fold*cout] in x's dtype, bias [cout] f32.
The output [N, H, WB, fold*cout] is likewise the NHWC [N, H, W, cout] view.
With P_dy[n, h, b] = x[n, h+dy-1, b, :] (zero outside the image):

    out[n,h,b] = relu(bias + sum_dy P_dy[b] Wc_dy + P_dy[b-1] Wl_dy
                                    + P_dy[b+1] Wr_dy)

with the b-1 term zero at b = 0 and the b+1 term zero at b = WB-1; sums in
f32, one rounding to x's dtype (``pallas_conv.py:97-182``). Both versions
hold for any Wc, Wl and Wr, not only the ones built here.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from annonet_tpu_torch.ops import _build

_DTYPES = (torch.float32, torch.bfloat16)


def build_gemm_kernels_aligned(w: np.ndarray, fold: int):
    """[3,3,cin,cout] -> (Wc, Wl, Wr), each [3*fold*cin, fold*cout] f32.

    Row (dy, i, ci) of Wc carries w[dy, i-j+1] for in-block taps
    (dx = i - j in {-1,0,1}); Wl carries the tap where the input is the
    last pixel of the previous block (j=0, dx=-1 -> i=fold-1); Wr the
    first pixel of the next block (j=fold-1, dx=+1 -> i=0).
    """
    kh, kw, cin, cout = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"expected a 3x3 kernel, got {w.shape}")
    shape = (3 * fold * cin, fold * cout)
    wc = np.zeros(shape, np.float32)
    wl = np.zeros(shape, np.float32)
    wr = np.zeros(shape, np.float32)
    for dy in range(3):
        rows_base = dy * fold * cin
        for j in range(fold):
            cols = slice(j * cout, (j + 1) * cout)
            for dx in (-1, 0, 1):
                i = j + dx
                if 0 <= i < fold:
                    wc[rows_base + i * cin : rows_base + (i + 1) * cin, cols] = w[dy, dx + 1]
                elif i < 0:  # previous block's last pixel
                    wl[rows_base + (fold - 1) * cin : rows_base + fold * cin, cols] = w[dy, dx + 1]
                else:  # next block's first pixel
                    wr[rows_base : rows_base + cin, cols] = w[dy, dx + 1]
    return wc, wl, wr


def conv3x3_gemm_aligned_plain(x_folded, wc, wl, wr, bias, fold: int, cin: int):
    """The three GEMMs in f32 (the left and right ones on the centre
    operand, their rows shifted by one block afterwards: a row's product
    does not depend on its neighbours), summed in the Pallas kernel's
    order, + bias, ReLU, one rounding."""
    n, h, wb, k1 = x_folded.shape
    xp = F.pad(x_folded.to(torch.float32), (0, 0, 0, 0, 1, 1))  # rows -1 and H
    p = torch.cat([xp[:, dy : dy + h] for dy in range(3)], dim=-1)
    acc = torch.matmul(p, wc.to(torch.float32))
    acc[:, :, 1:] += torch.matmul(p, wl.to(torch.float32))[:, :, :-1]
    acc[:, :, :-1] += torch.matmul(p, wr.to(torch.float32))[:, :, 1:]
    acc += bias.to(torch.float32).repeat(fold)
    return torch.relu(acc).to(x_folded.dtype)


def _check(x, wc, wl, wr, bias, fold, cin):
    what = "conv3x3_gemm_aligned"
    if x.dim() != 4 or fold < 1 or cin < 1 or x.shape[3] != fold * cin:
        raise ValueError(f"{what}: x must be [N,H,WB,fold*cin] = [.., {fold * cin}], "
                         f"got {tuple(x.shape)}")
    if x.dtype not in _DTYPES or bias.dtype != torch.float32 or bias.dim() != 1:
        raise ValueError(f"{what}: x must be one of {_DTYPES} and bias a float32 vector")
    nc = fold * bias.shape[0]
    for t in (wc, wl, wr):
        if t.dtype != x.dtype or tuple(t.shape) != (3 * fold * cin, nc):
            raise ValueError(
                f"{what}: weights must be [{3 * fold * cin}, {nc}] in {x.dtype}, got "
                f"{tuple(t.shape)} {t.dtype}"
            )
    for t in (x, wc, wl, wr, bias):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{what}: all tensors must be contiguous on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")


def conv3x3_gemm_aligned(x_folded, wc, wl, wr, bias, fold: int, cin: int):
    """G1: the folded stride-1 3x3 conv + bias + ReLU (module docstring)."""
    _check(x_folded, wc, wl, wr, bias, fold, cin)
    if x_folded.device.type == "cpu":
        return conv3x3_gemm_aligned_plain(x_folded, wc, wl, wr, bias, fold, cin)
    conv3x3_gemm_aligned.launches += 1
    n, h, wb, k1 = x_folded.shape
    nc = wc.shape[1]
    out = torch.empty((n, h, wb, nc), dtype=x_folded.dtype, device=x_folded.device)
    with torch.cuda.device(x_folded.device):
        code = _build.lib().annonet_conv3x3_gemm(
            x_folded.data_ptr(), wc.data_ptr(), wl.data_ptr(), wr.data_ptr(),
            bias.data_ptr(), out.data_ptr(), n, h, wb, k1, nc, bias.shape[0],
            int(x_folded.dtype == torch.bfloat16),
            torch.cuda.current_stream(x_folded.device).cuda_stream,
        )
    _build.check(code, "annonet_conv3x3_gemm")
    return out


conv3x3_gemm_aligned.launches = 0
