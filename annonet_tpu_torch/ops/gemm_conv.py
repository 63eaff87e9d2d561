"""G1: the folded stride-1 3x3 conv + bias + ReLU as three GEMMs.

The counterpart of ``annonet_tpu/ops/pallas_conv.py``: the host-side
weight builder (a numpy copy of ``build_gemm_kernels_aligned``), the table
of the weights' nonzero blocks that the bf16 kernel walks
(``g1_block_table``), the plain PyTorch version of
``conv3x3_gemm_aligned``, and its wrapper, which checks its arguments,
returns the plain version for CPU tensors and launches the hand-written
kernel of ``csrc/gemm_conv.cu`` for CUDA tensors (or raises: there is no
fallback from a CUDA tensor to the plain version), adding one to its
``launches`` count.

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

The block table. The weights built here are block-banded: output pixel j
of a width block reads input pixels j-1..j+1, and Wl and Wr hold one
nonzero pixel block each. The bf16 kernel multiplies only the (K chunk,
column slab) blocks that hold a nonzero weight: ``g1_block_table`` lists
them, once per weight set, and a block that is all zero adds exactly zero,
so the result is the same for any weights (dense weights list every block).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from annonet_tpu_torch.ops import _build

_DTYPES = (torch.float32, torch.bfloat16)
# the bf16 kernel's block sizes (csrc/gemm_conv.cu): K chunks of G1_KC rows,
# column slabs of G1_SLAB, a thread block per group of G1_GROUP columns
G1_KC, G1_SLAB, G1_GROUP = 32, 32, 128
_SLABS_PER_GROUP = G1_GROUP // G1_SLAB


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


def _block_nonzero(wc, wl, wr) -> np.ndarray:
    """bool [9 * chunks, slabs]: (segment s, dy, K chunk) by column slab,
    True where the weights hold a nonzero; row (s * 3 + dy) * chunks + c."""
    k1, nc = wc.shape[0] // 3, wc.shape[1]
    cps, slabs = -(-k1 // G1_KC), -(-nc // G1_SLAB)
    out = []
    for m in (wc, wl, wr):
        nz = torch.zeros((3, cps * G1_KC, slabs * G1_SLAB), dtype=torch.bool)
        nz[:, :k1, :nc] = (m != 0).reshape(3, k1, nc).cpu()
        out.append(nz.reshape(3, cps, G1_KC, slabs, G1_SLAB).any(4).any(2))
    return torch.stack(out).reshape(9 * cps, slabs).numpy()


def g1_block_table(wc, wl, wr) -> torch.Tensor:
    """The table of the weights' nonzero blocks, int32 on their device:
    [groups + 1] offsets into the entries that follow, then, for each group
    of G1_GROUP output columns in turn, one entry ``chunk * 16 + mask`` for
    each K chunk with a nonzero weight in the group, chunk = (s * 3 + dy) *
    ceil(K1 / G1_KC) + c (rows c * G1_KC .. of segment s in (Wc, Wl, Wr) at
    row tap dy) and mask bit j set when the group's slab j holds one."""
    nz = _block_nonzero(wc, wl, wr)
    groups = -(-wc.shape[1] // G1_GROUP)
    nz = np.pad(nz, ((0, 0), (0, groups * _SLABS_PER_GROUP - nz.shape[1])))
    masks = (nz.reshape(nz.shape[0], groups, _SLABS_PER_GROUP)
             << np.arange(_SLABS_PER_GROUP)).sum(-1)
    entries = [np.flatnonzero(masks[:, g]) * 16 + masks[masks[:, g] > 0, g]
               for g in range(groups)]
    offsets = np.concatenate([[0], np.cumsum([len(e) for e in entries])])
    table = np.concatenate([offsets] + entries).astype(np.int32)
    return torch.from_numpy(table).to(wc.device)


def table_blocks(table: torch.Tensor, k1: int, nc: int):
    """The (segment, dy, row range, column range) of every block the table
    lists, rows within K1 and columns within NC."""
    t = table.cpu().numpy()
    groups = -(-nc // G1_GROUP)
    cps = -(-k1 // G1_KC)
    for g in range(groups):
        for entry in t[groups + 1 + t[g] : groups + 1 + t[g + 1]]:
            seg, c = divmod(int(entry) >> 4, cps)
            for j in range(_SLABS_PER_GROUP):
                n0 = g * G1_GROUP + j * G1_SLAB
                if (entry >> j) & 1 and n0 < nc:
                    yield (seg // 3, seg % 3, (c * G1_KC, min(k1, (c + 1) * G1_KC)),
                           (n0, min(nc, n0 + G1_SLAB)))


def table_macs(table: torch.Tensor, k1: int, nc: int) -> int:
    """Multiply-adds per GEMM row over the listed blocks: what the kernel's
    products need for these weights (the dense GEMM's is 9 * K1 * NC)."""
    return sum((r1 - r0) * (n1 - n0) for _s, _dy, (r0, r1), (n0, n1)
               in table_blocks(table, k1, nc))


def restrict_to_table(wc, wl, wr, table):
    """(Wc, Wl, Wr) with every block the table does not list set to zero:
    the weights the kernel multiplies."""
    k1, nc = wc.shape[0] // 3, wc.shape[1]
    keep = torch.zeros((3, 3 * k1, nc), dtype=torch.bool)
    for s, dy, (r0, r1), (n0, n1) in table_blocks(table, k1, nc):
        keep[s, dy * k1 + r0 : dy * k1 + r1, n0:n1] = True
    keep = keep.to(wc.device)
    return tuple(torch.where(keep[i], m, torch.zeros_like(m)) for i, m in enumerate((wc, wl, wr)))


def conv3x3_gemm_aligned_plain(x_folded, wc, wl, wr, bias, fold: int, cin: int,
                               table: Optional[torch.Tensor] = None):
    """The three GEMMs in f32 (the left and right ones on the centre
    operand, their rows shifted by one block afterwards: a row's product
    does not depend on its neighbours), summed in the Pallas kernel's
    order, + bias, ReLU, one rounding. With ``table``, only the blocks it
    lists (``restrict_to_table``), as the bf16 kernel multiplies them."""
    if table is not None:
        wc, wl, wr = restrict_to_table(wc, wl, wr, table)
    n, h, wb, k1 = x_folded.shape
    xp = F.pad(x_folded.to(torch.float32), (0, 0, 0, 0, 1, 1))  # rows -1 and H
    p = torch.cat([xp[:, dy : dy + h] for dy in range(3)], dim=-1)
    acc = torch.matmul(p, wc.to(torch.float32))
    acc[:, :, 1:] += torch.matmul(p, wl.to(torch.float32))[:, :, :-1]
    acc[:, :, :-1] += torch.matmul(p, wr.to(torch.float32))[:, :, 1:]
    acc += bias.to(torch.float32).repeat(fold)
    return torch.relu(acc).to(x_folded.dtype)


def _check(x, wc, wl, wr, bias, fold, cin, table):
    what = "conv3x3_gemm_aligned"
    if table is not None and (table.dtype != torch.int32 or table.dim() != 1
                              or table.device != x.device or not table.is_contiguous()):
        raise ValueError(f"{what}: the block table must be a contiguous int32 vector "
                         f"on {x.device} (g1_block_table)")
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


def conv3x3_gemm_aligned(x_folded, wc, wl, wr, bias, fold: int, cin: int,
                         table: Optional[torch.Tensor] = None):
    """G1: the folded stride-1 3x3 conv + bias + ReLU (module docstring).
    ``table`` is ``g1_block_table(wc, wl, wr)``, made once per weight set
    by the caller; without one the bf16 kernel builds it on each call."""
    _check(x_folded, wc, wl, wr, bias, fold, cin, table)
    if x_folded.device.type == "cpu":
        return conv3x3_gemm_aligned_plain(x_folded, wc, wl, wr, bias, fold, cin, table)
    bf16 = x_folded.dtype == torch.bfloat16
    if bf16 and table is None:
        table = g1_block_table(wc, wl, wr)
    conv3x3_gemm_aligned.launches += 1
    n, h, wb, k1 = x_folded.shape
    nc = wc.shape[1]
    out = torch.empty((n, h, wb, nc), dtype=x_folded.dtype, device=x_folded.device)
    with torch.cuda.device(x_folded.device):
        code = _build.lib().annonet_conv3x3_gemm(
            x_folded.data_ptr(), wc.data_ptr(), wl.data_ptr(), wr.data_ptr(),
            bias.data_ptr(), 0 if table is None else table.data_ptr(), out.data_ptr(),
            n, h, wb, k1, nc, bias.shape[0], int(bf16),
            torch.cuda.current_stream(x_folded.device).cuda_stream,
        )
    _build.check(code, "annonet_conv3x3_gemm")
    return out


conv3x3_gemm_aligned.launches = 0
