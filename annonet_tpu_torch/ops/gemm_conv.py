"""G1: the folded stride-1 3x3 conv + bias + ReLU as three GEMMs.

The counterpart of ``annonet_tpu/ops/pallas_conv.py``: the host-side
weight builder (a numpy copy of ``build_gemm_kernels_aligned``), the table
of the weights' nonzero blocks that the kernels walk (``g1_block_table``),
the plain PyTorch version of
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
nonzero pixel block each. Both kernels multiply only the (K chunk, column
slab) blocks that hold a nonzero weight: ``g1_block_table`` lists them,
once per weight set, and a block that is all zero adds exactly zero, so
the result is the same for any weights (dense weights list every block).
The block sizes follow the weights' dtype:

- bf16: K chunks of 32 rows by slabs of 32 columns, a vector of offsets
  and entries (``g1_block_table``'s docstring);
- f32: K chunks of 16 rows by slabs of 16 columns, so that at fold 8 a
  block of a layer with 16k input and output channels is one input pixel
  by one output pixel and the table lists just the conv's own products
  (32 x 32 blocks list twice that at stem/conv1 and dec1/conv0; at the RGB
  stem, K1 = 24, a 16-row chunk spans 5.3 pixels, and the table lists 2.3x
  the conv's products). It is a [rows, 16] int32 array: a header, K1, NC
  and the group count, then the schedule the f32 kernel walks
  (``_f32_table``).

The wrapper refuses a table of the other dtype's layout (told apart by its
dimension count). A table built for another K1 or NC: the plain version
raises, and the f32 kernel, which reads the header, writes NaN to every
output instead of walking the records (it cannot raise without a sync).
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
# the f32 kernel's (csrc/gemm_conv.cu, gemm_conv_f32): K chunks of 16 rows,
# slabs of 16 columns (a warp each), a thread block per group of 8 slabs;
# its stages each hold the A rows of one row tap dy and one span of
# G1F_SPAN K rows, and every stage has at least G1F_MIN_STEPS steps (its B
# ring is G1F_MIN_STEPS + 1 deep)
G1F_KC, G1F_SLAB, G1F_GROUP, G1F_SPAN, G1F_MIN_STEPS = 16, 16, 128, 128, 2
G1F_REC = 16  # ints a row of the f32 table
_G1F_SLABS, _G1F_CHUNKS = G1F_GROUP // G1F_SLAB, G1F_SPAN // G1F_KC


def block_sizes(dtype: torch.dtype):
    """(K chunk rows, slab columns, group columns) of ``dtype``'s kernel."""
    if dtype == torch.bfloat16:
        return G1_KC, G1_SLAB, G1_GROUP
    if dtype == torch.float32:
        return G1F_KC, G1F_SLAB, G1F_GROUP
    raise ValueError(f"G1 has no kernel for {dtype}")


def table_dtype(table: torch.Tensor) -> torch.dtype:
    """The dtype whose kernel walks ``table``: the f32 table is 2-D."""
    return torch.float32 if table.dim() == 2 else torch.bfloat16


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


def _block_nonzero(wc, wl, wr, kc: int, slab: int) -> np.ndarray:
    """bool [9 * chunks, slabs]: (segment s, dy, K chunk of kc rows) by
    column slab of ``slab`` columns, True where the weights hold a nonzero;
    row (s * 3 + dy) * chunks + c."""
    k1, nc = wc.shape[0] // 3, wc.shape[1]
    cps, slabs = -(-k1 // kc), -(-nc // slab)
    out = []
    for m in (wc, wl, wr):
        nz = torch.zeros((3, cps * kc, slabs * slab), dtype=torch.bool)
        nz[:, :k1, :nc] = (m != 0).reshape(3, k1, nc).cpu()
        out.append(nz.reshape(3, cps, kc, slabs, slab).any(4).any(2))
    return torch.stack(out).reshape(9 * cps, slabs).numpy()


def g1_block_table(wc, wl, wr) -> torch.Tensor:
    """The table of the weights' nonzero blocks, int32 on their device,
    with the block sizes of the weights' dtype (``block_sizes``). For f32
    weights, ``_f32_table``'s schedule. For bf16: [groups + 1] offsets into
    the entries that follow, then, for each group of G1_GROUP output
    columns in turn, one entry ``chunk * 16 + mask`` for each K chunk with
    a nonzero weight in the group, chunk = (s * 3 + dy) * ceil(K1 / G1_KC)
    + c (rows c * G1_KC .. of segment s in (Wc, Wl, Wr) at row tap dy) and
    mask bit j set when the group's slab j holds one."""
    block_sizes(wc.dtype)
    if wc.dtype == torch.float32:
        return torch.from_numpy(_f32_table(wc, wl, wr)).to(wc.device)
    nz = _block_nonzero(wc, wl, wr, G1_KC, G1_SLAB)
    groups = -(-wc.shape[1] // G1_GROUP)
    nz = np.pad(nz, ((0, 0), (0, groups * _SLABS_PER_GROUP - nz.shape[1])))
    masks = (nz.reshape(nz.shape[0], groups, _SLABS_PER_GROUP)
             << np.arange(_SLABS_PER_GROUP)).sum(-1)
    entries = [np.flatnonzero(masks[:, g]) * 16 + masks[masks[:, g] > 0, g]
               for g in range(groups)]
    offsets = np.concatenate([[0], np.cumsum([len(e) for e in entries])])
    table = np.concatenate([offsets] + entries).astype(np.int32)
    return torch.from_numpy(table).to(wc.device)


def _f32_table(wc, wl, wr) -> np.ndarray:
    """The f32 kernel's schedule of nonzero 16 x 16 blocks, int32 [rows, 16].

    Row 0, the header: K1, NC, groups (the kernel checks them against its
    call). The next ceil((groups + 1) / 16) rows:
    the first record of each group of G1F_GROUP columns, and the end,
    counted from the first record. Then one record a step, a group's steps
    in turn. A group walks stages q = dy * spans + span (spans = ceil(K1 /
    G1F_SPAN)): a stage stages the A rows of row tap dy and K rows span *
    G1F_SPAN .. +G1F_SPAN once, and in each of its steps every slab (a
    warp) multiplies one of its own blocks there. Record: [q, e_0 .. e_7,
    first, next, 0 ...] with e_j = chunk * 4 + s (chunk of G1F_KC rows
    within the span, segment s in (Wc, Wl, Wr)) for slab j's block of this
    step, or -1; first = 1 on a stage's first step, and there next = the q
    of the group's next stage (-1 after the last). A stage with no block
    in the group is left out; a stage has max over the slabs of their
    blocks' count steps, at least G1F_MIN_STEPS (steps past a slab's
    blocks are -1). At fold 8 each slab holds three blocks at each dy, so
    no warp waits in a step."""
    k1, nc = wc.shape[0] // 3, wc.shape[1]
    cps, slabs = -(-k1 // G1F_KC), -(-nc // G1F_SLAB)
    spans, groups = -(-k1 // G1F_SPAN), -(-nc // G1F_GROUP)
    nz = _block_nonzero(wc, wl, wr, G1F_KC, G1F_SLAB).reshape(3, 3, cps, slabs)
    records, offsets = [], [0]
    for g in range(groups):
        stages = []
        for dy in range(3):
            for span in range(spans):
                chunks = range(span * _G1F_CHUNKS, min(cps, (span + 1) * _G1F_CHUNKS))
                lists = [[(c - span * _G1F_CHUNKS) * 4 + s for c in chunks for s in range(3)
                          if nz[s, dy, c, j]]
                         for j in range(g * _G1F_SLABS, min(slabs, (g + 1) * _G1F_SLABS))]
                steps = max(len(blocks) for blocks in lists)
                if steps:
                    stages.append((dy * spans + span, lists, max(steps, G1F_MIN_STEPS)))
        for i, (q, lists, steps) in enumerate(stages):
            following = stages[i + 1][0] if i + 1 < len(stages) else -1
            for t in range(steps):
                entries = [blocks[t] if t < len(blocks) else -1 for blocks in lists]
                entries += [-1] * (_G1F_SLABS - len(entries))
                records.append([q, *entries, int(t == 0), following if t == 0 else -1])
        offsets.append(len(records))
    header = [k1, nc, groups]
    off_rows = -(-len(offsets) // G1F_REC)
    table = np.zeros((1 + off_rows + len(records), G1F_REC), np.int32)
    table[0, : len(header)] = header
    table[1 : 1 + off_rows].reshape(-1)[: len(offsets)] = offsets
    if records:
        table[1 + off_rows :, : len(records[0])] = records
    return table


def _f32_table_blocks(t: np.ndarray, k1: int, nc: int):
    groups, spans = -(-nc // G1F_GROUP), -(-k1 // G1F_SPAN)
    if list(t[0, :3]) != [k1, nc, groups]:
        raise ValueError(f"not an f32 G1 table of K1 {k1}, NC {nc}: header {list(t[0, :3])}")
    off_rows = -(-(groups + 1) // G1F_REC)
    offsets, records = t[1 : 1 + off_rows].reshape(-1), t[1 + off_rows :]
    for g in range(groups):
        for rec in records[offsets[g] : offsets[g + 1]]:
            dy, span = divmod(int(rec[0]), spans)
            for j, e in enumerate(rec[1 : 1 + _G1F_SLABS]):
                n0 = g * G1F_GROUP + j * G1F_SLAB
                if e >= 0 and n0 < nc:
                    r0 = span * G1F_SPAN + (int(e) >> 2) * G1F_KC
                    yield (int(e) & 3, dy, (r0, min(k1, r0 + G1F_KC)),
                           (n0, min(nc, n0 + G1F_SLAB)))


def table_blocks(table: torch.Tensor, k1: int, nc: int):
    """The (segment, dy, row range, column range) of every block the table
    lists, rows within K1 and columns within NC, with the block sizes of
    the table's layout (``table_dtype``)."""
    t = table.cpu().numpy()
    if table_dtype(table) == torch.float32:
        yield from _f32_table_blocks(t, k1, nc)
        return
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
    lists (``restrict_to_table``), as the kernels multiply them."""
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
    if table is not None and (table.dtype != torch.int32 or table.dim() not in (1, 2)
                              or table.device != x.device or not table.is_contiguous()
                              or table.dim() == 2 and (table.shape[1] != G1F_REC
                                                       or table.shape[0] < 1)):
        raise ValueError(f"{what}: the block table must be a contiguous int32 tensor "
                         f"on {x.device} (g1_block_table)")
    if table is not None and table_dtype(table) != x.dtype:
        raise ValueError(f"{what}: the block table was built for {table_dtype(table)} weights "
                         f"(its block sizes {block_sizes(table_dtype(table))[:2]}), x is "
                         f"{x.dtype}")
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
    by the caller; without one it is built on each call."""
    _check(x_folded, wc, wl, wr, bias, fold, cin, table)
    if x_folded.device.type == "cpu":
        return conv3x3_gemm_aligned_plain(x_folded, wc, wl, wr, bias, fold, cin, table)
    bf16 = x_folded.dtype == torch.bfloat16
    if table is None:
        table = g1_block_table(wc, wl, wr)
    conv3x3_gemm_aligned.launches += 1
    n, h, wb, k1 = x_folded.shape
    nc = wc.shape[1]
    out = torch.empty((n, h, wb, nc), dtype=x_folded.dtype, device=x_folded.device)
    with torch.cuda.device(x_folded.device):
        code = _build.lib().annonet_conv3x3_gemm(
            x_folded.data_ptr(), wc.data_ptr(), wl.data_ptr(), wr.data_ptr(),
            bias.data_ptr(), table.data_ptr(), out.data_ptr(),
            n, h, wb, k1, nc, bias.shape[0], int(bf16),
            torch.cuda.current_stream(x_folded.device).cuda_stream,
        )
    _build.check(code, "annonet_conv3x3_gemm")
    return out


conv3x3_gemm_aligned.launches = 0
