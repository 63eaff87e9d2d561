"""The training step's batch norm and ReLU with batch statistics, forward
and backward. ``models/segnet.py``'s ``_unit`` calls ``bn_relu_shards``,
which picks the op below for one shard and ``bn_plain`` under sync BN.

``bn_relu(h, gamma, beta) -> (y, mean, var)`` takes the conv output ``h``
([N, C, H, W] in the compute dtype, bf16 or f32) and the layer's f32
``gamma`` and ``beta`` [C]; ``mean`` and ``var`` are the batch's f32
statistics that ``_bn_update`` folds into the running ones. On CPU tensors
it runs ``bn_relu_plain``, which is ``bn_plain`` and the ReLU themselves,
and autograd over them is the plain backward. On CUDA tensors it runs the
hand-written kernels of ``csrc/bn_relu.cu`` through a
``torch.autograd.Function`` (two launches forward, two backward), or
raises: nothing falls back from a CUDA tensor to the plain version.

The kernels keep ``bn_plain``'s arithmetic on the card (its source note
lists each rounding point): f32 statistics of the compute-dtype values,
var = max(E[h^2] - E[h]^2, 0), scale and shift rounded to the compute dtype
once per channel, y = relu(T(T(h * scale) + shift)). The statistics are
summed in another order than torch's, in a fixed one: the op is
deterministic. Its backward is the closed form of autograd's chain over
those operations (``bn_relu_backward_plain``), computed in f32 and rounded
once; the eager backward rounds at each of its operations in bf16.

Layouts: ``h`` must be channels_last in memory (the training convs'
output); ``y`` and the input gradient are too. The output gradient may be
any tensor whose rows of C channels are contiguous at one pitch (the
decoder's concat hands its parts such slices); any other layout is copied
to channels_last first, and counted in ``bn_relu.dy_copies``.

Counters: ``bn_relu.units`` (forward calls on the card), ``bn_relu.launches``
(kernel launches, forward and backward), ``bn_relu.cluster_reductions``
(reduction launches that combined their blocks' sums across a thread-block
cluster; ``reduce_geometry``).
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from annonet_tpu_torch.ops import _build

_DTYPES = (torch.float32, torch.bfloat16)
BN_EPS = 1e-5  # the batch norm's, in training and in segnet.fold_batchnorm
# the kernels' limit: C / (16 / element size) 16-byte chunks a row at most
# (C elements a row when C is not a multiple of the chunk)
_MAX_CHUNKS = 256
# the kernels' grids: at most this many blocks of 256 threads an SM,
# forward and backward. On an H100 the bf16 backward kernels hold two
# blocks an SM (127 registers a thread) and run slowest in more than one
# wave; the forward's fastest at three (its apply kernel's occupancy).
_FORWARD_BLOCKS_PER_SM = 3
_BACKWARD_BLOCKS_PER_SM = 2
# the kernels' launch geometry, which the library takes as it is given:
# blocks of at most 256 threads (csrc/bn_relu.cu kThreads, its limit), each
# thread of a reduction at least 32 rows, and the reductions' cluster sizes
# tried, largest first (csrc/bn_relu.cu kMaxCluster, the largest). 2 is for grids that fill the card:
# the bf16 backward reduction (127 registers a thread) holds 2 blocks an SM,
# and an H100 holds 62 clusters of 4 of them, 248 blocks of its 264.
_THREADS = 256
_MIN_ROWS = 32
_CLUSTERS = (16, 8, 4, 2)
# per (device, stream): [SMs, workspace, C] -- the workspace's first 64
# bytes are the reductions' 16 tickets (zeroed, and left zero by each
# launch), then the clusters' partial sums [blocks, C, 2] f64 of the
# widest C so far. A stream's launches run in order, so they share it.
_SCRATCH: Dict[Tuple[int, int], list] = {}
# per (device, backward, C, 16-byte chunks, bf16, cluster size): the
# clusters of the reduction that the card holds at once
_CAPACITY: Dict[tuple, int] = {}
# rows of the kernels' per-channel buffer [8, C] f32 (csrc/bn_relu.cu Row)
_ROWS = ("mean", "var", "inv", "scale", "shift", "diff", "a", "b")


def bn_moments(h):
    """[2, C] f32: the mean and mean square of NCHW ``h`` over (N, H, W), through
    a [N, C, H * W] view, in whose autograd node the two moments' f32 gradients
    are summed before they meet the normalisation's at ``h``."""
    x32 = h.to(torch.float32).flatten(2)
    return torch.stack([x32.mean(dim=(0, 2)), x32.square().mean(dim=(0, 2))])


def bn_plain(hs, gammas, betas, reducer=None):
    """Batch norm of NCHW ``hs`` over (N, H, W), as the JAX package's
    segnet.py _bn_train: f32 statistics of the compute-dtype activations,
    var = max(E[h^2] - E[h]^2, 0), scale and shift rounded to the compute
    dtype once per channel, the normalisation in the compute dtype. Returns
    (outs, mean, var). Not F.batch_norm: its running statistics take the
    unbiased variance.

    ``hs``, ``gammas`` and ``betas`` are lists over the shards, one of each
    without a ``reducer``. With one (sync BN, ``parallel/train.py``), each
    shard's mean and mean square are averaged over every shard of the
    mesh, its other processes' too (JAX's ``pmean`` under shard_map), and
    each shard is normalised with those statistics on its own device."""
    moments = [bn_moments(h) for h in hs]
    moments = moments if reducer is None else reducer.mean(moments)
    out, stats = [], None
    for h, (mean, mean_sq), g, b in zip(hs, moments, gammas, betas):
        var = torch.clamp(mean_sq - mean.square(), min=0.0)
        inv = torch.rsqrt(var + BN_EPS)
        scale = (inv * g).to(h.dtype)
        shift = (b - mean * inv * g).to(h.dtype)
        out.append(h * scale[:, None, None] + shift[:, None, None])
        stats = stats or (mean, var)  # the first shard's, on the home device
    return out, *stats


def bn_relu_plain(h, gamma, beta):
    """The eager unit: ``bn_plain`` of one shard, then the ReLU."""
    (z,), mean, var = bn_plain([h], [gamma], [beta])
    return torch.relu(z), mean, var


def _coefficients(s1, s2, mean, inv, diff, gamma, rows: int):
    """(dgamma, dbeta, a, b) from s1 = sum dz and s2 = sum dz * h: autograd's
    chain through shift = beta - (mean * inv) * gamma, scale = inv * gamma,
    inv = rsqrt(var + eps), the clamp's mask, and the two means."""
    t1 = mean * inv
    dgamma = s2 * inv - s1 * t1
    dt1 = -(s1 * gamma)
    dinv = s2 * gamma + dt1 * mean
    dd = torch.where(diff >= 0, (-0.5 * dinv) * (inv * inv * inv), 0.0)
    dmean = dt1 * inv - dd * (2.0 * mean)
    return dgamma, s1, dmean / rows, (2.0 * dd) / rows


def _closed_form(h, gamma, beta, dy, sums):
    """The closed form's terms in f32: (h, dz * scale, a, b, dgamma, dbeta),
    the sums of dz and dz * h taken in ``sums`` and rounded to f32."""
    x32 = h.to(torch.float32)
    mean, mean_sq = bn_moments(h)
    diff = mean_sq - mean.square()
    inv = torch.rsqrt(torch.clamp(diff, min=0.0) + BN_EPS)
    scale = (inv * gamma).to(h.dtype)
    shift = (beta - mean * inv * gamma).to(h.dtype)
    z = h * scale[:, None, None] + shift[:, None, None]
    dz = torch.where(z > 0, dy.to(torch.float32), 0.0)
    rows = h.numel() // h.shape[1]
    s1 = dz.sum(dim=(0, 2, 3), dtype=sums).to(torch.float32)
    s2 = (dz * x32).sum(dim=(0, 2, 3), dtype=sums).to(torch.float32)
    dgamma, dbeta, a, b = _coefficients(s1, s2, mean, inv, diff, gamma, rows)
    return x32, dz * scale.to(torch.float32)[:, None, None], a, b, dgamma, dbeta


def bn_relu_backward_plain(h, gamma, beta, dy):
    """The closed-form backward of ``bn_relu_plain`` in f32: (dh, dgamma,
    dbeta), dh = dz * scale + a + b * h with dz = dy where y > 0, from the
    forward's terms as ``bn_plain`` computes them."""
    x32, dz_scale, a, b, dgamma, dbeta = _closed_form(h, gamma, beta, dy, torch.float32)
    return dz_scale + a[:, None, None] + b[:, None, None] * x32, dgamma, dbeta


def bn_relu_backward_terms(h, gamma, beta, dy):
    """What checks of the kernels' backward hold it to: (the largest of
    |dz * scale|, |a| and |b * h| at each element of dh, a [C], b [C]),
    with dh's coefficients a and b from sums taken in f64 and rounded to
    f32, as the kernels' finishing blocks round their totals."""
    x32, dz_scale, a, b, _dgamma, _dbeta = _closed_form(h, gamma, beta, dy, torch.float64)
    largest = torch.maximum(dz_scale.abs(), (b[:, None, None] * x32).abs())
    return torch.maximum(largest, a.abs()[:, None, None]), a, b


def saved_rows(y):
    """The kernels' per-channel buffer that ``y``'s backward reads, as
    {row name: [C] f32}; its rows a and b are filled by that backward."""
    buf = y.grad_fn.saved_tensors[2]
    return dict(zip(_ROWS, buf))


def _check(h, gamma, beta) -> None:
    if h.dim() != 4 or h.dtype not in _DTYPES:
        raise ValueError(f"bn_relu: expected h [N,C,H,W] in {_DTYPES}, got "
                         f"{tuple(h.shape)} {h.dtype}")
    c = h.shape[1]
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t.shape != (c,) or t.dtype != torch.float32 or t.device != h.device:
            raise ValueError(f"bn_relu: {name} must be float32 [{c}] on {h.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bn_relu: unsupported device {h.device}")
    if h.device.type == "cuda":
        if not h.is_contiguous(memory_format=torch.channels_last):
            raise ValueError("bn_relu: h must be channels_last in memory on the card, got "
                             f"strides {h.stride()}")
        if not gamma.is_contiguous() or not beta.is_contiguous():
            raise ValueError("bn_relu: gamma and beta must be contiguous")
        if h.numel() == 0:
            raise ValueError("bn_relu: h is empty")
        chunk = 16 // h.element_size()
        if (c // chunk if c % chunk == 0 else c) > _MAX_CHUNKS:
            raise ValueError(f"bn_relu: {c} channels of {h.dtype} exceed the kernels' "
                             f"{_MAX_CHUNKS} chunks a row")


def _row_pitch(t: torch.Tensor):
    """The pitch in elements of ``t``'s rows ([N, C, H, W] with each
    (n, y, x) row of C contiguous values, rows evenly spaced), or None."""
    _, c, hh, ww = t.shape
    if t.is_contiguous(memory_format=torch.channels_last):
        return c
    s0, s1, s2, s3 = t.stride()
    if (s1 == 1 or c == 1) and s3 >= c and s2 == ww * s3 and s0 == hh * s2:
        return s3
    return None


def _vec(c: int, tensors, pitch: int = None) -> int:
    """1 when the kernels may read and write 16 bytes at a time."""
    chunk = 16 // tensors[0].element_size()
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    return int(c % chunk == 0 and aligned and (pitch is None or pitch % chunk == 0))


def rows_a_pass(c: int, chunk: int) -> int:
    """The rows a block of the op's kernels walks at once, when each
    thread reads ``chunk`` of a row's ``c`` channels at a time (16 bytes'
    worth, or 1): as many as _THREADS threads hold. The library launches
    blocks of this many rows' threads."""
    return _THREADS // (c // chunk)


def reduce_geometry(rows: int, c: int, chunk: int, max_blocks: int, capacity):
    """(blocks, cluster, launched) of a reduction over ``rows`` rows of
    ``c`` channels, ``chunk`` at a time: the logical grid, which fixes
    each block's rows and so its sums (at least 32 rows a thread, at most
    ``max_blocks`` blocks); the largest size of _CLUSTERS of which the
    card holds the grid's clusters at once (``capacity(k)``: clusters of
    k blocks resident together), else 1; and the blocks launched, the grid
    rounded up to whole clusters (the extra ones walk no rows)."""
    blocks = min(max_blocks, -(-rows // (rows_a_pass(c, chunk) * _MIN_ROWS)))
    for k in _CLUSTERS:
        clusters = -(-blocks // k)
        if blocks >= k and clusters <= capacity(k):
            return blocks, k, clusters * k
    return blocks, 1, blocks


def _capacity(index: int, backward: bool, c: int, chunk: int, bf16: int, k: int) -> int:
    """The clusters of ``k`` blocks of the reduction that device ``index``
    holds at once, as the library reports them (asked once a key)."""
    key = (index, backward, c, chunk, bf16, k)
    n = _CAPACITY.get(key)
    if n is None:
        n = _build.lib().annonet_bn_relu_clusters(int(backward), c, rows_a_pass(c, chunk), k,
                                                  int(chunk > 1), bf16, index)
        if n < 0:
            _build.check(-n, "annonet_bn_relu_clusters")
        _CAPACITY[key] = n
    return n


def _workspace(h: torch.Tensor, rows: int, vec: int, backward: bool):
    """(partial sums' pointer, tickets' pointer, stream, rows a pass, the
    second kernel's most blocks, the reduction's blocks and cluster) of
    ``h``'s device and current stream; the geometry is ``reduce_geometry``
    of the card's capacity for clusters."""
    index, c = h.device.index, h.shape[1]
    stream = torch._C._cuda_getCurrentRawStream(index)
    entry = _SCRATCH.get((index, stream))
    if entry is None or entry[2] < c:
        sms = torch.cuda.get_device_properties(h.device).multi_processor_count
        blocks = max(_FORWARD_BLOCKS_PER_SM, _BACKWARD_BLOCKS_PER_SM) * sms
        work = torch.zeros(8 + blocks * 2 * c, dtype=torch.float64, device=h.device)
        entry = _SCRATCH[(index, stream)] = [sms, work, c]
    sms, work, _c = entry
    max_blocks = (_BACKWARD_BLOCKS_PER_SM if backward else _FORWARD_BLOCKS_PER_SM) * sms
    chunk = 16 // h.element_size() if vec else 1
    capacity = functools.partial(_capacity, index, backward, c, chunk,
                                 int(h.dtype == torch.bfloat16))
    blocks, cluster, _launched = reduce_geometry(rows, c, chunk, max_blocks, capacity)
    return (work.data_ptr() + 64, work.data_ptr(), stream, rows_a_pass(c, chunk), max_blocks,
            blocks, cluster)


def _forward(h, gamma, beta):
    """The two forward launches: (y, buf [8, C] f32: mean, var, the
    backward's terms)."""
    c = h.shape[1]
    rows = h.numel() // c
    y = torch.empty_like(h)
    buf = torch.empty((8, c), dtype=torch.float32, device=h.device)
    vec = _vec(c, (h, y))
    partial, tickets, stream, per_pass, max_blocks, blocks, cluster = _workspace(
        h, rows, vec, False)
    code = _build.lib().annonet_bn_relu_forward(
        h.data_ptr(), y.data_ptr(), gamma.data_ptr(), beta.data_ptr(), buf.data_ptr(),
        partial, per_pass, max_blocks, blocks, cluster, tickets, rows, c, vec,
        int(h.dtype == torch.bfloat16), h.device.index, stream)
    _build.check(code, "annonet_bn_relu_forward")
    bn_relu.launches += 2
    bn_relu.cluster_reductions += int(cluster > 1)
    return y, buf


def _backward(h, gamma, buf, dy):
    """The two backward launches: (dh, dgamma, dbeta)."""
    c = h.shape[1]
    rows = h.numel() // c
    pitch = _row_pitch(dy)
    if pitch is None:
        dy = dy.contiguous(memory_format=torch.channels_last)
        pitch = c
        bn_relu.dy_copies += 1
    dh = torch.empty_like(h)
    dgamma = torch.empty(c, dtype=torch.float32, device=h.device)
    dbeta = torch.empty(c, dtype=torch.float32, device=h.device)
    vec = _vec(c, (h, dy, dh), pitch)
    partial, tickets, stream, per_pass, max_blocks, blocks, cluster = _workspace(
        h, rows, vec, True)
    code = _build.lib().annonet_bn_relu_backward(
        h.data_ptr(), dy.data_ptr(), pitch, dh.data_ptr(), gamma.data_ptr(),
        buf.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(), partial, per_pass, max_blocks,
        blocks, cluster, tickets, rows, c, vec, int(h.dtype == torch.bfloat16), h.device.index, stream)
    _build.check(code, "annonet_bn_relu_backward")
    bn_relu.launches += 2
    bn_relu.cluster_reductions += int(cluster > 1)
    return dh, dgamma, dbeta


class _BnRelu(torch.autograd.Function):
    """The kernels' forward and backward; mean and var carry no gradient
    (``_bn_update`` detaches them)."""

    @staticmethod
    def forward(ctx, h, gamma, beta):
        y, buf = _forward(h, gamma, beta)
        ctx.save_for_backward(h, gamma, buf)
        mean, var = buf[0], buf[1]
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        h, gamma, buf = ctx.saved_tensors
        return _backward(h, gamma, buf, dy)


def bn_relu(h, gamma, beta):
    """relu(batch norm of ``h`` over (N, H, W) with batch statistics):
    (y in ``h``'s dtype and layout, mean, var), as ``bn_relu_plain``."""
    _check(h, gamma, beta)
    if h.device.type == "cpu":
        return bn_relu_plain(h, gamma, beta)
    bn_relu.units += 1
    return _BnRelu.apply(h, gamma, beta)


def bn_relu_shards(hs, gammas, betas, reducer=None):
    """The unit's batch norm and ReLU over the shards ``hs`` (each with its
    own gamma and beta): (ys, mean, var), the statistics the first
    shard's. One shard without a ``reducer`` runs ``bn_relu`` (the kernels
    on the card); with one, ``bn_plain`` over every shard of the mesh."""
    if reducer is None:
        y, mean, var = bn_relu(hs[0], gammas[0], betas[0])
        return [y], mean, var
    zs, mean, var = bn_plain(hs, gammas, betas, reducer)
    return [torch.relu(z) for z in zs], mean, var


bn_relu.launches = 0
bn_relu.cluster_reductions = 0
bn_relu.units = 0
bn_relu.dy_copies = 0
