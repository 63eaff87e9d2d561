"""The training unit's batch norm and ReLU op (``ops/bn_relu.py``) on the
CPU: its closed-form backward against autograd over the eager unit
(``bn_plain`` and the ReLU), its autograd glue with the two launches
replaced by the plain versions, the layout rules that choose the kernels'
paths, and where ``apply_train`` engages it. The kernels themselves run in
tests/test_torch_cuda.py on the card.

The closed form and autograd compute the same f32 function in another
order, so each gradient is held within 1e-5 of its largest magnitude.
"""

import math
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from annonet_tpu_torch.models import segnet
from annonet_tpu_torch.ops import bn_relu as op

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5


def _moments_diff(h):
    """mean(h^2) - mean(h)^2 per channel, as ``bn_plain`` computes it."""
    mean, mean_sq = op.bn_moments(h)
    return mean_sq - mean.square()


def _case(n, c, hh, ww, seed):
    """(h, gamma, beta, dy) with gamma != 1, beta != 0; channel 0 constant
    at a value whose moments give a negative variance (the clamp engages),
    channel 1 killed by the ReLU everywhere (beta far below h's range)."""
    g = torch.Generator().manual_seed(seed)
    h = torch.randn((n, c, hh, ww), generator=g) * 1.5 + 0.25
    gamma = 0.5 + torch.rand(c, generator=g)
    beta = torch.randn(c, generator=g) * 0.3
    dy = torch.randn((n, c, hh, ww), generator=g)
    for value in np.linspace(0.1, 3.0, 60, dtype=np.float32):
        h[:, 0] = float(value)
        if _moments_diff(h)[0] < 0:
            break
    else:
        pytest.skip(f"no constant in the sweep gives a negative variance at {h.shape}")
    if c > 1:
        beta[1] = -100.0
    return h, gamma, beta, dy


def _autograd(h, gamma, beta, dy):
    h, gamma, beta = (t.clone().requires_grad_(True) for t in (h, gamma, beta))
    (z,), _mean, _var = op.bn_plain([h], [gamma], [beta])
    torch.relu(z).backward(dy)
    return h.grad, gamma.grad, beta.grad


def _close(got, want, what):
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= RTOL * max(scale, 1e-30), f"{what}: {err:.3e} of {scale:.3e}"


# (n, c, h, w): C of 3, 16, 64 and 128; N*H*W ragged (odd sides, primes)
SHAPES = [(2, 3, 7, 5), (1, 16, 13, 11), (3, 16, 8, 8), (2, 64, 5, 9), (1, 128, 3, 7),
          (4, 128, 6, 6)]


@pytest.mark.parametrize("n,c,h,w", SHAPES)
def test_closed_form_backward_matches_autograd(n, c, h, w):
    x, gamma, beta, dy = _case(n, c, h, w, seed=c * 100 + h)
    assert _moments_diff(x)[0] < 0  # the constant channel's clamp engages
    want = _autograd(x, gamma, beta, dy)
    got = op.bn_relu_backward_plain(x, gamma, beta, dy)
    for name, a, b in zip(("dh", "dgamma", "dbeta"), got, want):
        _close(a, b, name)
    if c > 1:  # the dead channel: no gradient reaches h, gamma or beta
        assert not got[0][:, 1].any() and got[1][1] == 0 and got[2][1] == 0


def test_closed_form_backward_in_bf16_matches_f32_autograd_of_the_same_values():
    """With bf16 h and dy the closed form computes in f32 from the bf16
    values and the bf16 scale and shift: autograd over the same graph
    with the casts made explicit gives the same gradients."""
    x, gamma, beta, dy = _case(2, 16, 9, 7, seed=5)
    xb, dyb = x.to(torch.bfloat16), dy.to(torch.bfloat16)
    got = op.bn_relu_backward_plain(xb, gamma, beta, dyb)
    x32 = xb.to(torch.float32).requires_grad_(True)
    g, b = gamma.clone().requires_grad_(True), beta.clone().requires_grad_(True)
    mean, mean_sq = op.bn_moments(x32)
    var = torch.clamp(mean_sq - mean.square(), min=0.0)
    inv = torch.rsqrt(var + op.BN_EPS)
    scale, shift = inv * g, b - mean * inv * g
    # the forward's bf16 values with an identity gradient (straight through)
    sb = scale + (scale.to(torch.bfloat16).float() - scale).detach()
    tb = shift + (shift.to(torch.bfloat16).float() - shift).detach()
    z = (xb * scale.to(torch.bfloat16)[:, None, None]
         + shift.to(torch.bfloat16)[:, None, None]).float()
    mask = (z > 0).float()
    (mask * (x32 * sb[:, None, None] + tb[:, None, None])).backward(dyb.float())
    for name, a, want in zip(("dh", "dgamma", "dbeta"), got, (x32.grad, g.grad, b.grad)):
        _close(a, want, name)


def test_bn_relu_on_the_cpu_is_the_eager_unit():
    x, gamma, beta, _ = _case(2, 16, 6, 10, seed=3)
    before = (op.bn_relu.units, op.bn_relu.launches)
    for dtype in (torch.float32, torch.bfloat16):
        h = x.to(dtype)
        y, mean, var = op.bn_relu(h, gamma, beta)
        (z,), mean0, var0 = op.bn_plain([h], [gamma], [beta])
        assert y.dtype == dtype
        assert torch.equal(y, torch.relu(z)) and torch.equal(mean, mean0)
        assert torch.equal(var, var0)
    assert (op.bn_relu.units, op.bn_relu.launches) == before  # no kernel on the CPU


def _emulated_launches(monkeypatch, beta):
    """The Function's two launches replaced by the plain versions (the
    backward's needs ``beta``, which the kernels read from the forward's
    buffer as the shift)."""

    def forward(h, gamma, beta_):
        y, mean, var = op.bn_relu_plain(h, gamma, beta_)
        buf = torch.zeros((8, h.shape[1]))
        buf[0], buf[1] = mean, var
        return y, buf

    def backward(h, gamma, buf, dy):
        dh, dgamma, dbeta = op.bn_relu_backward_plain(h, gamma, beta, dy)
        return dh.to(h.dtype), dgamma, dbeta

    monkeypatch.setattr(op, "_forward", forward)
    monkeypatch.setattr(op, "_backward", backward)


@pytest.mark.parametrize("remat", [False, True])
def test_autograd_function_glue(monkeypatch, remat):
    """``_BnRelu`` returns y, mean and var, gives h, gamma and beta their
    gradients, and none to mean and var; also under checkpoint (remat)."""
    x, gamma, beta, dy = _case(2, 16, 5, 6, seed=11)
    _emulated_launches(monkeypatch, beta)
    h, g, b = (t.clone().requires_grad_(True) for t in (x, gamma, beta))
    if remat:
        y, mean, var = checkpoint(op._BnRelu.apply, h, g, b, use_reentrant=False)
    else:
        y, mean, var = op._BnRelu.apply(h, g, b)
    assert not mean.requires_grad and not var.requires_grad
    y0, mean0, var0 = op.bn_relu_plain(x, gamma, beta)
    assert torch.equal(y, y0) and torch.equal(mean, mean0) and torch.equal(var, var0)
    (y * dy).sum().backward()
    for name, got, want in zip(("dh", "dgamma", "dbeta"), (h.grad, g.grad, b.grad),
                               _autograd(x, gamma, beta, dy)):
        _close(got, want, name)


def test_saved_rows_name_the_forward_buffer(monkeypatch):
    """``saved_rows`` reads the buffer the Function saved for its backward,
    row by row under the kernels' names."""
    x, gamma, beta, _ = _case(2, 16, 5, 6, seed=12)
    _emulated_launches(monkeypatch, beta)
    h = x.clone().requires_grad_(True)
    y, mean, var = op._BnRelu.apply(h, gamma, beta)
    rows = op.saved_rows(y)
    assert tuple(rows) == ("mean", "var", "inv", "scale", "shift", "diff", "a", "b")
    assert torch.equal(rows["mean"], mean) and torch.equal(rows["var"], var)


@pytest.mark.parametrize("n,c,h,w", SHAPES[:3])
def test_backward_terms_hold_the_closed_form_coefficients(n, c, h, w):
    """The terms the card's checks hold dh to: a and b from f64 sums agree
    with the f32 closed form's (checked against autograd above); each
    element's largest term is at least |a| and a third of |dh|."""
    x, gamma, beta, dy = _case(n, c, h, w, seed=c * 10 + w)
    terms, a, b = op.bn_relu_backward_terms(x, gamma, beta, dy)
    x32, _dz_scale, a32, b32, _dgamma, _dbeta = op._closed_form(x, gamma, beta, dy,
                                                                torch.float32)
    _close(a, a32, "a")
    _close(b, b32, "b")
    dh = _autograd(x, gamma, beta, dy)[0]
    assert terms.shape == dh.shape
    assert (terms >= a.abs()[:, None, None]).all()
    assert (3 * terms >= dh.abs() * (1 - RTOL)).all()


def test_row_pitch_reads_channels_last_rows_and_concat_slices():
    t = torch.empty((2, 16, 5, 7)).contiguous(memory_format=torch.channels_last)
    assert op._row_pitch(t) == 16
    cat = torch.cat([t, t], dim=1)  # channels_last, as the decoder's concat
    assert op._row_pitch(cat[:, :16]) == 32 and op._row_pitch(cat[:, 16:]) == 32
    assert op._row_pitch(torch.empty((2, 16, 5, 7))) is None  # NCHW
    assert op._row_pitch(t[:, :, :, ::2]) is None  # rows not evenly spaced
    assert op._row_pitch(torch.empty((2, 1, 5, 7))) == 1


def test_vector_path_needs_aligned_rows_of_whole_chunks():
    aligned = torch.empty(64, dtype=torch.bfloat16)
    assert op._vec(16, (aligned,)) == 1
    assert op._vec(12, (aligned,)) == 0  # 12 bf16 channels: 1.5 chunks a row
    assert op._vec(12, (aligned.float(),)) == 1  # 12 f32 channels: 3 chunks
    assert op._vec(16, (aligned[1:],)) == 0  # not 16-byte aligned
    assert op._vec(16, (aligned,), pitch=36) == 0  # a pitch of 4.5 chunks


# the reductions' launch geometry (ops/bn_relu.py reduce_geometry): (n, C,
# side) of the U-Net cell's five widths at batch 16 of 624² crops, the
# flagship cell's four at batch 128 of 192², and the U-Net's deep units at
# the CUDA tests' batch of 2
_GEOMETRY_SHAPES = [(16, 64, 624), (16, 128, 312), (16, 256, 156), (16, 512, 78),
                    (16, 1024, 39), (128, 16, 192), (128, 32, 96), (128, 64, 48),
                    (128, 128, 24), (2, 512, 78), (2, 1024, 39), (2, 64, 312)]
_SMS = 132  # an H100 SXM's


def _parent_grid(rows, c, chunk, max_blocks):
    """The reduction's grid as csrc/bn_relu.cu computed it before its
    clusters: blocks of (256 // lanes) * lanes threads, 32 rows a thread
    at least, at most max_blocks."""
    lanes = c // chunk
    per_pass = ((256 // lanes) * lanes) // lanes
    return min(max_blocks, math.ceil(rows / (per_pass * 32)))


@pytest.mark.parametrize("per_sm", [op._FORWARD_BLOCKS_PER_SM, op._BACKWARD_BLOCKS_PER_SM],
                         ids=["forward", "backward"])
@pytest.mark.parametrize("element_bytes", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("n,c,side", _GEOMETRY_SHAPES)
def test_reduce_geometry_keeps_the_logical_grid_in_whole_clusters(n, c, side, element_bytes,
                                                                  per_sm):
    """The logical grid is the formula's of before the clusters, so every
    block's rows and sums are; the launch is a whole number of clusters,
    fewer than one cluster over the grid; with room for every cluster the
    largest size that the grid fills is taken; the same arguments give the
    same geometry."""
    rows, chunk, max_blocks = n * side * side, 16 // element_bytes, per_sm * _SMS
    blocks, cluster, launched = op.reduce_geometry(rows, c, chunk, max_blocks, lambda k: 10**6)
    assert blocks == _parent_grid(rows, c, chunk, max_blocks)
    assert launched % cluster == 0 and blocks <= launched < blocks + cluster
    assert cluster == max(k for k in (1, 2, 4, 8, 16) if k <= blocks)
    assert op.reduce_geometry(rows, c, chunk, max_blocks, lambda k: 10**6) == (
        blocks, cluster, launched)


@pytest.mark.parametrize("capacity,want", [
    ({16: 24, 8: 50, 4: 99, 2: 198}, 8),  # 25 clusters of 16 do not fit, 50 of 8 do
    ({16: 25, 8: 50, 4: 99, 2: 198}, 16),
    ({16: 0, 8: 49, 4: 99, 2: 198}, 4),
    ({16: 0, 8: 0, 4: 98, 2: 198}, 2),
    ({16: 0, 8: 0, 4: 0, 2: 197}, 1),     # none fits: the block's own finish
])
def test_reduce_geometry_takes_the_largest_cluster_the_card_holds(capacity, want):
    """The U-Net stem's forward reduction (396 blocks, bf16): the largest
    size whose clusters, the grid rounded up, the card holds at once."""
    rows, max_blocks = 16 * 624 * 624, op._FORWARD_BLOCKS_PER_SM * _SMS
    blocks, cluster, launched = op.reduce_geometry(rows, 64, 8, max_blocks, capacity.get)
    assert (blocks, cluster) == (396, want)
    assert launched == -(-396 // want) * want


def test_the_bf16_backward_reductions_full_grid_takes_clusters_of_two():
    """An H100's capacity for the bf16 backward reduction (2 blocks an SM;
    cudaOccupancyMaxActiveClusters: 14, 30, 62 and 132 clusters of 16, 8, 4
    and 2): its 264-block grid fits in clusters of 2 alone."""
    h100 = {16: 14, 8: 30, 4: 62, 2: 132}.get
    rows, max_blocks = 16 * 624 * 624, op._BACKWARD_BLOCKS_PER_SM * _SMS
    assert op.reduce_geometry(rows, 64, 8, max_blocks, h100) == (264, 2, 264)


@pytest.mark.parametrize("rows,blocks,cluster,launched", [
    (16, 1, 1, 1), (1024, 1, 1, 1),      # one block: smaller than any cluster
    (3 * 1024, 3, 2, 4),                 # 3 blocks: one more that walks no rows
    (4500, 5, 4, 8),                     # 5 blocks: 3 more
    (9 * 1024, 9, 8, 16), (17 * 1024, 17, 16, 32),
])
def test_reduce_geometry_of_small_grids(rows, blocks, cluster, launched):
    """bf16 at 64 channels (32 rows a pass, 1024 a block): a grid of one
    block keeps a cluster of one, and the capacity is asked only for
    sizes that the grid fills."""
    asked = []

    def capacity(k):
        asked.append(k)
        return 10**6

    assert op.reduce_geometry(rows, 64, 8, 396, capacity) == (blocks, cluster, launched)
    assert all(k <= blocks for k in asked)


def test_workspace_asks_the_cards_capacity_once_a_shape(monkeypatch):
    """``_workspace`` with the library and the card stubbed (an H100's 132
    SMs and its capacities for the bf16 reductions): the U-Net stem's
    forward takes clusters of 16, its backward clusters of 2, each
    capacity asked of the library once for a width and dtype, whatever the
    rows, with the rows a pass that the launches take; the partial sums
    start after the 16 tickets' 64 bytes."""
    asked = []
    capacity = {False: {16: 28, 8: 62, 4: 124, 2: 264}, True: {16: 14, 8: 30, 4: 62, 2: 132}}

    class Lib:
        def annonet_bn_relu_clusters(self, backward, c, per_pass, k, vec, bf16, index):
            asked.append((backward, c, per_pass, k, vec, bf16))
            return capacity[bool(backward)][k]

    monkeypatch.setattr(op._build, "lib", Lib)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 7, raising=False)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: types.SimpleNamespace(multi_processor_count=_SMS))
    monkeypatch.setattr(op, "_SCRATCH", {})
    monkeypatch.setattr(op, "_CAPACITY", {})
    h = torch.empty((1, 64, 1, 1), dtype=torch.bfloat16)
    rows = 16 * 624 * 624
    forward = op._workspace(h, rows, 1, False)
    backward = op._workspace(h, rows, 1, True)
    assert forward[2:] == (7, 32, 396, 396, 16) and backward[2:] == (7, 32, 264, 264, 2)
    assert forward[0] == forward[1] + 64
    assert op._workspace(h, rows, 1, True) == backward
    # fewer rows: a smaller logical grid from the capacities already asked
    assert op._workspace(h, 2 * 312 * 312, 1, False)[2:] == (7, 32, 396, 191, 16)
    assert asked == [(0, 64, 32, 16, 1, 1), (1, 64, 32, 16, 1, 1), (1, 64, 32, 8, 1, 1),
                     (1, 64, 32, 4, 1, 1), (1, 64, 32, 2, 1, 1)]


@pytest.mark.parametrize("c,element_bytes,chunk,per_pass", [
    (64, 2, 8, 32), (1024, 2, 8, 2), (16, 2, 8, 128), (64, 4, 4, 16), (1024, 4, 4, 1),
    (24, 2, 1, 10), (256, 2, 1, 1),
])
def test_the_launches_take_their_blocks_from_rows_a_pass(c, element_bytes, chunk, per_pass):
    """The rows a block walks at once, which the library multiplies by the
    threads a row to size every kernel's blocks: whole rows of 16-byte
    chunks or elements within 256 threads."""
    assert op.rows_a_pass(c, chunk) == per_pass
    assert 0 < per_pass * (c // chunk) <= 256 < (per_pass + 1) * (c // chunk)


def test_wrapper_checks_its_arguments():
    h = torch.zeros((1, 4, 2, 2))
    with pytest.raises(ValueError, match="gamma"):
        op.bn_relu(h, torch.ones(3), torch.zeros(4))
    with pytest.raises(ValueError, match="beta"):
        op.bn_relu(h, torch.ones(4), torch.zeros(4, dtype=torch.float64))
    with pytest.raises(ValueError, match="h"):
        op.bn_relu(h.to(torch.int32), torch.ones(4), torch.zeros(4))


@pytest.mark.parametrize("topology,level_count,widths", [
    ("segnet", 3, [4, 4, 8, 8, 16, 16, 32, 32, 16, 16, 8, 8, 4, 4]),
    ("unet", 4, [4, 4, 8, 8, 16, 16, 32, 32, 64, 64, 32, 32, 16, 16, 8, 8, 4, 4]),
])
def test_apply_train_runs_the_op_in_every_unit_without_a_reducer(monkeypatch, topology,
                                                                  level_count, widths):
    """14 units in the flagship's depth (level 3), 18 in the U-Net's at
    level 4; the data-parallel path (a reducer) keeps bn_plain."""
    calls = []
    real = op.bn_relu

    def counting(*args):
        calls.append(args[0].shape[1])
        return real(*args)

    monkeypatch.setattr(op, "bn_relu", counting)
    config = segnet.SegNetConfig(class_count=3, level_count=level_count, base_width=4,
                                 topology=topology)
    params, stats = segnet.init_state(config, 0)
    p, s, _ = segnet.train_state_from_numpy(params, stats, None, "cpu")
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (1, 16, 16, 3),
                                                           dtype=np.uint8))
    segnet.apply_train(p, s, x, config)
    assert calls == widths


def test_module_imports_and_runs_on_the_cpu_without_nvcc():
    code = ("import torch\n"
            "from annonet_tpu_torch.ops import _build, bn_relu\n"
            "h = torch.randn(2, 8, 3, 3)\n"
            "y, m, v = bn_relu.bn_relu(h, torch.ones(8), torch.zeros(8))\n"
            "assert _build._lib is None and y.shape == h.shape\n"
            "print('ok')\n")
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME=os.path.join(_ROOT, "no-cuda"),
               PYTHONPATH=os.pathsep.join([_ROOT, os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
