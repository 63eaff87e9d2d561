"""G1's host side and plain version (annonet_tpu_torch/ops/gemm_conv.py)
against the JAX package's ``ops/pallas_conv.py`` on the CPU.

``build_gemm_kernels_aligned`` must equal JAX's bit for bit. The plain
version is held against the Pallas kernel in interpret mode, on weights
built from a 3x3 kernel and on random dense ``Wc``, ``Wl``, ``Wr`` (the
function is defined for any weights). Tolerances: both sum the same f32
products in another order and round once, so f32 agrees within 1e-5 of
the output scale, and bf16 within one bf16 step of each value (2**-7 of
its magnitude; 1e-6 of the scale more where a sum near zero meets the ReLU).
G1 itself runs only on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from annonet_tpu.ops import pallas_conv as jpc
from annonet_tpu_torch.ops import gemm_conv

# test_pallas_conv.py's three shapes and the RGB stem's: (n, h, wb, fold, cin, cout)
SHAPES = [(1, 8, 4, 8, 16, 16), (2, 16, 8, 8, 4, 8), (1, 4, 4, 4, 8, 4), (2, 8, 5, 8, 3, 16)]


@pytest.mark.parametrize("fold,cin,cout", [(8, 3, 16), (8, 16, 16), (4, 32, 32), (2, 64, 64),
                                           (2, 128, 64), (4, 6, 5), (1, 4, 4)])
def test_build_gemm_kernels_equal_jax(fold, cin, cout):
    w = np.random.default_rng(fold * cin + cout).normal(size=(3, 3, cin, cout)).astype(np.float32)
    for got, want in zip(gemm_conv.build_gemm_kernels_aligned(w, fold),
                         jpc.build_gemm_kernels_aligned(w, fold)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def _case(n, h, wb, fold, cin, cout, dense, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, wb, fold * cin)).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    if dense:
        mats = [(rng.normal(size=(3 * fold * cin, fold * cout)) * 0.2).astype(np.float32)
                for _ in range(3)]
    else:
        mats = jpc.build_gemm_kernels_aligned(
            rng.normal(size=(3, 3, cin, cout)).astype(np.float32), fold)
    return x, mats, b


def _jax(x, mats, b, fold, cin, dtype):
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    rows = next(r for r in (8, 4, 2, 1) if x.shape[1] % r == 0)
    out = jpc.conv3x3_gemm_aligned(jnp.asarray(x, jd), *(jnp.asarray(m) for m in mats),
                                   jnp.asarray(b), fold, cin, rows=rows, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _port(x, mats, b, fold, cin, dtype):
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dtype)  # noqa: E731
    out = gemm_conv.conv3x3_gemm_aligned(t(x), *(t(m) for m in mats),
                                         torch.from_numpy(b), fold, cin)
    assert out.dtype == dtype
    return out.float().numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("dense", [False, True], ids=["built", "dense"])
@pytest.mark.parametrize("n,h,wb,fold,cin,cout", SHAPES)
def test_plain_matches_pallas_interpret(n, h, wb, fold, cin, cout, dense, dtype):
    x, mats, b = _case(n, h, wb, fold, cin, cout, dense, seed=n + h + wb + cin)
    if dtype == torch.bfloat16:  # both sides see the same bf16 inputs
        x = np.asarray(torch.from_numpy(x).to(dtype).float())
        mats = [np.asarray(torch.from_numpy(m).to(dtype).float()) for m in mats]
    got = _port(x, mats, b, fold, cin, dtype)
    want = _jax(x, mats, b, fold, cin, dtype)
    assert got.shape == want.shape == (n, h, wb, fold * cout)
    scale = np.abs(want).max()
    assert (want > 0).mean() > 0.2 and (want == 0).any()  # the ReLU both clips and passes
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    else:
        step = 2.0**-7 * np.maximum(np.abs(got), np.abs(want)) + 1e-6 * scale
        assert (np.abs(got - want) <= step).all()


def test_plain_equals_the_unfolded_conv():
    """Built weights: G1's function is the NHWC 3x3 conv (K1's plain version)."""
    from annonet_tpu_torch.ops.conv import conv3x3_bias_relu_plain

    n, h, w, fold, cin, cout = 2, 6, 24, 8, 3, 16
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(n, h, w, cin)).astype(np.float32))
    k = rng.normal(size=(3, 3, cin, cout)).astype(np.float32)
    b = torch.from_numpy(rng.normal(size=(cout,)).astype(np.float32))
    mats = [torch.from_numpy(m) for m in gemm_conv.build_gemm_kernels_aligned(k, fold)]
    got = gemm_conv.conv3x3_gemm_aligned(x.view(n, h, w // fold, fold * cin), *mats, b,
                                         fold, cin)
    want = conv3x3_bias_relu_plain(x, torch.from_numpy(k), b)
    torch.testing.assert_close(got.view(n, h, w, cout), want, rtol=1e-5, atol=1e-5)


def test_cpu_tensors_take_the_plain_version_without_counting():
    x, mats, b = _case(1, 4, 4, 4, 8, 4, False, 0)
    before = gemm_conv.conv3x3_gemm_aligned.launches
    _port(x, mats, b, 4, 8, torch.float32)
    assert gemm_conv.conv3x3_gemm_aligned.launches == before


@pytest.mark.parametrize(
    "change", ["weight_dtype", "bias_dtype", "fold_cin", "weight_shape", "strided", "device"]
)
def test_wrapper_rejects_bad_arguments(change):
    x, mats, b = _case(1, 4, 4, 4, 8, 4, False, 0)
    x, b = torch.from_numpy(x), torch.from_numpy(b)
    mats = [torch.from_numpy(m) for m in mats]
    fold, cin = 4, 8
    if change == "weight_dtype":
        mats[1] = mats[1].double()
    elif change == "bias_dtype":
        b = b.to(torch.bfloat16)
    elif change == "fold_cin":
        cin = 4
    elif change == "weight_shape":
        mats[2] = mats[2][:-1].contiguous()
    elif change == "strided":
        x = x.transpose(1, 2)
    else:
        x = x.to("meta")
    with pytest.raises(ValueError):
        gemm_conv.conv3x3_gemm_aligned(x, *mats, b, fold, cin)


# --------------------------------------------------------------------------
# the tables of nonzero blocks that the kernels walk: 32 x 32 blocks for
# bf16, 16 x 16 for f32 (block_sizes)
# --------------------------------------------------------------------------

DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])


def _mats(mats, dtype):
    return [torch.from_numpy(np.asarray(m)).to(dtype) for m in mats]


def _banded_blocks(fold, cin, cout, dtype):
    """The (segment, dy, rows, columns) blocks that hold a nonzero weight of
    build_gemm_kernels_aligned, from the band itself: Wc links input pixel i
    to output pixel j when |i - j| <= 1, Wl input fold-1 to output 0, Wr
    input 0 to output fold-1."""
    kc, slab, _group = gemm_conv.block_sizes(dtype)
    k1, nc = fold * cin, fold * cout
    i = np.arange(k1)[:, None] // cin
    j = np.arange(nc)[None, :] // cout
    bands = [np.abs(i - j) <= 1, (i == fold - 1) & (j == 0), (i == 0) & (j == fold - 1)]
    want = set()
    for s, band in enumerate(bands):
        for dy in range(3):
            for r0 in range(0, k1, kc):
                for n0 in range(0, nc, slab):
                    r1, n1 = min(k1, r0 + kc), min(nc, n0 + slab)
                    if band[r0:r1, n0:n1].any():
                        want.add((s, dy, (r0, r1), (n0, n1)))
    return want


def _drop_first_block(table, nc):
    """``table`` (of NC columns) with the first block it lists left out."""
    dropped = table.clone()
    if gemm_conv.table_dtype(table) == torch.float32:
        first = 1 + -(-(int(table[0, 2]) + 1) // gemm_conv.G1F_REC)  # the first record
        slab = int(np.flatnonzero(table[first, 1:9].numpy() >= 0)[0])
        dropped[first, 1 + slab] = -1
    else:
        groups = -(-nc // gemm_conv.G1_GROUP)
        dropped[groups + 1] &= ~15  # the first entry lists no slab
    return dropped


@DTYPES
@pytest.mark.parametrize("fold,cin,cout", [(8, 3, 16), (8, 16, 16), (8, 32, 16), (4, 32, 32),
                                           (4, 6, 5), (2, 64, 64), (2, 128, 64)])
def test_block_table_lists_exactly_the_banded_blocks(fold, cin, cout, dtype):
    w = np.random.default_rng(cin + cout).normal(size=(3, 3, cin, cout)).astype(np.float32)
    mats = _mats(gemm_conv.build_gemm_kernels_aligned(w, fold), dtype)
    table = gemm_conv.g1_block_table(*mats)
    assert table.dtype == torch.int32 and gemm_conv.table_dtype(table) == dtype
    got = list(gemm_conv.table_blocks(table, fold * cin, fold * cout))
    assert len(got) == len(set(got)) and set(got) == _banded_blocks(fold, cin, cout, dtype)
    dense = 9 * fold * cin * fold * cout
    macs = gemm_conv.table_macs(table, fold * cin, fold * cout)
    if dtype == torch.bfloat16:
        # at most half of the dense GEMM, once the columns span more than one slab
        assert (2 * macs <= dense) if fold * cout > gemm_conv.G1_SLAB else macs <= dense
    elif cin % 16 == 0 and cout % 16 == 0:
        # 16 x 16 blocks list exactly the conv's products, 9 taps of cin by
        # cout for each of the fold output pixels of a GEMM row
        assert macs == 9 * fold * cin * cout
    else:
        assert macs < dense
        if (fold, cin, cout) == (8, 3, 16):  # the RGB stem: K1 = 24 in 16-row chunks
            assert macs == 8064


@DTYPES
@pytest.mark.parametrize("k1,nc", [(24, 128), (128, 128), (256, 128), (12, 20), (40, 136)])
def test_block_table_of_dense_weights_lists_every_block(k1, nc, dtype):
    rng = np.random.default_rng(k1 + nc)
    mats = _mats([rng.normal(size=(3 * k1, nc)).astype(np.float32) for _ in range(3)], dtype)
    table = gemm_conv.g1_block_table(*mats)
    blocks = list(gemm_conv.table_blocks(table, k1, nc))
    kc, slab, _group = gemm_conv.block_sizes(dtype)
    chunks, slabs = -(-k1 // kc), -(-nc // slab)
    assert len(blocks) == len(set(blocks)) == 9 * chunks * slabs
    assert gemm_conv.table_macs(table, k1, nc) == 9 * k1 * nc


@DTYPES
@pytest.mark.parametrize("dense", [False, True], ids=["built", "dense"])
@pytest.mark.parametrize("n,h,wb,fold,cin,cout", SHAPES)
def test_plain_restricted_to_the_table_equals_the_full_plain(n, h, wb, fold, cin, cout, dense,
                                                             dtype):
    """Every block the table leaves out is zero, so the restricted product
    is the full one, bit for bit, on built and on dense weights."""
    x, mats, b = _case(n, h, wb, fold, cin, cout, dense, seed=7 * n + h + wb + cin)
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dtype)  # noqa: E731
    x, mats, b = t(x), [t(m) for m in mats], torch.from_numpy(b)
    table = gemm_conv.g1_block_table(*mats)
    restricted = gemm_conv.restrict_to_table(*mats, table)
    for got, want in zip(restricted, mats):
        assert torch.equal(got, want)
    full = gemm_conv.conv3x3_gemm_aligned_plain(x, *mats, b, fold, cin)
    assert torch.equal(gemm_conv.conv3x3_gemm_aligned(x, *mats, b, fold, cin, table), full)
    # a table that drops a listed block changes the result
    if not dense:
        dropped = _drop_first_block(table, fold * cout)
        assert not torch.equal(
            gemm_conv.conv3x3_gemm_aligned_plain(x, *mats, b, fold, cin, dropped), full)


@pytest.mark.parametrize("dense", [False, True], ids=["built", "dense"])
@pytest.mark.parametrize("n,h,wb,fold,cin,cout", SHAPES)
def test_plain_restricted_to_the_f32_table_matches_pallas_interpret(n, h, wb, fold, cin, cout,
                                                                    dense):
    """What the f32 kernel multiplies (the plain version over the f32
    table's blocks) against the Pallas kernel in interpret mode, in f32."""
    x, mats, b = _case(n, h, wb, fold, cin, cout, dense, seed=5 * n + h + wb + cin)
    tm = _mats(mats, torch.float32)
    table = gemm_conv.g1_block_table(*tm)
    assert gemm_conv.table_dtype(table) == torch.float32
    got = gemm_conv.conv3x3_gemm_aligned(torch.from_numpy(x), *tm, torch.from_numpy(b), fold,
                                         cin, table).numpy()
    want = _jax(x, mats, b, fold, cin, torch.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@DTYPES
def test_a_table_of_the_other_dtype_is_refused(dtype):
    """Each kernel walks its own layout and block sizes: a table built from
    weights of the other dtype never reaches it."""
    other = torch.bfloat16 if dtype == torch.float32 else torch.float32
    x, mats, b = _case(1, 4, 4, 4, 8, 4, False, 0)
    table = gemm_conv.g1_block_table(*_mats(mats, other))
    assert gemm_conv.table_dtype(table) == other
    with pytest.raises(ValueError, match="built for"):
        gemm_conv.conv3x3_gemm_aligned(torch.from_numpy(x).to(dtype), *_mats(mats, dtype),
                                       torch.from_numpy(b), 4, 8, table)
    with pytest.raises(ValueError):
        gemm_conv.g1_block_table(*_mats(mats, torch.float64))


@pytest.mark.parametrize("other", [(4, 4, 4), (4, 8, 8), (2, 8, 4)], ids=["k1", "nc", "both"])
def test_an_f32_table_of_another_layer_is_refused(other):
    """The f32 table's header names the K1 and NC it was built for: the
    plain version refuses a table of another layer's shape (the kernel
    reads the same header)."""
    x, mats, b = _case(1, 4, 4, 4, 8, 4, False, 0)
    fold, cin, cout = other
    _x, other_mats, _b = _case(1, 4, 4, fold, cin, cout, False, 1)
    table = gemm_conv.g1_block_table(*_mats(other_mats, torch.float32))
    with pytest.raises(ValueError, match="not an f32 G1 table of K1 32, NC 16"):
        gemm_conv.conv3x3_gemm_aligned(torch.from_numpy(x), *_mats(mats, torch.float32),
                                       torch.from_numpy(b), 4, 8, table)


@pytest.mark.parametrize("fold,cin,cout,concat", [
    (8, 16, 16, False), (4, 32, 32, False), (2, 64, 64, False), (8, 3, 16, False),
    (8, 32, 16, False),
    # the decoder's layers: rows of [up, skip] (the folded net's _concat_perm)
    (8, 32, 16, True), (4, 64, 32, True), (2, 128, 64, True)])
def test_f32_schedule_header_stages_and_steps(fold, cin, cout, concat):
    """The f32 table's header holds K1, NC and the group count; each stage (row tap dy,
    span of G1F_SPAN K rows) has at least G1F_MIN_STEPS steps, its first
    step names the next stage; and on the flagship's layers (cin, cout
    multiples of 16; K1 = 256 only at the decoder, each span one half of
    its concat) every slab has a block at every step, so no warp of the
    f32 kernel waits."""
    from annonet_tpu_torch.models.folded_runtime import _concat_perm

    w = np.random.default_rng(fold + cin).normal(size=(3, 3, cin, cout)).astype(np.float32)
    mats = gemm_conv.build_gemm_kernels_aligned(w, fold)
    k1, nc = fold * cin, fold * cout
    if concat:
        perm = np.concatenate([_concat_perm(fold, cin // 2, cin // 2) + dy * k1
                               for dy in range(3)])
        mats = [m[perm] for m in mats]
    t = gemm_conv.g1_block_table(*_mats(mats, torch.float32)).numpy()
    groups = -(-nc // gemm_conv.G1F_GROUP)
    assert list(t[0]) == [k1, nc, groups] + [0] * (gemm_conv.G1F_REC - 3)
    off_rows = -(-(groups + 1) // gemm_conv.G1F_REC)
    records = t[1 + off_rows :]
    assert t[1 : 1 + off_rows].reshape(-1)[groups] == len(records)
    stages = [i for i, r in enumerate(records) if r[9]]
    ends = stages[1:] + [len(records)]
    assert all(e - s >= gemm_conv.G1F_MIN_STEPS for s, e in zip(stages, ends))
    assert [records[s][10] for s in stages] == [records[s][0] for s in stages[1:]] + [-1]
    assert all((records[s:e, 0] == records[s][0]).all() for s, e in zip(stages, ends))
    balanced = (records[:, 1:9] >= 0).all()
    if cin % 16 == 0 and cout % 16 == 0 and (k1 <= gemm_conv.G1F_SPAN or concat):
        assert balanced
    elif (fold, cin, cout) == (8, 32, 16):
        # a plain fold-8 conv of 32 channels: span 0 holds pixels 0-3 only
        assert not balanced


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_folded_net_builds_the_tables_of_its_dtype(compute_dtype):
    """FoldedSegNet builds each G1 layer's table from its own parameters:
    16 x 16 blocks for an f32 config, 32 x 32 for a bf16 one, each the
    nonzero blocks of that layer's weights."""
    from annonet_tpu_torch.models.folded_runtime import FoldedSegNet, folding_supported
    from annonet_tpu_torch.models.segnet import SegNetConfig, init_runtime_params

    config = SegNetConfig(class_count=3, level_count=2, base_width=8,
                          compute_dtype=compute_dtype)
    net = FoldedSegNet(init_runtime_params(config, 0), config, folding_supported(config, 64),
                       device="cpu")
    dtype = torch.float32 if compute_dtype == "float32" else torch.bfloat16
    names = [name for kind, name, _f in net.entries if kind.startswith("s1p:")]
    assert names
    for name in names:
        mats = [net.param(name, k) for k in ("wc", "wl", "wr")]
        table = net.param(name, "table")
        assert mats[0].dtype == dtype and gemm_conv.table_dtype(table) == dtype
        k1, nc = mats[0].shape[0] // 3, mats[0].shape[1]
        kc, slab, _group = gemm_conv.block_sizes(dtype)
        listed = set(gemm_conv.table_blocks(table, k1, nc))
        nonzero = {(s, dy, (r0, min(k1, r0 + kc)), (n0, min(nc, n0 + slab)))
                   for s, m in enumerate(mats) for dy in range(3)
                   for r0 in range(0, k1, kc) for n0 in range(0, nc, slab)
                   if (m[dy * k1 + r0 : dy * k1 + min(k1, r0 + kc), n0 : n0 + slab] != 0).any()}
        assert listed == nonzero
