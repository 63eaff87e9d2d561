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
# the table of nonzero blocks that the bf16 kernel walks
# --------------------------------------------------------------------------


def _banded_blocks(fold, cin, cout):
    """The (segment, dy, rows, columns) blocks that hold a nonzero weight of
    build_gemm_kernels_aligned, from the band itself: Wc links input pixel i
    to output pixel j when |i - j| <= 1, Wl input fold-1 to output 0, Wr
    input 0 to output fold-1."""
    k1, nc = fold * cin, fold * cout
    i = np.arange(k1)[:, None] // cin
    j = np.arange(nc)[None, :] // cout
    bands = [np.abs(i - j) <= 1, (i == fold - 1) & (j == 0), (i == 0) & (j == fold - 1)]
    want = set()
    for s, band in enumerate(bands):
        for dy in range(3):
            for r0 in range(0, k1, gemm_conv.G1_KC):
                for n0 in range(0, nc, gemm_conv.G1_SLAB):
                    r1, n1 = min(k1, r0 + gemm_conv.G1_KC), min(nc, n0 + gemm_conv.G1_SLAB)
                    if band[r0:r1, n0:n1].any():
                        want.add((s, dy, (r0, r1), (n0, n1)))
    return want


@pytest.mark.parametrize("fold,cin,cout", [(8, 3, 16), (8, 16, 16), (8, 32, 16), (4, 32, 32),
                                           (4, 6, 5), (2, 64, 64), (2, 128, 64)])
def test_block_table_lists_exactly_the_banded_blocks(fold, cin, cout):
    w = np.random.default_rng(cin + cout).normal(size=(3, 3, cin, cout)).astype(np.float32)
    mats = [torch.from_numpy(m) for m in gemm_conv.build_gemm_kernels_aligned(w, fold)]
    table = gemm_conv.g1_block_table(*mats)
    assert table.dtype == torch.int32
    got = list(gemm_conv.table_blocks(table, fold * cin, fold * cout))
    assert len(got) == len(set(got)) and set(got) == _banded_blocks(fold, cin, cout)
    # what the kernel multiplies: at most half of the dense GEMM, once the
    # columns span more than one slab
    dense = 9 * fold * cin * fold * cout
    macs = gemm_conv.table_macs(table, fold * cin, fold * cout)
    assert (2 * macs <= dense) if fold * cout > gemm_conv.G1_SLAB else macs <= dense


@pytest.mark.parametrize("k1,nc", [(24, 128), (128, 128), (256, 128), (12, 20), (40, 136)])
def test_block_table_of_dense_weights_lists_every_block(k1, nc):
    rng = np.random.default_rng(k1 + nc)
    mats = [torch.from_numpy(rng.normal(size=(3 * k1, nc)).astype(np.float32)) for _ in range(3)]
    table = gemm_conv.g1_block_table(*mats)
    blocks = list(gemm_conv.table_blocks(table, k1, nc))
    chunks, slabs = -(-k1 // gemm_conv.G1_KC), -(-nc // gemm_conv.G1_SLAB)
    assert len(blocks) == len(set(blocks)) == 9 * chunks * slabs
    assert gemm_conv.table_macs(table, k1, nc) == 9 * k1 * nc


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
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
        groups = -(-fold * cout // gemm_conv.G1_GROUP)
        dropped = table.clone()
        dropped[groups + 1] &= ~15  # the first entry lists no slab
        assert not torch.equal(
            gemm_conv.conv3x3_gemm_aligned_plain(x, *mats, b, fold, cin, dropped), full)
