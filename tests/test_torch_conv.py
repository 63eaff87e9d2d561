"""The port's fused conv kernels K1-K3 (annonet_tpu_torch/ops/conv.py), as
they run on the CPU (their plain versions), against the JAX package: the
runtime net's XLA convs (models/segnet.py ``_conv`` / ``_conv_transpose``
plus bias and ReLU, as ``apply_runtime`` applies them) and the Pallas TPU
kernels they replace, run in interpret mode on width-folded inputs.

Tolerances: in f32 both sides sum the same products in another order
(rtol = atol = 1e-5). In bf16 both round the conv sum to bf16, add the f32
bias and round again, but each framework's CPU conv accumulates in its own
order, so a value may land a bf16 rounding step or two away: held to
2**-6 (two bf16 steps) of the layer's largest output.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from annonet_tpu.models.folded_runtime import (
    _fold_s1_kernel,
    _fold_s2_kernel,
    _fold_up_kernel,
)
from annonet_tpu.models.segnet import _conv, _conv_transpose
from annonet_tpu.ops.int8_conv_mosaic import (
    fconv3x3_s1_bias_relu,
    fconv3x3_s2_bias_relu,
    fup_bias_relu,
)
from annonet_tpu.ops.pallas_conv import build_gemm_kernels_aligned, conv3x3_gemm_aligned
from annonet_tpu_torch.ops.conv import (
    conv3x3_bias_relu,
    conv3x3_s2_bias_relu,
    up2x2_bias_relu,
)

F32_TOL = 1e-5
BF16_TOL = 2.0**-6
_DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(seed, n, h, w, cin, cout, k):
    rng = np.random.default_rng(seed)
    x = rng.random((n, h, w, cin)).astype(np.float32) - 0.25
    wgt = (rng.standard_normal((k, k, cin, cout)) * (2.0 / (k * k * cin)) ** 0.5).astype(
        np.float32
    )
    bias = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return x, wgt, bias


def _jax_unit(x, w, b, dtype, kind):
    """apply_runtime's cbr / ubr: conv in the compute dtype + f32 bias,
    ReLU, back to the compute dtype."""
    xj, wj = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    if kind == "up":
        h = _conv_transpose(xj, wj, dtype)
    else:
        h = _conv(xj, wj, 2 if kind == "s2" else 1, dtype)
    return np.asarray(jnp.maximum(h + jnp.asarray(b), 0.0).astype(dtype).astype(jnp.float32))


def _port(x, w, b, dtype, kind, x2=None):
    fn = {"s1": conv3x3_bias_relu, "s2": conv3x3_s2_bias_relu, "up": up2x2_bias_relu}[kind]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    extra = {} if x2 is None else {"x2": t(x2).to(dtype)}
    out = fn(t(x).to(dtype), t(w).to(dtype), t(b), **extra)
    assert out.dtype == dtype and out.is_contiguous()
    return out.float().numpy()


def _close(got, want, dtype_name):
    tol = F32_TOL if dtype_name == "float32" else BF16_TOL * max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=tol if dtype_name == "float32" else 0, atol=tol)


# (kind, n, h, w, c1, c2, cout): the first seven at n, h, w = 2, 16, 24 with
# their earlier ids; then every K1/K2 shape that tests/test_torch_cuda.py
# gives the kernels on the card (grayscale and RGB stems, concats with
# c1 % 8 != 0, the decoder's 16+16 and 64+64, 128 -> 128, two cout slabs,
# n = 3 with an odd H, stride 2 with odd cout; then f32's edges: concats
# with c1 or c2 % 4 != 0, cout 32, stride 2 on 3 x 3 tiles)
_SHAPES = [
    pytest.param(kind, 2, 16, 24, cin, 0, cout, id=f"{kind}-{cin}-{cout}")
    for kind, cin, cout in [("s1", 3, 16), ("s1", 16, 16), ("s1", 32, 8), ("s2", 16, 32),
                            ("s2", 8, 4), ("up", 32, 16), ("up", 12, 20)]
] + [
    ("s1", 1, 17, 45, 3, 0, 20), ("s1", 2, 8, 40, 5, 7, 9), ("s1", 1, 33, 70, 40, 24, 48),
    ("s2", 1, 18, 66, 6, 0, 40), ("s2", 3, 10, 34, 16, 0, 8),
    ("s1", 2, 19, 100, 1, 0, 16), ("s1", 1, 24, 90, 3, 0, 16), ("s1", 1, 16, 72, 12, 20, 16),
    ("s1", 2, 16, 70, 16, 16, 16), ("s1", 1, 12, 40, 64, 64, 64), ("s1", 1, 14, 28, 128, 0, 128),
    ("s1", 1, 6, 20, 24, 0, 136), ("s1", 3, 9, 30, 8, 0, 24),
    ("s2", 2, 32, 100, 16, 0, 32), ("s2", 1, 16, 36, 64, 0, 128), ("s2", 1, 18, 66, 16, 0, 9),
    ("s2", 1, 10, 70, 64, 0, 20),
    ("s1", 1, 10, 36, 6, 16, 32), ("s1", 1, 10, 36, 16, 6, 32), ("s1", 1, 20, 50, 32, 0, 32),
    ("s2", 1, 34, 260, 16, 0, 32), ("s2", 1, 34, 140, 64, 0, 128),
    ("s1", 3, 11, 40, 8, 0, 32),
]


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,n,h,w,c1,c2,cout", _SHAPES)
def test_kernel_plain_versions_match_jax_runtime_convs(kind, n, h, w, c1, c2, cout, dtype_name):
    cin = c1 + c2
    x, wgt, b = _inputs(cin * 100 + cout, n, h, w, cin, cout, 2 if kind == "up" else 3)
    tdt, jdt = _DTYPES[dtype_name]
    if c2:  # the decoder's concat: the port takes its two parts apart
        parts = np.ascontiguousarray(x[..., :c1]), np.ascontiguousarray(x[..., c1:])
        got = _port(parts[0], wgt, b, tdt, kind, x2=parts[1])
    else:
        got = _port(x, wgt, b, tdt, kind)
    want = _jax_unit(x, wgt, b, jdt, kind)
    assert got.shape == want.shape
    _close(got, want, dtype_name)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_two_input_conv_is_the_decoder_concat(dtype_name):
    """K1's second input: conv over concat([x, x2]) without the concat."""
    x, w, b = _inputs(7, 2, 16, 16, 24, 12, 3)
    x1, x2 = np.ascontiguousarray(x[..., :12]), np.ascontiguousarray(x[..., 12:])
    tdt, jdt = _DTYPES[dtype_name]
    got = _port(x1, w, b, tdt, "s1", x2=x2)
    cat = torch.cat([torch.from_numpy(x1), torch.from_numpy(x2)], dim=-1).to(tdt)
    h = F.conv2d(cat.permute(0, 3, 1, 2), torch.from_numpy(w).to(tdt).permute(3, 2, 0, 1),
                 padding=1)
    want = torch.relu(h.permute(0, 2, 3, 1).float() + torch.from_numpy(b)).to(tdt)
    np.testing.assert_array_equal(got, want.float().numpy())
    _close(got, _jax_unit(x, w, b, jdt, "s1"), dtype_name)


# The Pallas kernels run on the TPU's width-folded layout: fold 8 pixels x
# 16 channels = 128 lanes, H = 16, WB = 4 width blocks (W = 32).
FOLD, H, WB, CIN = 8, 16, 4, 16


def _folded_case(seed, cout, k, cin=CIN):
    x, w, b = _inputs(seed, 2, H, WB * FOLD, cin, cout, k)
    return x, w, b, jnp.asarray(x.reshape(2, H, WB, FOLD * cin))


@pytest.mark.parametrize("cout", [16, 8, 32])
def test_k1_matches_pallas_fconv3x3_s1(cout):
    x, w, b, xf = _folded_case(1, cout, 3)
    wf = _fold_s1_kernel(w, FOLD)  # [3, 3, fold*cin, fold*cout]
    taps = [jnp.asarray(wf[:, t].reshape(3 * FOLD * CIN, FOLD * cout)) for t in range(3)]
    out = fconv3x3_s1_bias_relu(xf, *taps, jnp.asarray(np.tile(b, FOLD)), rows=8,
                                interpret=True)
    want = np.asarray(out).reshape(2, H, WB * FOLD, cout)
    _close(_port(x, w, b, torch.float32, "s1"), want, "float32")


@pytest.mark.parametrize("cout", [32, 16, 64])
def test_k2_matches_pallas_fconv3x3_s2(cout):
    x, w, b, xf = _folded_case(2, cout, 3)
    wf = _fold_s2_kernel(w, FOLD)  # [3, 2, fold*cin, fold/2*cout]
    taps = [jnp.asarray(wf[:, t].reshape(3 * FOLD * CIN, FOLD // 2 * cout)) for t in range(2)]
    out = fconv3x3_s2_bias_relu(xf, *taps, jnp.asarray(np.tile(b, FOLD // 2)), rows=4,
                                interpret=True)
    want = np.asarray(out).reshape(2, H // 2, WB * FOLD // 2, cout)
    _close(_port(x, w, b, torch.float32, "s2"), want, "float32")


# 16 -> 8 and 16 -> 16, then the flagship's three up layers' widths
@pytest.mark.parametrize("cin,cout", [pytest.param(16, 8, id="8"), pytest.param(16, 16, id="16"),
                                      (128, 64), (64, 32), (32, 16)])
def test_k3_matches_pallas_fup(cin, cout):
    x, w, b, xf = _folded_case(3, cout, 2, cin)
    wf = _fold_up_kernel(w, FOLD)  # [2, 1, fold*cin, 2*fold*cout]
    out = fup_bias_relu(xf, jnp.asarray(wf[1, 0]), jnp.asarray(wf[0, 0]),
                        jnp.asarray(np.tile(b, 2 * FOLD)), rows=8, interpret=True)
    want = np.asarray(out).reshape(2, 2 * H, 2 * WB * FOLD, cout)
    _close(_port(x, w, b, torch.float32, "up"), want, "float32")


@pytest.mark.parametrize("fold,cin,cout", [(8, 16, 16), (4, 8, 4)])
def test_k1_matches_pallas_conv3x3_gemm_aligned(fold, cin, cout):
    x, w, b = _inputs(4, 1, 8, 8 * fold, cin, cout, 3)
    wc, wl, wr = build_gemm_kernels_aligned(w, fold)
    out = conv3x3_gemm_aligned(
        jnp.asarray(x.reshape(1, 8, 8, fold * cin)), jnp.asarray(wc), jnp.asarray(wl),
        jnp.asarray(wr), jnp.asarray(b), fold, cin, rows=8, interpret=True,
    )
    want = np.asarray(out).reshape(1, 8, 8 * fold, cout)
    _close(_port(x, w, b, torch.float32, "s1"), want, "float32")


def test_cpu_tensors_take_the_plain_version_without_counting():
    x, w, b = _inputs(5, 1, 8, 8, 4, 8, 3)
    before = (conv3x3_bias_relu.launches, conv3x3_s2_bias_relu.launches,
              up2x2_bias_relu.launches)
    _port(x, w, b, torch.float32, "s1")
    _port(x, w, b, torch.float32, "s2")
    _port(x, w[:2, :2], b, torch.float32, "up")
    assert (conv3x3_bias_relu.launches, conv3x3_s2_bias_relu.launches,
            up2x2_bias_relu.launches) == before


@pytest.mark.parametrize(
    "change", ["weight_dtype", "bias_dtype", "cin", "kernel_size", "strided", "odd_height", "x2"]
)
def test_wrappers_reject_bad_arguments(change):
    x, w, b = (torch.from_numpy(a) for a in _inputs(6, 1, 8, 8, 4, 8, 3))
    fn, extra = conv3x3_bias_relu, {}
    if change == "weight_dtype":
        w = w.double()
    elif change == "bias_dtype":
        b = b.to(torch.bfloat16)
    elif change == "cin":
        x = x[..., :3].contiguous()
    elif change == "kernel_size":
        w = w[:2, :2].contiguous()
    elif change == "strided":
        x = x.transpose(1, 2)
    elif change == "odd_height":
        fn, x = conv3x3_s2_bias_relu, x[:, :7].contiguous()
    else:
        extra = {"x2": x[:, :4].contiguous()}
    with pytest.raises(ValueError):
        fn(x, w, b, **extra)
