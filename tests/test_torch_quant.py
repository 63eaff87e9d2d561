"""The port's int8 path (annonet_tpu_torch/models/quantized.py, ops/qconv.py,
K3's requant mode, the bf16 blend, the int8 TiledInferer, calibration files)
against the JAX package on the CPU, at small sizes.

Every int8 layer sums integers exactly, and its requant is one fused
multiply-add in both packages: XLA contracts ``acc * scale + offset`` into
an FMA inside a jit (the tiled inferer's programs and the Pallas kernels in
interpret mode), and the port's plain versions emulate that FMA exactly.
So the int8 layers, and here the whole nets, are compared bit for bit
against jitted JAX functions. (Run op by op, outside a jit, XLA multiplies
and adds separately, and ~1 element in 10**5 lands one requant step away.)

Tolerances stated where used: labels of whole tiled inferers >= 99% (the
bf16 blend's excess precision in XLA on the CPU and the float calibration
images); the port's own calibration maxima within two bf16 steps of the
layer's largest maximum of JAX's (the float kernels round once after the
bias, the JAX net before it).
"""

import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from annonet_tpu import serialization as jax_serialization
from annonet_tpu.infer.core import TiledInferer as JaxTiledInferer
from annonet_tpu.infer.tiling import weight_sum_factors as jax_weight_sum_factors
from annonet_tpu.models import quantized_runtime as jq
from annonet_tpu.models.folded_runtime import (
    _concat_perm,
    _fold_1x1_kernel,
    _fold_s1_kernel,
    _fold_s2_kernel,
    _fold_up_kernel,
    fold_runtime_params,
    split_folded,
)
from annonet_tpu.models.segnet import SegNetConfig as JaxSegNetConfig
from annonet_tpu.ops.int8_conv_mosaic import (
    build_tap_gemms,
    build_tap_gemms_s2,
    mosaicize_qspec,
    qconv3x3_s1_requant,
    qconv3x3_s2_requant,
    qup_requant,
    quantize_up_entry,
)
from annonet_tpu_torch import serialization
from annonet_tpu_torch.infer.core import TiledInferer
from annonet_tpu_torch.infer.tiling import TilingParameters, weight_sum_factors
from annonet_tpu_torch.models import quantized as pq
from annonet_tpu_torch.models.segnet import (
    RuntimeSegNet,
    SegNetConfig,
    required_input_dimension,
)
from annonet_tpu_torch.ops import qconv
from annonet_tpu_torch.ops.blend import blend_argmax_plain
from tests.test_torch_model import jax_runtime_tree

FOLD = 8
_apply_int8 = jax.jit(jq.apply_folded_int8, static_argnames=(
    "config", "fold0", "qspec", "folded_output"))
_calibrate = jax.jit(jq.collect_calibration, static_argnames=("config", "fold0", "spec"))


def _setup(config: SegNetConfig, seed: int, shape=(2, 64, 64)):
    """JAX folded net, image batch, JAX calibration and int8 net."""
    jcfg = JaxSegNetConfig(**config.to_dict())
    tree = jax_runtime_tree(config, seed)
    (fold0, spec), arrays = split_folded(fold_runtime_params(tree, jcfg, FOLD))
    x = np.random.default_rng(seed).integers(
        0, 256, shape + (config.in_channels,), dtype=np.uint8
    )
    calib = [np.asarray(c) for c in _calibrate(arrays, x, jcfg, fold0=fold0, spec=spec)]
    qspec, qarrays = jq.quantize_folded(spec, arrays, calib, jcfg, fold0)
    return jcfg, tree, x, calib, (fold0, spec), (qspec, qarrays)


def _unfold(a: np.ndarray, c: int) -> np.ndarray:
    n, h, wb, fc = a.shape
    return a.reshape(n, h, wb * fc // c, c)


def _fold_act(a: np.ndarray, fold: int) -> np.ndarray:
    n, h, w, c = a.shape
    return a.reshape(n, h, w // fold, fold * c)


# --------------------------------------------------------------------------
# quantize_net against quantize_folded
# --------------------------------------------------------------------------


@pytest.mark.parametrize("grayscale", [False, True], ids=["rgb", "gray"])
def test_quantize_net_equals_quantize_folded(grayscale):
    config = SegNetConfig(class_count=3, level_count=2, base_width=16, grayscale=grayscale)
    jcfg, tree, _x, calib, (fold0, spec), (qspec, qarrays) = _setup(config, seed=2)
    assert [len(c) for c in calib] == [n for _, n in pq.calibration_layout(config)]
    ours = pq.quantize_net(tree, config, calib)
    layout = pq.calibration_layout(config)
    assert len(layout) == len(qspec)
    folds = jq._walk_folds(fold0, spec)
    f_in = fold0
    for (name, _n), kind, entry, f_out in zip(layout, qspec, qarrays, folds):
        if entry is None:
            continue
        base = kind.split(":")[0]
        if name == "head":
            w_q, s_w, b = (np.asarray(a) for a in entry)
            mine = ours[name]
            np.testing.assert_array_equal(
                w_q, _fold_1x1_kernel(mine["w_q"][None, None], f_in, class_major=True))
            np.testing.assert_array_equal(s_w, np.repeat(mine["s_w"], f_in))
            np.testing.assert_array_equal(b, np.repeat(mine["b"], f_in))
            continue
        mine = ours[name]
        if base == "up":
            w, s_in, inv, offset = (np.asarray(a) for a in entry)
            np.testing.assert_array_equal(w, _fold_up_kernel(mine["w"], f_in))
            np.testing.assert_array_equal(s_in, np.tile(mine["s_in"], f_in))
            np.testing.assert_array_equal(inv, np.tile(mine["scale"], f_out))
            np.testing.assert_array_equal(offset, np.tile(mine["offset"], f_out))
            f_in = f_out
            continue
        w_q = mine["w_q"]
        if kind.endswith(":pad4"):  # the TPU stem's zero channel rows
            w_q = np.concatenate(
                [w_q, np.zeros(w_q.shape[:2] + (4 - w_q.shape[2], w_q.shape[3]), np.int8)], 2)
        if base == "qs1":
            folded = _fold_s1_kernel(w_q, f_out)
            if name.startswith("dec"):
                c = w_q.shape[2] // 2
                folded = folded[:, :, _concat_perm(f_out, c, c), :]
        elif base == "qs2":
            folded = _fold_s2_kernel(w_q, f_in)
        else:  # the unfolded plain kinds at fold 1
            folded = w_q
        np.testing.assert_array_equal(np.asarray(entry[0]), folded)
        np.testing.assert_array_equal(np.asarray(entry[1]), np.tile(mine["scale"], f_out))
        np.testing.assert_array_equal(np.asarray(entry[2]), np.tile(mine["offset"], f_out))
        f_in = f_out


def test_quantize_up_layer_equals_quantize_up_entry():
    config = SegNetConfig(class_count=3, level_count=2, base_width=16)
    _jcfg, tree, _x, calib, (fold0, spec), (qspec, qarrays) = _setup(config, seed=4)
    ours = pq.quantize_net(tree, config, calib, quantize_up=True)
    folds = jq._walk_folds(fold0, spec)
    ups = [i for i, k in enumerate(qspec) if k == "up"]
    names = [n for n, _ in pq.calibration_layout(config)]
    for i in ups:
        a, b, scale, offset = (np.asarray(t) for t in quantize_up_entry(qarrays[i]))
        mine = ours[names[i]]
        f = folds[i] // 2
        folded = _fold_up_kernel(mine["w_q"], f)
        np.testing.assert_array_equal(a, folded[1, 0])
        np.testing.assert_array_equal(b, folded[0, 0])
        parity = np.arange(2 * f) % 2
        np.testing.assert_array_equal(scale, mine["scale"][parity].reshape(-1))
        np.testing.assert_array_equal(offset, mine["offset"][parity].reshape(-1))


def test_input_grid_equals_quantize_input():
    u = np.arange(256, dtype=np.uint8).reshape(1, 1, 256, 1)
    want = np.asarray(jq.quantize_input(jnp.asarray(u), 1, ())).reshape(-1)
    got = pq.quantize_input(torch.from_numpy(u)).numpy().reshape(-1)
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# Q1-Q3 plain versions against the Pallas kernels (interpret mode)
# --------------------------------------------------------------------------


def _requant_args(rng, cout, shape=()):
    # scales and offsets that spread the pre-round values over [-20, 150],
    # so the clip, the truncation and many near-integer values all occur
    scale = (rng.random(shape + (cout,)) * 3e-3 + 1e-4).astype(np.float32)
    offset = (rng.random(shape + (cout,)) * 30 - 10 + 0.5).astype(np.float32)
    return scale, offset


@pytest.mark.parametrize("two_inputs", [False, True], ids=["one", "concat"])
def test_q1_plain_equals_qconv3x3_s1_requant(two_inputs):
    rng = np.random.default_rng(10 + two_inputs)
    n, h, w, c, cout = 2, 16, 32, 16, 16
    x = rng.integers(0, 128, (n, h, w, c), dtype=np.int8)
    x2 = rng.integers(0, 128, (n, h, w, c), dtype=np.int8) if two_inputs else None
    cin = 2 * c if two_inputs else c
    w_q = rng.integers(-127, 128, (3, 3, cin, cout), dtype=np.int8)
    scale, offset = _requant_args(rng, cout)
    got = qconv.qconv3x3_requant_plain(
        torch.from_numpy(x), torch.from_numpy(w_q), torch.from_numpy(scale),
        torch.from_numpy(offset), None if x2 is None else torch.from_numpy(x2),
    ).numpy()
    xf = _fold_act(x, FOLD)
    wk = _fold_s1_kernel(w_q, FOLD)
    if two_inputs:
        xf = np.concatenate([xf, _fold_act(x2, FOLD)], -1)
        wk = wk[:, :, _concat_perm(FOLD, c, c), :]
    wl, wc, wr = build_tap_gemms(wk)
    want = qconv3x3_s1_requant(
        jnp.asarray(xf), wl, wc, wr, np.tile(scale, FOLD), np.tile(offset, FOLD),
        rows=8, interpret=True,
    )
    want = _unfold(np.asarray(want), cout)
    assert 0 < (want == 127).sum() and 0 < (want == 0).sum()
    np.testing.assert_array_equal(got, want)


def test_q2_plain_equals_qconv3x3_s2_requant():
    rng = np.random.default_rng(12)
    n, h, w, c, cout = 2, 16, 32, 16, 32
    x = rng.integers(0, 128, (n, h, w, c), dtype=np.int8)
    w_q = rng.integers(-127, 128, (3, 3, c, cout), dtype=np.int8)
    scale, offset = _requant_args(rng, cout)
    got = qconv.qconv3x3_s2_requant_plain(
        torch.from_numpy(x), torch.from_numpy(w_q), torch.from_numpy(scale),
        torch.from_numpy(offset),
    ).numpy()
    w0, w1 = build_tap_gemms_s2(_fold_s2_kernel(w_q, FOLD))
    want = qconv3x3_s2_requant(
        jnp.asarray(_fold_act(x, FOLD)), w0, w1, np.tile(scale, FOLD // 2),
        np.tile(offset, FOLD // 2), rows=4, interpret=True,
    )
    np.testing.assert_array_equal(got, _unfold(np.asarray(want), cout))


@pytest.mark.parametrize("n,h,w,c,cout,rows", [(2, 16, 32, 16, 32, 4), (1, 8, 48, 6, 40, 4),
                                               (2, 12, 32, 32, 64, 2), (1, 8, 16, 64, 20, 2)])
def test_q2_with_packed_weights_equals_qconv3x3_s2_requant(n, h, w, c, cout, rows):
    """The Q2 wrapper with its packed weights (as the int8 net passes them)
    on CPU tensors equals the Pallas Q2 in interpret mode: the cin <= 16
    two-row-tap layout (6, 16) and the 32-channel chunks (32, 64)."""
    rng = np.random.default_rng(20 + c)
    x = rng.integers(0, 128, (n, h, w, c), dtype=np.int8)
    w_q = rng.integers(-127, 128, (3, 3, c, cout), dtype=np.int8)
    scale, offset = _requant_args(rng, cout)
    wt = torch.from_numpy(w_q)
    packed = qconv.pack_q1_weights(wt)
    assert tuple(packed.shape) == ((1, 6, cout, 32) if c <= qconv.Q1_PAIR_CIN
                                   else (-(-c // 32), 9, cout, 32))
    before = qconv.qconv3x3_s2_requant.launches
    got = qconv.qconv3x3_s2_requant(torch.from_numpy(x), wt, torch.from_numpy(scale),
                                    torch.from_numpy(offset), packed=packed).numpy()
    assert qconv.qconv3x3_s2_requant.launches == before  # the plain version ran
    w0, w1 = build_tap_gemms_s2(_fold_s2_kernel(w_q, FOLD))
    want = qconv3x3_s2_requant(
        jnp.asarray(_fold_act(x, FOLD)), w0, w1, np.tile(scale, FOLD // 2),
        np.tile(offset, FOLD // 2), rows=rows, interpret=True,
    )
    want = _unfold(np.asarray(want), cout)
    assert 0 < (want == 0).sum() and 0 < (want > 0).sum()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fn", ["qconv3x3_requant", "qconv3x3_acc", "qconv3x3_s2_requant"])
@pytest.mark.parametrize("bad", ["other_cin", "truncated", "int32", "strided"])
def test_wrongly_packed_weights_raise(fn, bad):
    """A packed copy that cannot be ``pack_q1_weights(w)`` is refused on
    either device, before any launch."""
    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.integers(0, 128, (1, 8, 8, 24), dtype=np.int8))
    w_q = torch.from_numpy(rng.integers(-127, 128, (3, 3, 24, 16), dtype=np.int8))
    scale, offset = (torch.from_numpy(a) for a in _requant_args(rng, 16))
    packed = {
        "other_cin": qconv.pack_q1_weights(w_q[:, :, :16]),  # the two-row-tap layout
        "truncated": qconv.pack_q1_weights(w_q)[..., :16].contiguous(),
        "int32": qconv.pack_q1_weights(w_q).to(torch.int32),
        "strided": qconv.pack_q1_weights(w_q).transpose(2, 3).contiguous().transpose(2, 3),
    }[bad]
    args = (x, w_q) if fn == "qconv3x3_acc" else (x, w_q, scale, offset)
    with pytest.raises(ValueError, match="packed"):
        getattr(qconv, fn)(*args, packed=packed)
    getattr(qconv, fn)(*args, packed=qconv.pack_q1_weights(w_q))  # the right copy runs


@pytest.mark.parametrize("level_count,grayscale", [(2, False), (3, True)])
def test_quantized_net_packs_the_stride_2_weights_once(level_count, grayscale, monkeypatch):
    """QuantizedSegNet holds pack_q1_weights of every enc*/conv0 (Q2) as of
    every Q1 layer, and passes that buffer at each Q2 call."""
    config = SegNetConfig(class_count=3, level_count=level_count, base_width=8,
                          grayscale=grayscale)
    _jcfg, tree, x, calib, *_ = _setup(config, seed=6, shape=(1, 32, 32))
    net = pq.QuantizedSegNet(pq.quantize_net(tree, config, calib), config, device="cpu")
    assert net.q2_layers() == [f"enc{i}/conv0" for i in range(1, level_count + 1)]
    buffers = dict(net.named_buffers())
    for layer in net.q1_layers() + net.q2_layers():
        w_q = net._layer(layer)[0]
        packed = buffers[f"{layer.replace('/', '_')}_w_packed"]
        assert tuple(packed.shape) == qconv._q1_shape(w_q.shape[2], w_q.shape[3])
        assert torch.equal(packed, qconv.pack_q1_weights(w_q))
    seen = []
    q2 = pq.qconv3x3_s2_requant
    monkeypatch.setattr(pq, "qconv3x3_s2_requant",
                        lambda x, w, s, o, packed=None: seen.append(packed) or q2(x, w, s, o, packed))
    with torch.inference_mode():
        net(pq.quantize_input(torch.from_numpy(x)))
    assert len(seen) == level_count
    assert all(p is buffers[f"enc{i}_conv0_w_packed"] for i, p in enumerate(seen, 1))


def test_q3_plain_equals_qup_requant():
    rng = np.random.default_rng(13)
    f, n, h, w, c, cout = 4, 2, 8, 32, 32, 16
    x = rng.integers(0, 128, (n, h, w, c), dtype=np.int8)
    w_q = rng.integers(-127, 128, (2, 2, c, cout), dtype=np.int8)
    scale, offset = _requant_args(rng, cout, (2,))  # per column parity
    got = qconv.qup2x2_requant_plain(
        torch.from_numpy(x), torch.from_numpy(w_q), torch.from_numpy(scale),
        torch.from_numpy(offset),
    ).numpy()
    folded = _fold_up_kernel(w_q, f)
    parity = np.arange(2 * f) % 2
    want = qup_requant(
        jnp.asarray(_fold_act(x, f)), folded[1, 0], folded[0, 0],
        scale[parity].reshape(-1), offset[parity].reshape(-1), rows=8, interpret=True,
    )
    np.testing.assert_array_equal(got, _unfold(np.asarray(want), cout))
    # the wrapper on CPU tensors, given the packed weights as the int8 net
    # passes them, is the plain version
    w_t = torch.from_numpy(w_q)
    wrapped = qconv.qup2x2_requant(
        torch.from_numpy(x), w_t, torch.from_numpy(scale), torch.from_numpy(offset),
        packed=qconv.pack_q3_weights(w_t),
    ).numpy()
    np.testing.assert_array_equal(wrapped, got)


@pytest.mark.parametrize("cin,cout", [(8, 4), (24, 12), (32, 16), (128, 64)])
def test_q3_packed_weights_are_the_flipped_taps(cin, cout):
    """pack_q3_weights, read back column by column, is the flipped HWIO
    taps zero-padded to whole k32 steps, and the kernel's GEMM over it,
    column (2u + v) * cout + co stored at output pixel (2i + u, 2j + v), is
    the exact transpose conv. A packed copy of another shape is refused."""
    rng = np.random.default_rng(cin + cout)
    w_q = torch.from_numpy(rng.integers(-127, 128, (2, 2, cin, cout), dtype=np.int8))
    packed = qconv.pack_q3_weights(w_q)
    kp = -(-cin // 32) * 32
    assert packed.dtype == torch.int8 and packed.is_contiguous()
    assert tuple(packed.shape) == (4 * cout, kp) and not packed[:, cin:].any()
    for u in range(2):
        for v in range(2):
            for co in range(cout):
                assert torch.equal(packed[(2 * u + v) * cout + co, :cin], w_q[1 - u, 1 - v, :, co])
    n, h, w = 2, 5, 7
    x = rng.integers(0, 128, (n, h, w, cin), dtype=np.int8)
    a = np.zeros((n * h * w, kp), np.int64)
    a[:, :cin] = x.reshape(-1, cin)
    c = a @ packed.numpy().astype(np.int64).T  # [pixels, 4 cout]
    got = c.reshape(n, h, w, 2, 2, cout).transpose(0, 1, 3, 2, 4, 5).reshape(n, 2 * h, 2 * w, cout)
    taps = w_q.numpy().astype(np.int64)[::-1, ::-1]  # taps[u, v] = w_q[1-u, 1-v]
    want = np.einsum("nijc,uvcd->niujvd", x.astype(np.int64), taps).reshape(got.shape)
    np.testing.assert_array_equal(got, want)
    scale, offset = _requant_args(rng, cout, (2,))
    args = (torch.from_numpy(x), w_q, torch.from_numpy(scale), torch.from_numpy(offset))
    with pytest.raises(ValueError, match="packed"):
        qconv.qup2x2_requant(*args, packed=packed[:, :16].contiguous())


def test_quantized_net_packs_the_up_weights_once(monkeypatch):
    """QuantizedSegNet(quantize_up) holds pack_q3_weights of every int8 up
    layer (Q3) and passes that buffer at each Q3 call; without quantize_up
    it holds none."""
    config = SegNetConfig(class_count=3, level_count=2, base_width=8)
    _jcfg, tree, x, calib, *_ = _setup(config, seed=7, shape=(1, 32, 32))
    assert pq.QuantizedSegNet(pq.quantize_net(tree, config, calib), config,
                              device="cpu").q3_layers() == []
    net = pq.QuantizedSegNet(pq.quantize_net(tree, config, calib, quantize_up=True), config,
                             device="cpu")
    assert net.q3_layers() == ["dec2/up", "dec1/up"]
    buffers = dict(net.named_buffers())
    for layer in net.q3_layers():
        w_q = net._layer(layer)[0]
        assert torch.equal(buffers[f"{layer.replace('/', '_')}_w_packed"],
                           qconv.pack_q3_weights(w_q))
    seen = []
    q3 = pq.qup2x2_requant
    monkeypatch.setattr(pq, "qup2x2_requant",
                        lambda x, w, s, o, packed=None: seen.append(packed) or q3(x, w, s, o, packed))
    with torch.inference_mode():
        net(pq.quantize_input(torch.from_numpy(x)))
    assert [p is buffers[f"dec{i}_up_w_packed"] for i, p in zip((2, 1), seen)] == [True, True]


def _unpack_q1_weights(packed: torch.Tensor, cin: int) -> torch.Tensor:
    """The HWIO weights of pack_q1_weights's layout, read back from it."""
    chunks, units, cout, _ = packed.shape
    if units == 6:
        p = packed.reshape(3, 2, cout, 32)
        taps = torch.stack([p[:, 0, :, :cin], p[:, 0, :, 16 : 16 + cin], p[:, 1, :, :cin]])
    else:
        taps = packed.permute(1, 2, 0, 3).reshape(3, 3, cout, chunks * 32)[..., :cin]
    return taps.permute(0, 1, 3, 2).contiguous()


def _q1_kernel_gemm(x, packed):
    """Q1's kernel's GEMM in numpy, k32 step by k32 step from the packed
    weights: chunk by chunk the taps' 32 channels, or, at most 16 input
    channels, two row taps a step (the lower 16 bytes from row r, the upper
    from row r + 1)."""
    n, h, w, cin = x.shape
    chunks, units, _cout, _ = packed.shape
    width = 16 if units == 6 else 32 * chunks
    xp = np.zeros((n, h + 3, w + 2, width), np.int64)  # rows -1 .. h + 1
    xp[:, 1 : h + 1, 1 : w + 1, :cin] = x
    wp = packed.astype(np.int64)
    acc = 0
    for dx in range(3):
        if units == 6:
            for j in range(2):
                a = np.concatenate([xp[:, 2 * j + r : 2 * j + r + h, dx : dx + w]
                                    for r in range(2)], -1)
                acc = acc + a @ wp[0, 2 * dx + j].T
        else:
            for t in range(chunks):
                for dy in range(3):
                    a = xp[:, dy : dy + h, dx : dx + w, 32 * t : 32 * t + 32]
                    acc = acc + a @ wp[t, 3 * dy + dx].T
    return acc


@pytest.mark.parametrize("c1,c2,cout", [(3, 0, 16), (8, 0, 24), (16, 0, 16), (12, 0, 4),
                                        (24, 0, 36), (32, 0, 32), (16, 16, 16),
                                        (40, 24, 48), (64, 64, 64), (128, 0, 128)])
def test_q1_packed_weights_round_trip_and_sum(c1, c2, cout):
    """pack_q1_weights is a zero-padded permutation of the HWIO weights
    (reading them back gives them), and the kernel's GEMM over it, step by
    step, is the exact conv of the concat [x, x2]."""
    rng = np.random.default_rng(c1 + c2 + cout)
    cin = c1 + c2
    w_q = torch.from_numpy(rng.integers(-127, 128, (3, 3, cin, cout), dtype=np.int8))
    packed = qconv.pack_q1_weights(w_q)
    pair = cin <= qconv.Q1_PAIR_CIN
    assert packed.dtype == torch.int8 and packed.is_contiguous()
    assert tuple(packed.shape) == ((1, 6, cout, 32) if pair else (-(-cin // 32), 9, cout, 32))
    assert torch.equal(_unpack_q1_weights(packed, cin), w_q)
    assert int((packed != 0).sum()) == int((w_q != 0).sum())  # the padding is zero
    x = rng.integers(-127 if c1 == 3 else 0, 128, (2, 7, 11, c1), dtype=np.int8)
    x2 = rng.integers(0, 128, (2, 7, 11, c2), dtype=np.int8) if c2 else None
    want = qconv.qconv3x3_acc_plain(
        torch.from_numpy(x), w_q, None if x2 is None else torch.from_numpy(x2)).numpy()
    xc = x if x2 is None else np.concatenate([x, x2], -1)
    np.testing.assert_array_equal(_q1_kernel_gemm(xc, packed.numpy()), want)


def test_fma_f32_is_one_rounding():
    rng = np.random.default_rng(14)
    a = (rng.integers(-(2**25), 2**25, 200_000)).astype(np.float32)
    b = (rng.random(200_000) * 1e-3).astype(np.float32)
    c = (rng.random(200_000) * 64 - 16).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))  # XLA's FMA
    got = qconv.fma_f32(*(torch.from_numpy(t) for t in (a, b, c))).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != a * b + c).any()  # two roundings would differ


# --------------------------------------------------------------------------
# the int8 net against apply_folded_int8
# --------------------------------------------------------------------------


@pytest.mark.parametrize(
    "compute_dtype,level_count,quantize_up",
    [("bfloat16", 2, False), ("float32", 2, False), ("bfloat16", 1, True)],
    ids=["bf16", "f32", "quantize_up"],
)
def test_quantized_net_equals_apply_folded_int8(compute_dtype, level_count, quantize_up):
    config = SegNetConfig(class_count=3, level_count=level_count, base_width=16,
                          compute_dtype=compute_dtype)
    jcfg, tree, x, calib, (fold0, _spec), (qspec, qarrays) = _setup(config, seed=5)
    if quantize_up:  # the int8 up layers run through qup_requant
        qspec, qarrays = mosaicize_qspec(qspec, qarrays, quantize_up=True, kinds=())
        assert "mup" in qspec
    net = pq.QuantizedSegNet(pq.quantize_net(tree, config, calib, quantize_up), config,
                             device="cpu")
    acts = {}
    with torch.inference_mode():
        got = net(pq.quantize_input(torch.from_numpy(x)),
                  tap=lambda name, a: acts.__setitem__(name, a.numpy())).numpy()
    want = np.asarray(_apply_int8(qarrays, x, jcfg, fold0=fold0, qspec=qspec))
    # every layer bit for bit, except in bf16 from the first up on: there
    # XLA keeps f32 between the bf16 ops of the up layer (excess precision),
    # so that layer's requant lands one step away at a few percent of its
    # outputs, and the layers after it inherit the difference
    exact = compute_dtype == "float32" or quantize_up
    names = [n for n, _ in pq.calibration_layout(config)]
    first_up = min(i for i, n in enumerate(names) if n.endswith("/up"))
    for i, name in enumerate(names):
        if name not in acts or not (exact or i <= first_up):
            continue
        prefix = np.asarray(_apply_int8(qarrays[: i + 1], x, jcfg, fold0=fold0,
                                        qspec=qspec[: i + 1], folded_output=True))
        prefix = _unfold(prefix, acts[name].shape[-1])
        if exact or i < first_up:
            np.testing.assert_array_equal(acts[name], prefix, err_msg=name)
        else:
            d = acts[name].astype(np.int32) - prefix
            assert np.abs(d).max() <= 1 and (d != 0).mean() <= 0.05, name
    assert got.shape == want.shape and got.dtype == np.float32
    if exact:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.99


def test_collect_calibration_within_two_bf16_steps():
    config = SegNetConfig(class_count=3, level_count=2, base_width=16)
    _jcfg, tree, x, calib, _f, _q = _setup(config, seed=6)
    ours = pq.collect_calibration(RuntimeSegNet(tree, config, device="cpu"),
                                  torch.from_numpy(x))
    for (name, n), a, b in zip(pq.calibration_layout(config), ours, calib):
        assert a.shape == b.shape == (n,), name
        if n:
            step = 2.0 ** (np.floor(np.log2(b.max())) - 7)  # bf16 step at the max
            assert np.abs(a - b).max() <= 2 * step, name


# --------------------------------------------------------------------------
# blend: weight-sum factors and the bf16 plain version
# --------------------------------------------------------------------------


def test_weight_sum_factors_equal_jax():
    config = SegNetConfig(class_count=3, level_count=2, base_width=16)
    rf = required_input_dimension(config)
    inferer = TiledInferer(jax_runtime_tree(config, 0), config,
                           TilingParameters(96, 96, rf, rf), device="cpu")
    plan = inferer.plan(150, 230)
    for got, want in zip(weight_sum_factors(plan), jax_weight_sum_factors(plan)):
        np.testing.assert_array_equal(got, want)


def test_bf16_blend_rounds_at_each_step():
    # one pixel under two tiles: the bf16 chain by hand, step by step
    bf = lambda v: float(torch.tensor(float(v)).to(torch.bfloat16))  # noqa: E731
    logits = torch.tensor([[[[1.01, 2.0]]], [[[1.003, -0.5]]]], dtype=torch.float32)
    tile_yx = torch.tensor([[0, 0], [0, 0]], dtype=torch.int32)
    ramp = torch.tensor([[0.7]], dtype=torch.float32)
    inv = torch.tensor([[0.71]], dtype=torch.float32)
    gains = torch.tensor([0.0, 0.3], dtype=torch.float32)
    levels = torch.tensor([0.0, 0.1], dtype=torch.float32)
    labels, seeds = blend_argmax_plain(logits, tile_yx, ramp, inv, gains, levels,
                                       with_detection=True, reference_blend=False,
                                       blend_dtype=torch.bfloat16)
    acc = [bf(bf(bf(logits[0, 0, 0, c]) * bf(0.7)) + bf(bf(logits[1, 0, 0, c]) * bf(0.7)))
           for c in range(2)]
    blended = [bf(a * bf(0.71)) for a in acc]
    score = [bf(blended[0]), bf(blended[1] + bf(0.3))]
    assert int(labels[0, 0, 0]) == int(np.argmax(score))
    want_seed = labels[0, 0, 0] > 0 and bf(blended[1] - blended[0]) > bf(bf(0.1) - 0.0)
    assert bool(seeds[0, 0, 0]) == bool(want_seed)


# --------------------------------------------------------------------------
# the int8 tiled inferer against JAX's, and calibration files
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def int8_pair():
    """A JAX int8 inferer calibrated on one image, its exported
    calibration, and what the port needs to load it."""
    config = SegNetConfig(class_count=3, level_count=1, base_width=16)
    jcfg = JaxSegNetConfig(**config.to_dict())
    tree = jax_runtime_tree(config, 7)
    rf = required_input_dimension(config)
    tiling = TilingParameters(64, 64, rf, rf)
    rng = np.random.default_rng(7)
    image = rng.integers(0, 256, (100, 150, 3), dtype=np.uint8)
    plan = TiledInferer(tree, config, tiling, device="cpu").plan(100, 150)
    assert plan.tile_count > 4 and pq.int8_fold(config, plan.tile_width) == FOLD
    return config, jcfg, tree, tiling, image, plan


@pytest.mark.parametrize("blend_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("levels", [None, [0.0, 0.3, 0.1]], ids=["plain", "detection"])
def test_int8_inferer_agrees_with_jax(int8_pair, blend_dtype, levels):
    config, jcfg, tree, tiling, image, plan = int8_pair
    gains = [0.0, 0.05, -0.05]
    theirs = JaxTiledInferer(tree, jcfg, tiling, quantize="int8", blend_dtype=blend_dtype)
    theirs._plan_override = plan  # the port's plan (the JAX int8 default differs)
    want = theirs.infer_arrays(image, gains, levels)
    calibration = theirs.export_calibration()
    ours = TiledInferer(tree, config, tiling, device="cpu", quantize="int8",
                        calibration=calibration, blend_dtype=blend_dtype)
    got = ours.infer_arrays(image, gains, levels)
    assert ours.float_fallbacks == 0 and list(ours._quantized) == [FOLD]
    assert (got[0] == want[0]).mean() >= 0.99
    if levels is None:
        assert got[1] is None and want[1] is None
    else:
        assert (got[1] == want[1]).mean() >= 0.99


def test_int8_inferer_freezes_after_calibration_images(int8_pair):
    config, _jcfg, tree, tiling, image, _plan = int8_pair
    inferer = TiledInferer(tree, config, tiling, device="cpu", quantize="int8",
                           calibration_images=2)
    assert inferer.blend_dtype == torch.bfloat16
    assert inferer.export_calibration() is None
    assert inferer.calibration_layer_shapes() == [16, 16, 0, 32, 32, 16, 0, 16, 0]
    with inferer.pause_calibration():
        inferer.infer_arrays(image)
    assert not inferer._calib_seen
    inferer.infer_arrays(image)
    assert inferer.export_calibration() is None and inferer.export_calibration(partial=True)
    inferer.infer_arrays(image[::-1].copy())
    assert list(inferer._quantized) == [FOLD]
    assert 0.0 < inferer.calibration_overshoot(image) <= 1.0
    for bad in (dict(quantize="int4"), dict(quantize="int8", calibration_images=0),
                dict(quantize="int8", blend_dtype="float16"),
                dict(calibration=[np.zeros(3, np.float32)])):
        with pytest.raises(ValueError):
            TiledInferer(tree, config, tiling, device="cpu", **bad)


def test_int8_falls_back_to_float_on_plans_that_do_not_fold(capsys):
    config = SegNetConfig(class_count=3, level_count=1, base_width=32)  # 8 * 32 > 128
    tree = jax_runtime_tree(config, 8)
    rf = required_input_dimension(config)
    image = np.random.default_rng(8).integers(0, 256, (60, 60, 3), dtype=np.uint8)
    tiling = TilingParameters(64, 64, rf, rf)
    int8 = TiledInferer(tree, config, tiling, device="cpu", quantize="int8")
    plan = int8.plan(60, 60)
    assert pq.int8_fold(config, plan.tile_width) == 4  # still folds: int8 runs
    config = dataclasses.replace(config, level_count=3)  # 4 < 2**3: no fold
    tree = jax_runtime_tree(config, 8)
    rf = required_input_dimension(config)
    tiling = TilingParameters(128, 128, rf, rf)
    int8 = TiledInferer(tree, config, tiling, device="cpu", quantize="int8")
    labels, _ = int8.infer_arrays(image)
    int8.infer_arrays(image)
    float_labels, _ = TiledInferer(tree, config, tiling, device="cpu").infer_arrays(image)
    np.testing.assert_array_equal(labels, float_labels)
    assert int8.float_fallbacks == 2 and not int8._quantized
    assert capsys.readouterr().err.count("does not fold") == 1
    assert int8.calibration_layer_shapes() is None


def test_calibration_files_cross_load(int8_pair, tmp_path):
    config, jcfg, tree, _tiling, _image, _plan = int8_pair
    rng = np.random.default_rng(9)
    calib = [rng.random(n).astype(np.float32) for _, n in pq.calibration_layout(config)]
    assert serialization.weights_fingerprint(tree) == jax_serialization.weights_fingerprint(tree)
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    serialization.save_calibration(ours, calib, config, tree)
    jax_serialization.save_calibration(theirs, calib, jcfg, tree)
    for loaded in (jax_serialization.load_calibration(ours, jcfg, tree),
                   serialization.load_calibration(theirs, config, tree),
                   serialization.load_calibration(
                       io.BytesIO(serialization.calibration_npz_bytes(calib, config, tree)),
                       config, tree)):
        assert len(loaded) == len(calib)
        for a, b in zip(loaded, calib):
            np.testing.assert_array_equal(a, b)
    other = jax_runtime_tree(config, 70)
    with pytest.raises(RuntimeError, match="different trained weights"):
        serialization.load_calibration(theirs, config, other)
    with pytest.raises(RuntimeError, match="different model config"):
        serialization.load_calibration(ours, dataclasses.replace(config, class_count=4))


def test_calibration_loader_errors(int8_pair, tmp_path):
    import json

    config = int8_pair[0]
    with pytest.raises(FileNotFoundError):
        serialization.load_calibration(str(tmp_path / "missing.npz"), config)
    # a file without model_config: the JAX loader raises KeyError here
    meta = {"format": "annonet-tpu-npz-v1", "kind": "int8_calibration", "layer_count": 1}
    path = str(tmp_path / "no_config.npz")
    np.savez(path, **{"layer/000": np.ones(3, np.float32),
                      "__meta__": np.frombuffer(json.dumps(meta).encode(), np.uint8)})
    with pytest.raises(RuntimeError, match="no model_config"):
        serialization.load_calibration(path, config)
    model = str(tmp_path / "model.npz")
    serialization.save_model(model, jax_runtime_tree(config, 1), config, "{}", 1.0)
    with pytest.raises(RuntimeError, match="is not an annonet-tpu calibration file"):
        serialization.load_calibration(model, config)
