"""The hand-written CUDA kernels on the card, against their plain PyTorch
versions, at small and ragged shapes the flagship net never gives them
(channel counts that are not multiples of 16, widths that are not multiples
of 32, several images, many classes). chip_smoke.py checks them at the
main path's shapes.

These tests need an NVIDIA GPU with nvcc; without one they skip. On the
card (this file imports no jax, so it runs without the JAX package's
conftest):

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerances: f32 kernels only reorder f32 sums (1e-4 of the output scale,
TF32 off in the plain versions); bf16 kernels round once after the bias
where the plain versions round before it too (two bf16 steps, 2**-6, of
the output scale); the blend's labels and seeds are bit-identical, in f32
and in bf16, with and without the argmax fold, for any tile list; the int8
kernels Q1-Q3 sum integers exactly and requantize with one FMA, as their
plain versions do, so they are bit-identical, as is Q1's accumulator mode
(the int32 sums; all on the int8 tensor cores); K3's requant
mode sums floats in another order
than cuDNN, so it is held within one requant step. G1 and its plain version
both sum in f32 and round once: bf16 within one bf16 step at the largest
output, f32 within 1e-4 of the output scale; on the decoder's two-part input G1 is held to
K1's plain version (two steps, as K1).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-6}
UP_EDGES = [("up", 1, 9, 19, 8, 0, 4), ("up", 1, 7, 45, 128, 0, 64), ("up", 1, 11, 70, 64, 0, 32),
            ("up", 2, 13, 100, 32, 0, 16), ("up", 3, 9, 30, 32, 0, 16),
            ("up", 1, 6, 20, 256, 0, 160)]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rand(shape, device, seed, lo=0.0, scale=1.0):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return (torch.rand(shape, generator=g, device=device) + lo) * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "kind,n,h,w,c1,c2,cout",
    [("s1", 1, 17, 45, 3, 0, 20), ("s1", 2, 8, 40, 5, 7, 9), ("s1", 1, 33, 70, 40, 24, 48),
     ("s2", 1, 18, 66, 6, 0, 40), ("s2", 3, 10, 34, 16, 0, 8),
     ("up", 2, 9, 13, 24, 0, 36), ("up", 1, 5, 40, 3, 0, 4),
     # the edges of bf16 K1/K2's implicit GEMM (tests/test_torch_conv.py pins
     # the same shapes to the JAX package): the grayscale and RGB stems at
     # widths that are not a multiple of the 64-column tile, a concat with
     # c1 % 8 != 0, the decoder's 16+16 and 64+64, enc3/conv1's 128 -> 128
     # (its weights stream by channel chunk), two cout slabs, n = 3 with an
     # odd H, stride 2 at 16 -> 32 and 64 -> 128 and with odd cout
     ("s1", 2, 19, 100, 1, 0, 16), ("s1", 1, 24, 90, 3, 0, 16), ("s1", 1, 16, 72, 12, 20, 16),
     ("s1", 2, 16, 70, 16, 16, 16), ("s1", 1, 12, 40, 64, 64, 64), ("s1", 1, 14, 28, 128, 0, 128),
     ("s1", 1, 6, 20, 24, 0, 136), ("s1", 3, 9, 30, 8, 0, 24),
     ("s2", 2, 32, 100, 16, 0, 32), ("s2", 1, 16, 36, 64, 0, 128), ("s2", 1, 18, 66, 16, 0, 9),
     ("s2", 1, 10, 70, 64, 0, 20),
     # the edges of bf16 K3's GEMM (128-pixel tiles, 64-column passes):
     # base_width=4's dec1 (cin 8 -> 4), the flagship's 128 -> 64, 64 -> 32
     # and 32 -> 16 at pixel counts that are not a multiple of the tile,
     # n = 3 with an odd H, and 4 cout = 640 columns, which split into slabs
     *UP_EDGES],
)
def test_conv_kernels_match_plain(device, kind, n, h, w, c1, c2, cout, dtype):
    from annonet_tpu_torch.ops import conv

    k = 2 if kind == "up" else 3
    x = _rand((n, h, w, c1), device, 1, -0.3).to(dtype)
    x2 = _rand((n, h, w, c2), device, 2).to(dtype) if c2 else None
    wgt = _rand((k, k, c1 + c2, cout), device, 3, -0.5, (2.0 / (k * k * (c1 + c2))) ** 0.5)
    wgt = wgt.to(dtype)
    bias = _rand((cout,), device, 4, -0.5, 0.2)
    fn, plain = {
        "s1": (conv.conv3x3_bias_relu, conv.conv3x3_bias_relu_plain),
        "s2": (conv.conv3x3_s2_bias_relu, conv.conv3x3_s2_bias_relu_plain),
        "up": (conv.up2x2_bias_relu, conv.up2x2_bias_relu_plain),
    }[kind]
    extra = {"x2": x2} if c2 else {}
    before = fn.launches
    got = fn(x, wgt, bias, **extra)
    assert fn.launches == before + 1
    want = plain(x, wgt, bias, **extra)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype == dtype
    scale = max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype] * scale


@pytest.mark.parametrize("m,k", [(1, 3), (2, 5), (1, 300)])
@pytest.mark.parametrize("reference_blend", [False, True])
def test_blend_kernel_is_bit_identical_to_plain(device, m, k, reference_blend):
    from annonet_tpu_torch.ops.blend import blend_argmax, blend_argmax_plain

    rng = np.random.default_rng(m * 1000 + k)
    n, th, tw, hp, wp = 7, 40, 56, 100, 130
    yx = np.stack([rng.integers(0, hp - th + 1, n), rng.integers(0, wp - tw + 1, n)], 1)
    args = (
        torch.randn((n * m, th, tw, k), device=device),
        torch.from_numpy(yx.astype(np.int32)).to(device),
        _rand((th, tw), device, 5),
        _rand((hp, wp), device, 6, 0.5),
        torch.from_numpy(rng.normal(0, 0.2, k).astype(np.float32)).to(device),
        torch.from_numpy(np.abs(rng.normal(0, 0.5, k)).astype(np.float32)).to(device),
    )
    for detection in (True, False):
        kw = dict(with_detection=detection, reference_blend=reference_blend)
        before = blend_argmax.launches
        labels, seeds = blend_argmax(*args, **kw)
        assert blend_argmax.launches == before + 1
        want_labels, want_seeds = blend_argmax_plain(*args, **kw)
        assert labels.dtype == (torch.uint8 if k <= 255 else torch.int32)
        assert torch.equal(labels, want_labels)
        assert (seeds is None) == (not detection)
        if detection:
            assert torch.equal(seeds, want_seeds)


def test_wrappers_reject_mixed_devices(device):
    from annonet_tpu_torch.ops import conv

    x = torch.zeros((1, 8, 8, 4), device=device)
    with pytest.raises(ValueError):
        conv.conv3x3_bias_relu(x, torch.zeros((3, 3, 4, 8)), torch.zeros(8))


def test_tiled_inference_on_the_card_matches_the_cpu(device):
    from annonet_tpu_torch.infer.core import TiledInferer
    from annonet_tpu_torch.infer.tiling import TilingParameters
    from annonet_tpu_torch.models.segnet import (
        SegNetConfig, init_runtime_params, required_input_dimension,
    )

    config = SegNetConfig(class_count=4, level_count=2, base_width=6, compute_dtype="float32")
    params = init_runtime_params(config, seed=3)
    rf = required_input_dimension(config)
    tiling = TilingParameters(96, 96, rf, rf)
    image = np.random.default_rng(4).integers(0, 256, (150, 230, 3), dtype=np.uint8)
    gains, levels = [0.0, 0.1, -0.1, 0.05], [0.0, 0.2, 0.1, 0.3]
    card = TiledInferer(params, config, tiling, device=device).infer_arrays(image, gains, levels)
    cpu = TiledInferer(params, config, tiling, device="cpu").infer_arrays(image, gains, levels)
    assert (card[0] == cpu[0]).mean() >= 0.999
    assert (card[1] == cpu[1]).mean() >= 0.999


@pytest.mark.parametrize("mode", [{}, {"quantize": "int8"}, {"use_pallas_conv": True}],
                         ids=["float", "int8", "folded"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_virtual_mesh_on_the_card_equals_one_device(device, mode, dtype):
    """TiledInferer(mesh=...) on 3 virtual shards of the card: logits,
    labels and seeds equal the unsharded inferer's bit for bit (each kernel
    computes a pixel the same way at any batch size), one launch per layer
    and shard."""
    from annonet_tpu_torch.infer.core import TiledInferer
    from annonet_tpu_torch.infer.tiling import TilingParameters
    from annonet_tpu_torch.models.segnet import (
        SegNetConfig, init_runtime_params, required_input_dimension,
    )
    from annonet_tpu_torch.ops import conv, qconv
    from annonet_tpu_torch.parallel.mesh import ensure_virtual_devices

    config = SegNetConfig(class_count=3, level_count=2, base_width=8, compute_dtype=dtype)
    params = init_runtime_params(config, seed=5)
    rf = required_input_dimension(config)
    tiling = TilingParameters(128, 128, rf, rf)
    image = np.random.default_rng(6).integers(0, 256, (300, 230, 3), dtype=np.uint8)
    levels = [0.0, 0.2, 0.1]
    one = TiledInferer(params, config, tiling, device=device, **mode)
    mesh = TiledInferer(params, config, tiling, mesh=ensure_virtual_devices(3, device), **mode)
    want = one.infer_arrays(image, None, levels)
    layer = qconv.qconv3x3_s2_requant if mode.get("quantize") else conv.conv3x3_s2_bias_relu
    layer.launches = 0
    got = mesh.infer_arrays(image, None, levels)
    assert layer.launches == 3 * config.level_count
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    plan = one.plan(*image.shape[:2])
    with torch.inference_mode():
        logits = []
        for inferer in (one, mesh):
            qnet = inferer._int8_net(image[None], plan)
            tiles = inferer._tile_batch(image[None], plan, quantized=qnet is not None)
            logits.append(inferer._forward(tiles, plan, quantized=qnet is not None))
    assert torch.equal(*logits)


def _int8(shape, device, seed, lo=0, hi=128):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randint(lo, hi, shape, generator=g, device=device, dtype=torch.int8)


def _requant_args(shape, device, seed):
    # pre-round values spread over [-20, 150]: clip, truncation and
    # near-integer values all occur
    return (_rand(shape, device, seed, 0.05, 2e-3), _rand(shape, device, seed + 1, -0.3, 30.0))


@pytest.mark.parametrize(
    "kind,n,h,w,c1,c2,cout",
    [("s1", 1, 17, 45, 3, 0, 20), ("s1", 2, 8, 40, 5, 7, 9), ("s1", 1, 33, 70, 40, 24, 48),
     ("s1", 2, 16, 64, 16, 16, 16), ("s2", 1, 18, 66, 6, 0, 40), ("s2", 3, 10, 34, 16, 0, 8),
     ("up", 2, 9, 13, 24, 0, 36), ("up", 1, 5, 40, 3, 0, 4), ("up", 1, 8, 16, 32, 0, 16)],
)
def test_int8_kernels_are_bit_identical_to_plain(device, kind, n, h, w, c1, c2, cout):
    from annonet_tpu_torch.ops import qconv

    k = 2 if kind == "up" else 3
    x = _int8((n, h, w, c1), device, 1, -127 if c1 == 3 else 0)
    x2 = _int8((n, h, w, c2), device, 2) if c2 else None
    wgt = _int8((k, k, c1 + c2, cout), device, 3, -127)
    scale, offset = _requant_args((2, cout) if kind == "up" else (cout,), device, 4)
    fn, plain = {
        "s1": (qconv.qconv3x3_requant, qconv.qconv3x3_requant_plain),
        "s2": (qconv.qconv3x3_s2_requant, qconv.qconv3x3_s2_requant_plain),
        "up": (qconv.qup2x2_requant, qconv.qup2x2_requant_plain),
    }[kind]
    extra = {"x2": x2} if c2 else {}
    before = fn.launches
    got = fn(x, wgt, scale, offset, **extra)
    assert fn.launches == before + 1
    want = plain(x, wgt, scale, offset, **extra)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype == torch.int8
    assert torch.equal(got, want)
    assert (want == 0).any() and (want > 0).any()  # the clip and the grid both occur


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,cin,cout", [(2, 9, 13, 24, 36), (1, 5, 40, 3, 4), (1, 16, 16, 64, 32),
                                           *(case[1:5] + case[6:] for case in UP_EDGES)])
def test_up2x2_requant_within_one_step_of_plain(device, dtype, n, h, w, cin, cout):
    from annonet_tpu_torch.ops import conv

    x = _int8((n, h, w, cin), device, 5)
    s_in = _rand((cin,), device, 6, 0.5, 0.02)
    wgt = _rand((2, 2, cin, cout), device, 7, -0.5, (2.0 / cin) ** 0.5).to(dtype)
    # the float sums reach a few units: scale them over the int8 range
    scale, offset = _rand((cout,), device, 8, 0.5, 20.0), _rand((cout,), device, 9, -0.3, 30.0)
    before = conv.up2x2_requant.launches
    got = conv.up2x2_requant(x, s_in, wgt, scale, offset)
    assert conv.up2x2_requant.launches == before + 1
    want = conv.up2x2_requant_plain(x, s_in, wgt, scale, offset)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.int8
    d = (got.int() - want.int()).abs()
    assert d.max().item() <= 1 and d.float().mean().item() <= 0.05


@pytest.mark.parametrize(
    "n,h,w,c1,c2,cout",
    [(1, 17, 45, 3, 0, 20), (2, 8, 40, 5, 7, 9), (1, 33, 70, 40, 24, 48), (2, 16, 64, 16, 16, 16),
     (1, 64, 128, 128, 0, 128)],
)
def test_q1_accumulator_is_bit_identical_to_plain(device, n, h, w, c1, c2, cout):
    """qconv3x3_acc equals the exact int32 conv, and requantized it gives
    Q1's output bit for bit."""
    from annonet_tpu_torch.ops import qconv

    x = _int8((n, h, w, c1), device, 1, -127 if c1 == 3 else 0)
    x2 = _int8((n, h, w, c2), device, 2) if c2 else None
    wgt = _int8((3, 3, c1 + c2, cout), device, 3, -127)
    before = qconv.qconv3x3_acc.launches
    acc = qconv.qconv3x3_acc(x, wgt, x2)
    assert qconv.qconv3x3_acc.launches == before + 1
    want = qconv.qconv3x3_acc_plain(x, wgt, x2)
    torch.cuda.synchronize()
    assert acc.shape == want.shape == (n, h, w, cout) and acc.dtype == torch.int32
    assert torch.equal(acc, want)
    scale, offset = _requant_args((cout,), device, 4)
    q1 = qconv.qconv3x3_requant(x, wgt, scale, offset, x2)
    assert torch.equal(qconv.requant_plain(acc, scale, offset), q1)


@pytest.mark.parametrize(
    "n,h,w,c1,c2,cout",
    [(1, 9, 109, 3, 0, 16),  # the RGB stem at the 872-px plan's width 109
     (2, 11, 37, 8, 0, 4), (1, 13, 70, 16, 0, 16), (1, 8, 109, 24, 0, 36),
     (2, 10, 45, 32, 0, 32), (1, 12, 109, 16, 16, 16), (1, 9, 50, 64, 64, 64),
     (1, 6, 109, 128, 0, 128), (3, 5, 21, 12, 20, 4), (1, 7, 33, 128, 0, 36)],
)
def test_q1_tensor_core_modes_are_bit_identical_to_plain(device, n, h, w, c1, c2, cout):
    """Q1 (int8 tensor cores) and its accumulator mode at the edges of its
    implicit GEMM: the two-row-tap steps of cin <= 16 (3, 8, 16), chunks
    with zero-padded channels (24, 40 + 24), the decoder's concats, cout
    under one n8 tile or not a multiple of 16, several slabs, widths that
    are not a multiple of the tile (109, the 872-px plan's folded width),
    with the packed weights passed as the int8 net passes them."""
    from annonet_tpu_torch.ops import qconv

    x = _int8((n, h, w, c1), device, 1, -127 if c1 == 3 else 0)
    x2 = _int8((n, h, w, c2), device, 2) if c2 else None
    wgt = _int8((3, 3, c1 + c2, cout), device, 3, -127)
    packed = qconv.pack_q1_weights(wgt)
    scale, offset = _requant_args((cout,), device, 4)
    before = (qconv.qconv3x3_requant.launches, qconv.qconv3x3_acc.launches)
    got = qconv.qconv3x3_requant(x, wgt, scale, offset, x2, packed=packed)
    acc = qconv.qconv3x3_acc(x, wgt, x2, packed=packed)
    assert (qconv.qconv3x3_requant.launches, qconv.qconv3x3_acc.launches) == (
        before[0] + 1, before[1] + 1)
    want_acc = qconv.qconv3x3_acc_plain(x, wgt, x2)
    want = qconv.qconv3x3_requant_plain(x, wgt, scale, offset, x2)
    torch.cuda.synchronize()
    assert acc.dtype == torch.int32 and torch.equal(acc, want_acc)
    assert got.dtype == torch.int8 and torch.equal(got, want)
    assert (want == 0).any() and (want > 0).any()
    with pytest.raises(ValueError, match="packed"):
        qconv.qconv3x3_requant(x, wgt, scale, offset, x2, packed=packed[..., :16].contiguous())


@pytest.mark.parametrize(
    "n,h,w,cin,cout",
    [(1, 18, 66, 6, 40), (3, 10, 34, 16, 8),  # the int8 s2 shapes above, packed
     (2, 14, 70, 12, 20),  # two row taps a step, 7 x 35 outputs: ragged rows and columns
     (2, 32, 100, 16, 32), (1, 16, 36, 32, 64), (1, 20, 44, 64, 128),  # enc1-3/conv0
     (1, 12, 40, 40, 36), (2, 8, 218, 64, 128), (1, 6, 20, 24, 136), (1, 4, 4, 3, 4)],
)
def test_q2_tensor_cores_are_bit_identical_to_plain(device, n, h, w, cin, cout):
    """Q2 (the int8 tensor cores at stride 2) at the edges of its implicit
    GEMM, with the packed weights passed as the int8 net passes them: cin <=
    16 (two row taps a k32 step) at output tiles cut on both edges, the
    flagship's three layers in small, zero-padded channel chunks (24, 40),
    cout that is no multiple of 16 or spans two slabs, the width 218 of the
    872-px plan's half resolution, and a 2 x 2 output."""
    from annonet_tpu_torch.ops import qconv

    x = _int8((n, h, w, cin), device, 1)
    wgt = _int8((3, 3, cin, cout), device, 3, -127)
    packed = qconv.pack_q1_weights(wgt)
    scale, offset = _requant_args((cout,), device, 4)
    before = qconv.qconv3x3_s2_requant.launches
    got = qconv.qconv3x3_s2_requant(x, wgt, scale, offset, packed=packed)
    assert qconv.qconv3x3_s2_requant.launches == before + 1
    want = qconv.qconv3x3_s2_requant_plain(x, wgt, scale, offset)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (n, h // 2, w // 2, cout) and got.dtype == torch.int8
    assert torch.equal(got, want)
    assert (want == 0).any() and (want > 0).any()
    with pytest.raises(ValueError, match="packed"):
        qconv.qconv3x3_s2_requant(x, wgt, scale, offset, packed=packed[..., :16].contiguous())


_Q3_CHANNELS = [(8, 4), (16, 8), (24, 12), (32, 16), (48, 40), (64, 32), (128, 64)]


@pytest.mark.parametrize(
    "n,h,w,cin,cout",
    [(n, h, w, cin, cout) for n, h, w in ((1, 13, 29), (3, 13, 29), (1, 109, 109))
     for cin, cout in _Q3_CHANNELS]
    + [(3, 7, 9, 3, 4), (2, 5, 6, 20, 9), (2, 5, 6, 300, 40), (1, 6, 10, 512, 256),
       (2, 9, 13, 768, 16), (1, 3, 5, 1120, 8)],
)
def test_q3_tensor_cores_are_bit_identical_to_plain(device, n, h, w, cin, cout):
    """Q3 (the int8 tensor cores) at the edges of its GEMM, with the packed
    weights passed as the int8 net passes them: odd H and W, pixel counts
    that are no multiple of its 128-pixel tile, tiles across image rows
    and images (N = 3), channel counts below one k32 step (8, 16, 24), a
    zero-padded half step (48), cout that is no multiple of 8 (byte
    stores) or of 16, the flagship's three layers (128 -> 64, 64 -> 32,
    32 -> 16), the RGB width 3 and 20 (byte gathers), 300 (sums past
    2**22), 512 -> 256 (column slabs), 768 (B and two A buffers exceed
    shared memory: one A buffer) and 1120 (the widest that fits)."""
    from annonet_tpu_torch.ops import qconv

    x = _int8((n, h, w, cin), device, 1, -127 if cin == 3 else 0)
    wgt = _int8((2, 2, cin, cout), device, 3, -127)
    packed = qconv.pack_q3_weights(wgt)
    scale, offset = _requant_args((2, cout), device, 4)
    scale = scale * (32.0 / max(32, cin)) ** 0.5  # the sums grow with cin
    before = qconv.qup2x2_requant.launches
    got = qconv.qup2x2_requant(x, wgt, scale, offset, packed=packed)
    assert qconv.qup2x2_requant.launches == before + 1
    want = qconv.qup2x2_requant_plain(x, wgt, scale, offset)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (n, 2 * h, 2 * w, cout) and got.dtype == torch.int8
    assert torch.equal(got, want)
    assert (want == 0).any() and (want > 0).any()
    with pytest.raises(ValueError, match="packed"):
        qconv.qup2x2_requant(x, wgt, scale, offset, packed=qconv.pack_q1_weights(
            _int8((3, 3, cin, cout), device, 5)))


def test_q3_refuses_inputs_wider_than_its_shared_memory(device):
    """One A buffer of 128 rows and B's 64-column slab, each row cin
    padded to 32 plus 16 bytes, fit in the H100's 227 KiB of shared memory
    up to cin 1120; a wider input is refused, not computed in part."""
    from annonet_tpu_torch.ops import qconv

    x = _int8((1, 3, 5, 1152), device, 1, 0)
    wgt = _int8((2, 2, 1152, 8), device, 3, -127)
    scale, offset = _requant_args((2, 8), device, 4)
    with pytest.raises(RuntimeError, match="annonet_qup2x2_requant"):
        qconv.qup2x2_requant(x, wgt, scale, offset)


@pytest.mark.parametrize("cin", [256, 264])
@pytest.mark.parametrize("sign", [1, -1])
def test_q3_requant_is_exact_at_the_largest_sums(device, cin, sign):
    """All inputs -128 and all weights -128 or 127: |sum| = 16384 * cin,
    2**22 at 256 channels and past it at 264, of both signs: the extreme
    sums convert to float and requantize exactly."""
    from annonet_tpu_torch.ops import qconv

    x = torch.full((1, 3, 5, cin), -128, dtype=torch.int8, device=device)
    wgt = torch.full((2, 2, cin, 8), -128 if sign > 0 else 127, dtype=torch.int8, device=device)
    scale = _rand((2, 8), device, 6, 1.0, 1e-5)
    offset = _rand((2, 8), device, 7, -0.5, 40.0)
    if sign < 0:  # negative sums: only a negative scale reaches the grid
        scale = -scale
    got = qconv.qup2x2_requant(x, wgt, scale, offset)
    want = qconv.qup2x2_requant_plain(x, wgt, scale, offset)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and (want > 0).any()


def _blend_stress_case(kind, k, device, seed):
    """Blend inputs whose tiles form no grid: random positions, several
    tiles over most pixels ("random"), or 200 small tiles at nearly one
    position, more than the kernel lists at a time over one patch
    ("overflow")."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        n, th, tw, hp, wp = 23, 37, 53, 90, 150
        yx = np.stack([rng.integers(0, hp - th + 1, n), rng.integers(0, wp - tw + 1, n)], 1)
    else:
        n, th, tw, hp, wp = 200, 6, 9, 24, 140
        yx = np.stack([rng.integers(3, 6, n), rng.integers(60, 64, n)], 1)
    args = (
        torch.randn((n, th, tw, k), device=device),
        torch.from_numpy(yx.astype(np.int32)).to(device),
        _rand((th, tw), device, seed + 1),
        _rand((hp, wp), device, seed + 2, 0.5),
        torch.from_numpy(rng.normal(0, 0.2, k).astype(np.float32)).to(device),
        torch.from_numpy(np.abs(rng.normal(0, 0.5, k)).astype(np.float32)).to(device),
    )
    factors = tuple(torch.from_numpy(rng.random(d).astype(np.float32) + 0.5).to(device)
                    for d in (hp, wp))
    return args, factors


@pytest.mark.parametrize("k", [3, 300])
@pytest.mark.parametrize("kind", ["random", "overflow"])
@pytest.mark.parametrize("blend_dtype", [torch.float32, torch.bfloat16])
def test_blend_is_exact_for_any_tile_list(device, kind, k, blend_dtype):
    """K4 lists the tiles over each pixel patch: on tiles that form no grid
    and on more candidates over one patch than it lists at a time, with
    more classes than it sums in one walk, labels and seeds stay
    bit-identical to the plain version in every mode."""
    from annonet_tpu_torch.ops.blend import blend_argmax, blend_argmax_plain

    args, factors = _blend_stress_case(kind, k, device, 30 + k)
    for detection, reference, fold in ((True, False, False), (False, False, False),
                                       (True, True, False), (False, False, True)):
        kw = dict(with_detection=detection, reference_blend=reference,
                  blend_dtype=blend_dtype, wsum_factors=factors if fold else None)
        before = blend_argmax.launches
        labels, seeds = blend_argmax(*args, **kw)
        assert blend_argmax.launches == before + 1
        want_labels, want_seeds = blend_argmax_plain(*args, **kw)
        torch.cuda.synchronize()
        assert labels.dtype == want_labels.dtype and torch.equal(labels, want_labels)
        if detection:
            assert torch.equal(seeds, want_seeds)
    if k == 3:
        assert len(set(want_labels.flatten().tolist())) == 3


@pytest.mark.parametrize("m,k", [(1, 3), (2, 5), (1, 300)])
@pytest.mark.parametrize("blend_dtype", [torch.bfloat16, torch.float32])
def test_blend_modes_are_bit_identical_to_plain(device, m, k, blend_dtype):
    from annonet_tpu_torch.ops.blend import blend_argmax, blend_argmax_plain

    rng = np.random.default_rng(m * 1000 + k)
    th, tw, hp, wp = 40, 56, 100, 130
    ys, xs = [0, 30, 60], [0, 37, 74]  # a grid plan: the fold needs one
    yx = np.array([(y, x) for y in ys for x in xs], np.int32)
    n = len(yx)
    wy = torch.from_numpy(rng.random(hp).astype(np.float32) + 0.5).to(device)
    wx = torch.from_numpy(rng.random(wp).astype(np.float32) + 0.5).to(device)
    args = (
        torch.randn((n * m, th, tw, k), device=device),
        torch.from_numpy(yx).to(device),
        _rand((th, tw), device, 5),
        _rand((hp, wp), device, 6, 0.5),
        torch.from_numpy(rng.normal(0, 0.2, k).astype(np.float32)).to(device),
        torch.from_numpy(np.abs(rng.normal(0, 0.5, k)).astype(np.float32)).to(device),
    )
    for detection, reference, fold in ((True, False, False), (False, False, False),
                                       (True, True, False), (False, False, True)):
        kw = dict(with_detection=detection, reference_blend=reference,
                  blend_dtype=blend_dtype, wsum_factors=(wy, wx) if fold else None)
        labels, seeds = blend_argmax(*args, **kw)
        want_labels, want_seeds = blend_argmax_plain(*args, **kw)
        assert torch.equal(labels, want_labels)
        if detection:
            assert torch.equal(seeds, want_seeds)


def test_int8_tiled_inference_on_the_card_matches_the_cpu(device):
    from annonet_tpu_torch.infer.core import TiledInferer
    from annonet_tpu_torch.infer.tiling import TilingParameters
    from annonet_tpu_torch.models.segnet import (
        SegNetConfig, init_runtime_params, required_input_dimension,
    )

    config = SegNetConfig(class_count=3, level_count=2, base_width=16)
    params = init_runtime_params(config, seed=5)
    rf = required_input_dimension(config)
    tiling = TilingParameters(128, 128, rf, rf)
    image = np.random.default_rng(6).integers(0, 256, (200, 260, 3), dtype=np.uint8)
    cpu = TiledInferer(params, config, tiling, device="cpu", quantize="int8")
    want = cpu.infer_arrays(image)
    card = TiledInferer(params, config, tiling, device=device, quantize="int8",
                        calibration=cpu.export_calibration())
    got = card.infer_arrays(image)
    levels = [0.0, 0.3, 0.1]
    assert card.float_fallbacks == 0 and card._quantized
    assert (got[0] == want[0]).mean() >= 0.99
    got, want = card.infer_arrays(image, None, levels), cpu.infer_arrays(image, None, levels)
    assert (got[0] == want[0]).mean() >= 0.99 and (got[1] == want[1]).mean() >= 0.99


def bf16_step(value: float) -> float:
    """The spacing of bf16 values at ``value`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(value)) - 7)


def _g1_case(device, dtype, n, h, wb, fold, cin, cout, seed):
    from annonet_tpu_torch.ops import gemm_conv

    k1, nc = fold * cin, fold * cout
    x = _rand((n, h, wb, k1), device, seed, -0.3).to(dtype)
    mats = [_rand((3 * k1, nc), device, seed + i, -0.5, (2.0 / (9 * cin)) ** 0.5).to(dtype)
            for i in (1, 2, 3)]
    bias = _rand((cout,), device, seed + 4, -0.5, 0.2)
    return gemm_conv, x, mats, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "n,h,wb,fold,cin,cout",
    [(2, 9, 13, 8, 3, 16),  # K = 72: the RGB stem, zero-padded in each K chunk
     (1, 17, 7, 4, 3, 5),  # K1 = 12: not a multiple of 8 (unvectorised loads)
     (3, 5, 1, 2, 64, 64),  # one block per row: both neighbour terms vanish
     (1, 33, 50, 8, 16, 16), (2, 6, 3, 2, 128, 96), (1, 4, 9, 1, 40, 136)],
)
def test_g1_matches_plain(device, dtype, n, h, wb, fold, cin, cout):
    gemm_conv, x, mats, bias = _g1_case(device, dtype, n, h, wb, fold, cin, cout, 11)
    before = gemm_conv.conv3x3_gemm_aligned.launches
    got = gemm_conv.conv3x3_gemm_aligned(x, *mats, bias, fold, cin)
    assert gemm_conv.conv3x3_gemm_aligned.launches == before + 1
    want = gemm_conv.conv3x3_gemm_aligned_plain(x, *mats, bias, fold, cin)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (n, h, wb, fold * cout) and got.dtype == dtype
    top = want.float().abs().max().item()
    # both sum in f32 and round once: bf16 within one step at the largest
    # output (its unit in the last place), f32 within 1e-4 of the scale
    limit = 1e-4 * max(1.0, top) if dtype == torch.float32 else bf16_step(top)
    assert (got.float() - want.float()).abs().max().item() <= limit


@pytest.mark.parametrize("dense", [False, True], ids=["banded", "dense"])
@pytest.mark.parametrize(
    "n,h,wb,fold,cin,cout",
    [(2, 9, 109, 8, 3, 16),  # K1 = 24: the RGB stem, one zero-padded chunk
     (1, 10, 109, 8, 16, 16), (2, 7, 109, 4, 32, 32), (1, 12, 109, 2, 64, 64),
     (1, 6, 61, 8, 32, 16), (1, 5, 33, 2, 128, 64)],
)
def test_g1_block_sparse_matches_plain(device, n, h, wb, fold, cin, cout, dense):
    """bf16 G1 walks the table of nonzero blocks: on the weights of
    build_gemm_kernels_aligned it skips the band's zeros, on random dense
    Wc, Wl, Wr the table is full and nothing may be skipped; either way
    within one bf16 step of the plain version at the largest output."""
    from annonet_tpu_torch.ops import gemm_conv

    k1, nc = fold * cin, fold * cout
    x = _rand((n, h, wb, k1), device, 21, -0.3).to(torch.bfloat16)
    if dense:
        mats = [_rand((3 * k1, nc), device, 22 + i, -0.5, (2.0 / (9 * cin)) ** 0.5)
                for i in range(3)]
    else:
        k = np.random.default_rng(23).normal(0, (2.0 / (9 * cin)) ** 0.5, (3, 3, cin, cout))
        mats = [torch.from_numpy(m).to(device)
                for m in gemm_conv.build_gemm_kernels_aligned(k.astype(np.float32), fold)]
    mats = [m.to(torch.bfloat16).contiguous() for m in mats]
    bias = _rand((cout,), device, 26, -0.5, 0.2)
    table = gemm_conv.g1_block_table(*mats)
    macs = gemm_conv.table_macs(table, k1, nc)
    assert (macs == 9 * k1 * nc) if dense else (macs < 9 * k1 * nc)
    before = gemm_conv.conv3x3_gemm_aligned.launches
    got = gemm_conv.conv3x3_gemm_aligned(x, *mats, bias, fold, cin, table)
    assert gemm_conv.conv3x3_gemm_aligned.launches == before + 1
    want = gemm_conv.conv3x3_gemm_aligned_plain(x, *mats, bias, fold, cin)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (n, h, wb, nc)
    top = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= bf16_step(top)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_g1_on_the_decoders_two_part_input(device, dtype):
    """cat([up, skip]) in folded layout with the concat-permuted weights
    computes K1 on the NHWC concat."""
    from annonet_tpu_torch.models.folded_runtime import _concat_perm
    from annonet_tpu_torch.ops import conv, gemm_conv

    n, h, w, fold, c = 2, 12, 64, 4, 32
    up = _rand((n, h, w, c), device, 1).to(dtype)
    skip = _rand((n, h, w, c), device, 2).to(dtype)
    k = np.random.default_rng(3).normal(0, (1.0 / (9 * c)) ** 0.5, (3, 3, 2 * c, c))
    wc, wl, wr = gemm_conv.build_gemm_kernels_aligned(k.astype(np.float32), fold)
    perm = np.concatenate([_concat_perm(fold, c, c) + dy * fold * 2 * c for dy in range(3)])
    mats = [torch.from_numpy(m[perm]).to(device, dtype) for m in (wc, wl, wr)]
    bias = _rand((c,), device, 4, -0.5, 0.2)
    xf = torch.cat([up.view(n, h, w // fold, -1), skip.view(n, h, w // fold, -1)], -1)
    got = gemm_conv.conv3x3_gemm_aligned(xf, *mats, bias, fold, 2 * c).view(n, h, w, c)
    want = conv.conv3x3_bias_relu_plain(up, torch.from_numpy(k).to(device, dtype), bias, skip)
    torch.cuda.synchronize()
    scale = max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype] * scale


def test_pallas_conv_inference_on_the_card_matches_the_cpu(device):
    from annonet_tpu_torch.infer.core import TiledInferer
    from annonet_tpu_torch.infer.tiling import TilingParameters
    from annonet_tpu_torch.models.segnet import (
        SegNetConfig, init_runtime_params, required_input_dimension,
    )

    config = SegNetConfig(class_count=3, level_count=3, base_width=16)
    params = init_runtime_params(config, seed=7)
    rf = required_input_dimension(config)
    tiling = TilingParameters(256, 256, rf, rf)
    image = np.random.default_rng(8).integers(0, 256, (300, 420, 3), dtype=np.uint8)
    levels = [0.0, 0.5, 0.2]
    card = TiledInferer(params, config, tiling, device=device, use_pallas_conv=True)
    cpu = TiledInferer(params, config, tiling, device="cpu", use_pallas_conv=True)
    got, want = card.infer_arrays(image, None, levels), cpu.infer_arrays(image, None, levels)
    assert list(card._folded) == [8]
    assert (got[0] == want[0]).mean() >= 0.995 and (got[1] == want[1]).mean() >= 0.995


def test_cuda_tensors_never_reach_the_plain_versions(device, monkeypatch):
    from annonet_tpu_torch.infer.core import TiledInferer
    from annonet_tpu_torch.models.segnet import SegNetConfig, init_runtime_params
    from annonet_tpu_torch.ops import blend, conv, gemm_conv

    def refuse(*_args, **_kwargs):
        raise AssertionError("a plain version ran on the card")

    for module, name in ((gemm_conv, "conv3x3_gemm_aligned_plain"),
                         (conv, "conv3x3_bias_relu_plain"), (conv, "conv3x3_s2_bias_relu_plain"),
                         (conv, "up2x2_bias_relu_plain"), (blend, "blend_argmax_plain")):
        monkeypatch.setattr(module, name, refuse)
    config = SegNetConfig(class_count=3, level_count=3, base_width=16)
    inferer = TiledInferer(init_runtime_params(config, 1), config, device=device,
                           use_pallas_conv=True)
    image = np.random.default_rng(1).integers(0, 256, (200, 256, 3), dtype=np.uint8)
    before = gemm_conv.conv3x3_gemm_aligned.launches
    inferer.infer_arrays(image)
    torch.cuda.synchronize()
    # one forward: 7 stride-1 layers at folds above 1 (the flagship's)
    assert gemm_conv.conv3x3_gemm_aligned.launches == before + 7


def test_int8_path_never_reaches_the_plain_versions(device, monkeypatch):
    """The int8 inferer on the card, calibrating and then calibrated, with
    detection and in both blend dtypes, runs no plain version of an int8
    kernel, of K3's requant mode or of the blend; nor does a forward of the
    int8 net with int8 up layers (Q3)."""
    from annonet_tpu_torch.infer.core import TiledInferer
    from annonet_tpu_torch.models.segnet import SegNetConfig, init_runtime_params
    from annonet_tpu_torch.ops import blend, conv, qconv

    def refuse(*_args, **_kwargs):
        raise AssertionError("a plain version ran on the card")

    for module, name in ((qconv, "qconv3x3_requant_plain"), (qconv, "qconv3x3_acc_plain"),
                         (qconv, "qconv3x3_s2_requant_plain"), (qconv, "qup2x2_requant_plain"),
                         (conv, "up2x2_requant_plain"), (blend, "blend_argmax_plain")):
        monkeypatch.setattr(module, name, refuse)
    config = SegNetConfig(class_count=3, level_count=3, base_width=16)
    params = init_runtime_params(config, 2)
    image = np.random.default_rng(2).integers(0, 256, (200, 256, 3), dtype=np.uint8)
    before = {f: f.launches for f in (qconv.qconv3x3_requant, qconv.qconv3x3_s2_requant,
                                      conv.up2x2_requant, blend.blend_argmax,
                                      qconv.qup2x2_requant)}
    for blend_dtype in ("bfloat16", "float32"):
        inferer = TiledInferer(params, config, device=device, quantize="int8",
                               blend_dtype=blend_dtype)
        inferer.infer_arrays(image, None, [0.0, 0.5, 0.2])  # calibrates on this image
        inferer.infer_arrays(image)  # int8, no detection: the argmax fold
        assert inferer._quantized and inferer.float_fallbacks == 0
    # the int8 up layers (quantize_up): Q3 on the same calibration
    from annonet_tpu_torch.models.quantized import QuantizedSegNet, quantize_input, quantize_net

    net_up = QuantizedSegNet(quantize_net(params, config, inferer.export_calibration(),
                                          quantize_up=True), config, device=device)
    with torch.inference_mode():
        logits = net_up(quantize_input(torch.from_numpy(image[None, :64, :64].copy()).to(device)))
    torch.cuda.synchronize()
    assert torch.isfinite(logits).all()
    runs = {f: f.launches - n for f, n in before.items()}
    # two int8 forwards of each inferer: 8 Q1, 3 Q2 and 3 K3-requant layers;
    # then one forward with 3 Q3 layers
    assert runs[qconv.qconv3x3_requant] >= 4 * 8 + 8 and runs[qconv.qconv3x3_s2_requant] >= 4 * 3
    assert runs[conv.up2x2_requant] >= 4 * 3 and runs[blend.blend_argmax] == 4
    assert runs[qconv.qup2x2_requant] == 3


# ---------------------------------------------------------------- training


def _train_samples(seed=0):
    from annonet_tpu_torch.data.sample import Sample

    rng = np.random.default_rng(seed)
    out = []
    for h, w in [(90, 120), (60, 50)]:
        labels = rng.integers(0, 3, (h, w)).astype(np.uint16)
        labels[:5] = 65535
        out.append(Sample(input_image=rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                          label_image=labels))
    return out


def test_pool_gather_bit_identical_on_the_card(device):
    from annonet_tpu_torch.ops.crop_gather import gather_crops
    from annonet_tpu_torch.train import DeviceImagePool

    samples = _train_samples()
    which = [0, 1, 0, 1, 1]
    corners = [(-7, -3), (30, 20), (100, 70), (-20, 40), (10, -15)]
    dim = 40
    rng = np.random.default_rng(1)
    flip_lr = torch.from_numpy(rng.random(len(which)) < 0.5)
    flip_ud = torch.from_numpy(rng.random(len(which)) < 0.5)
    out = []
    for d in (device, torch.device("cpu")):
        pool = DeviceImagePool(2, device=d)
        slots = pool.ensure([samples[i] for i in which])
        hs, ws = pool.valid_dims(slots)
        assert int(pool.labels[int(slots[0]), 0, 0]) == 65535  # IGNORE survives the upload
        out.append([t.cpu() for t in gather_crops(
            pool.images, pool.labels, torch.from_numpy(slots),
            torch.tensor([c[1] for c in corners]), torch.tensor([c[0] for c in corners]),
            torch.from_numpy(hs), torch.from_numpy(ws), dim, flip_lr=flip_lr, flip_ud=flip_ud)])
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])


def test_train_step_card_vs_cpu(device):
    """One pool step, f32 compute (TF32 off), the same draws: the loss within
    1e-5 relative and each updated tensor within 1e-3 of its largest
    update (cuDNN and the CPU only reorder f32 sums)."""
    from annonet_tpu_torch.data.crop import CropOptions
    from annonet_tpu_torch.models.segnet import SegNetConfig, tree_items, tree_to_numpy
    from annonet_tpu_torch.ops.augment import draw_augmentations
    from annonet_tpu_torch.train import DeviceImagePool, Trainer, TrainerConfig

    config = SegNetConfig(class_count=3, level_count=2, base_width=8, compute_dtype="float32")
    samples = _train_samples(2)
    dim = 48
    rects = [(x, y, x + dim - 1, y + dim - 1) for x, y in [(-5, -5), (30, 20), (90, 60),
                                                          (10, 30)]]
    crop_samples = [samples[0], samples[1], samples[0], samples[1]]
    options = CropOptions(dim=dim, allow_flip_left_right=True, allow_flip_upside_down=True,
                          multiplicative_brightness_change_probability=0.5,
                          noise_level_stddev=2.0, allow_random_color_offset=True)
    gen = torch.Generator()
    gen.manual_seed(0)
    draws = draw_augmentations(gen, len(rects), (dim, dim, 3), options)
    losses, params = [], []
    for d in (device, torch.device("cpu")):
        trainer = Trainer(config, TrainerConfig(), seed=0, device=d)
        before = dict(tree_items(tree_to_numpy(trainer.params)))
        losses.append(trainer.train_step_decisions(DeviceImagePool(2, device=d), crop_samples,
                                                   rects, options, draws=draws))
        params.append(dict(tree_items(tree_to_numpy(trainer.params))))
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[1])
    for key, cpu in params[1].items():
        update = np.abs(cpu - before[key]).max()
        assert np.abs(params[0][key] - cpu).max() <= 1e-3 * update, key


def test_update_params_then_validation_launches_the_kernels(device):
    from annonet_tpu_torch.infer.core import TiledInferer, annonet_infer
    from annonet_tpu_torch.models.segnet import SegNetConfig, init_runtime_params
    from annonet_tpu_torch.ops import blend, conv, qconv

    config = SegNetConfig(class_count=3, level_count=2, base_width=16)
    image = np.random.default_rng(0).integers(0, 256, (300, 260, 3), dtype=np.uint8)
    old, new = init_runtime_params(config, 0), init_runtime_params(config, 1)
    float_kernels = (conv.conv3x3_bias_relu, conv.conv3x3_s2_bias_relu, conv.up2x2_bias_relu,
                     blend.blend_argmax)
    int8_kernels = (qconv.qconv3x3_requant, qconv.qconv3x3_s2_requant, conv.up2x2_requant,
                    blend.blend_argmax)
    for quantize, kernels in ((None, float_kernels), ("int8", int8_kernels)):
        inferer = TiledInferer(old, config, device=device, quantize=quantize)
        annonet_infer(inferer, image)
        inferer.update_params(new)
        for fn in kernels:
            fn.launches = 0
        labels = annonet_infer(inferer, image)
        assert all(fn.launches > 0 for fn in kernels), [fn.launches for fn in kernels]
        fresh = annonet_infer(TiledInferer(new, config, device=device, quantize=quantize), image)
        assert np.array_equal(labels, fresh)
