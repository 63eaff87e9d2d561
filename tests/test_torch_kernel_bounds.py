"""The bounds that chip_smoke.py prints beside each conv kernel's time, on
the CPU: the flagship's layer tensors at one 872x872 tile of the inferer's
4096x4096 plan, built with torch.empty from ``chip_smoke.conv_calls``.

bound = max(bytes moved / 3.35 TB/s, operations / the peak of their type),
summed over the layers a kernel runs. f32 convs run on the CUDA cores, so
their operations count at 67 TFLOP/s, not at the bf16 tensor-core peak of
989 TFLOP/s. Expected values are recounted from the layer shapes (widths
16/32/64/128): K1 35.7 GFLOP a tile, of which stem/conv0 is bound by its
bytes; K2 5.25 GFLOP; K3 2.3 GFLOP, bound per layer by bytes at dec1/up and
by operations at the two deeper up layers. The bf16 values are those the
script printed before the f32 bound was repaired (PERF.md, row 1-3 / 25).
"""

import importlib.util
import os

import pytest
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = _chip_smoke()


def _tensors(kernel, shape, c2, cout, dtype):
    """Empty x, x2 (None without a concat), w and out of one layer."""
    k = 2 if kernel.startswith("up") else 3
    x = torch.empty(shape, dtype=dtype)
    x2 = torch.empty(shape[:3] + (c2,), dtype=dtype) if c2 else None
    if kernel.startswith("up"):
        out_hw = (2 * shape[1], 2 * shape[2])
    else:
        s = 2 if "s2" in kernel else 1
        out_hw = (shape[1] // s, shape[2] // s)
    w = torch.empty((k, k, shape[3] + c2, cout), dtype=dtype)
    return x, x2, w, torch.empty((shape[0], *out_hw, cout), dtype=dtype)


def _layer_bounds(dtype, kind):
    """{kernel: [(layer, ms, binds)]} of the flagship at one 872² tile."""
    from annonet_tpu_torch.models.segnet import conv_layers

    config = cs.flagship_config()
    plan = cs.canvas_plan(config)
    assert (plan.tile_count, plan.tile_height) == (25, 872)
    couts = {f"{block}/{conv}": shape[3] for block, conv, shape in conv_layers(config)}
    bounds = {}
    for kernel, layer, shape, c2, key in cs.conv_calls(config, 1, plan.tile_height):
        x, x2, w, out = _tensors(kernel, shape, c2, couts[key], dtype)
        ms, binds = cs.conv_bound(kernel, x, w, torch.empty(couts[key]), out, x2, kind)
        bounds.setdefault(kernel, []).append((layer, ms, binds))
    return bounds


@pytest.mark.parametrize("kernel,want_ms", [("conv3x3_bias_relu", 0.540),
                                            ("conv3x3_s2_bias_relu", 0.078)])
def test_f32_k1_and_k2_are_bound_by_operations(kernel, want_ms):
    layers = _layer_bounds(torch.float32, "f32")[kernel]
    total = sum(ms for _layer, ms, _binds in layers)
    assert total == pytest.approx(want_ms, rel=0.01)
    by_ops = sum(ms for _layer, ms, binds in layers if binds == "operations")
    assert by_ops > 0.9 * total
    # only the RGB stem (3 input channels, 11 FLOP a byte) is bound by bytes
    assert [layer for layer, _ms, binds in layers if binds == "bytes"] == (
        ["stem/conv0"] if kernel == "conv3x3_bias_relu" else [])


def test_f32_k3_bound_is_its_layers_sum():
    layers = _layer_bounds(torch.float32, "f32")["up2x2_bias_relu"]
    binds = {layer: b for layer, _ms, b in layers}
    assert binds == {"dec3/up": "operations", "dec2/up": "operations", "dec1/up": "bytes"}
    # 2.34 GFLOP at 67 TFLOP/s is 0.035 ms and the three layers' bytes 0.038
    # ms; each layer is bound by the larger of its own two: 0.045 ms in all
    assert sum(ms for _layer, ms, _b in layers) == pytest.approx(0.0450, rel=0.01)


@pytest.mark.parametrize("kernel,want_ms", [("conv3x3_bias_relu", 0.077404),
                                            ("conv3x3_s2_bias_relu", 0.019124),
                                            ("up2x2_bias_relu", 0.019092)])
def test_bf16_bounds_are_unchanged(kernel, want_ms):
    layers = _layer_bounds(torch.bfloat16, "bf16")[kernel]
    assert sum(ms for _layer, ms, _binds in layers) == pytest.approx(want_ms, rel=1e-4)


@pytest.mark.parametrize("dtype,kind", [(torch.float32, "f32"), (torch.bfloat16, "bf16")])
def test_check_convs_bounds_each_dtype_at_its_peak(monkeypatch, dtype, kind):
    """check_convs on the CPU (the wrappers take their plain versions) at a
    small tile: each kernel's tallied bound is its layers' conv_bound at
    the peak of the dtype's type."""
    from annonet_tpu_torch.models.segnet import init_runtime_params, runtime_params_from_numpy

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    config = cs.flagship_config()
    params = runtime_params_from_numpy(init_runtime_params(config, 0), config, "cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    tol = cs.F32_TOL if dtype == torch.float32 else cs.BF16_TOL
    results = cs.check_convs(params, config, "cpu", 1, 32, dtype, tol, 0, gen)
    for kernel, r in results.items():
        want = 0.0
        for k, _layer, shape, c2, key in cs.conv_calls(config, 1, 32):
            if k == kernel:
                w, b = params[key + "/w"], params[key + "/b"]
                x, x2, _w, out = _tensors(k, shape, c2, w.shape[3], dtype)
                want += cs.conv_bound(k, x, w.to(dtype), b, out, x2, kind)[0]
        assert r["bound_ms"] == pytest.approx(want, rel=1e-9)
        assert r["max_abs_err"] == 0.0


def _g1_bounds(dtype, n):
    """[(layer, ms, binds)] and the dense GEMM's operations of
    chip_smoke.g1_bound on the flagship's 7 folded stride-1 layers (weights
    from seed 0 in ``dtype``, their block tables) at n of the inferer's
    872x872 tiles."""
    import dataclasses

    from annonet_tpu_torch.models.folded_runtime import FoldedSegNet, folding_supported
    from annonet_tpu_torch.models.segnet import init_runtime_params

    config = dataclasses.replace(cs.flagship_config(), compute_dtype=dtype)
    side = cs.canvas_plan(config).tile_height
    net = FoldedSegNet(init_runtime_params(config, 0), config, folding_supported(config, side),
                       device="cpu")
    shapes = {layer: (shape, c2) for _k, layer, shape, c2, _key in cs.conv_calls(config, n, side)}
    dense, layers = 0.0, []
    for kind, name, f in net.entries:
        if not kind.startswith("s1p:"):
            continue
        (nb, h, w, cin), c2 = shapes[name]
        mats = [net.param(name, k) for k in ("wc", "wl", "wr")]
        b = net.param(name, "b")
        x = torch.empty((nb, h, w // f, f * (cin + c2)), device="meta", dtype=mats[0].dtype)
        out = torch.empty((nb, h, w // f, mats[0].shape[1]), device="meta", dtype=mats[0].dtype)
        (ms, binds), gemm_ops, _table_ops, _weight_ops = cs.g1_bound(
            x, *mats, b, net.param(name, "table"), out)
        dense += gemm_ops
        layers.append((name, ms, binds))
    return layers, dense


@pytest.mark.parametrize("n,want_ms,stem_ms", [(25, 12.198, 0.4313), (1, 0.488, 0.01728)])
def test_f32_g1_bound_is_the_table_operations_at_the_f32_peak(n, want_ms, stem_ms):
    """f32 G1's bound: the products with a nonzero weight, the conv's own
    (804.8 GFLOP on the 25-tile batch), at 67 TFLOP/s, or the bytes. The
    RGB stem needs 16.4 GFLOP, less than its 16 x 16 table lists (38.3: a
    16-row chunk spans 5.3 pixels of K1 = 24), so it is bound by its bytes
    (0.431 ms on the 25 tiles, x 0.228 GB and out 1.217 GB at 3.35 TB/s); every other layer's table lists exactly
    its products and is bound by them. The dense GEMM's are 3.81 TFLOP."""
    layers, dense = _g1_bounds("float32", n)
    assert len(layers) == 7
    assert [(name, binds) for name, _ms, binds in layers if binds == "bytes"] == [
        ("stem/conv0", "bytes")]
    assert layers[0][1] == pytest.approx(stem_ms, rel=1e-3)
    assert sum(ms for _name, ms, _b in layers) == pytest.approx(want_ms, abs=0.0005 * n)
    assert dense / n * 25 == pytest.approx(3.8104e12, rel=1e-4)


def test_bf16_g1_bound_is_unchanged():
    """Counting the nonzero weights' products in place of the 32 x 32
    table's leaves bf16 G1's bound where it was (every layer but dec3/conv0
    is bound by its bytes): 1.846 ms on the 25-tile batch."""
    layers, _dense = _g1_bounds("bfloat16", 25)
    assert sum(ms for _name, ms, _b in layers) == pytest.approx(1.8461, rel=1e-3)
    assert [name for name, _ms, binds in layers if binds == "operations"] == ["dec3/conv0"]


@pytest.mark.parametrize("element_bytes,forward_ms,backward_ms",
                         [(2, 0.6536, 0.9803), (4, 1.3071, 1.9607)])
def test_bn_relu_bound_is_its_passes_over_the_units(element_bytes, forward_ms, backward_ms):
    """The BN + ReLU op's byte bound at the flagship train step (batch 128
    of 192² crops): its 14 units see 4,276,224 values a crop (stem and dec1
    2 x 16 x 192², enc1 and dec2 2 x 32 x 96², enc2 and dec3 2 x 64 x 48²,
    enc3 2 x 128 x 24²), 547.4 M at batch 128; the function's own bytes,
    two passes forward (h in, y out) and three backward (h and dy in, dh
    out), at 3.35 TB/s."""
    units = cs.bn_relu_units(cs.flagship_config(), cs.train_crop_dim(cs.flagship_config()))
    assert [u[0] for u in units if u[3]] == ["dec3/up", "dec2/up", "dec1/up"]
    assert len(units) == cs.BN_RELU_UNITS
    assert sum(c * side * side for _unit, c, side, _sliced in units) == 4_276_224
    fwd, bwd = cs.bn_relu_bound(units, cs.TRAIN_BATCH, element_bytes)
    assert fwd == pytest.approx(forward_ms, rel=1e-4)
    assert bwd == pytest.approx(backward_ms, rel=1e-4)


def test_bn_relu_design_traffic_is_three_and_five_passes():
    """The two-kernel design's traffic (statistics whole before the first
    output): 0.9803 ms forward and 1.6339 backward in bf16 at batch 128."""
    units = cs.bn_relu_units(cs.flagship_config(), cs.train_crop_dim(cs.flagship_config()))
    fwd, bwd = cs.bn_relu_bound(units, cs.TRAIN_BATCH, passes=cs.BN_RELU_DESIGN_PASSES)
    assert fwd == pytest.approx(0.9803, rel=1e-4)
    assert bwd == pytest.approx(1.6339, rel=1e-4)


def test_unet_bn_units_and_their_kernels_floors():
    """The U-Net cell's 18 BN units (its linear up layers have none) at
    batch 16 of 624² crops: widths 64-1024 at sides 624 to 39 and back,
    3,040,247,808 values; a pass over them is 1.815 ms at 3.35 TB/s, so
    the four kernels' streaming floors (1, 2, 2 and 3 passes) are 1.815,
    3.630, 3.630 and 5.445 ms."""
    units = cs.bn_relu_units(cs.unet_config(), cs.UNET_CROP)
    assert [(c, side) for _unit, c, side, _sliced in units] == [
        (64, 624), (64, 624), (128, 312), (128, 312), (256, 156), (256, 156), (512, 78),
        (512, 78), (1024, 39), (1024, 39), (512, 78), (512, 78), (256, 156), (256, 156),
        (128, 312), (128, 312), (64, 624), (64, 624)]
    assert not any(sliced for *_rest, sliced in units)
    values = sum(cs.UNET_BATCH * c * side * side for _unit, c, side, _sliced in units)
    assert values == 3_040_247_808
    per_pass = values * 2 / cs.HBM_BYTES_PER_S * 1e3
    floors = {kind: passes * per_pass for kind, passes in cs.BN_RELU_KERNEL_PASSES.items()}
    assert floors == pytest.approx({"reduce forward": 1.8151, "apply": 3.6301,
                                    "reduce backward": 3.6301, "grad": 5.4452}, rel=1e-4)


@pytest.mark.parametrize("name,kind", [
    ("void annonet::(anonymous namespace)::bn_reduce_kernel<__nv_bfloat16, 8, false>"
     "(__nv_bfloat16 const*, __nv_bfloat16 const*, long, long, int, int, int)", "reduce forward"),
    ("void annonet::(anonymous namespace)::bn_reduce_kernel<float, 4, true>(float const*)",
     "reduce backward"),
    ("void annonet::(anonymous namespace)::bn_relu_apply_kernel<float, 1>(float const*)", "apply"),
    ("void annonet::(anonymous namespace)::bn_relu_grad_kernel<__nv_bfloat16, 8>(int)", "grad"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", None),
])
def test_bn_relu_kernel_kind_reads_the_profiler_names(name, kind):
    assert cs.bn_relu_kernel_kind(name) == kind


def test_label_weights_bounds_count_the_labels_and_the_weights():
    """The loss weights at the U-Net cell's batch (16 x 624², 6,230,016
    pixels): the function reads 4-byte labels and writes 4-byte weights,
    49.8 MB, 14.9 us at 3.35 TB/s; the op reads the labels twice, 74.8 MB,
    22.3 us. At the flagship cell's (128 x 192²): 37.7 and 56.6 MB."""
    assert cs.label_weights_bytes(16, 624, 624) == 49_840_128
    assert cs.label_weights_bytes(16, 624, 624, cs.LABEL_WEIGHTS_DESIGN_READS) == 74_760_192
    assert cs.label_weights_bound(16, 624, 624) == pytest.approx(0.014878, rel=1e-4)
    assert cs.label_weights_bound(16, 624, 624, 2) == pytest.approx(0.022317, rel=1e-4)
    assert cs.label_weights_bytes(128, 192, 192) == 37_748_736
    assert cs.label_weights_bytes(128, 192, 192, 2) == 56_623_104
    assert [b[1:] for b in cs.LABEL_WEIGHTS_BATCHES] == [(16, 624, 624), (128, 192, 192)]
