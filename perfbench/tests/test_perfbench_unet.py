"""The U-Net cell on the CPU at a small size: its driver against the plain
reference, a broken timed path, the U-Net's counts and its readers; the
parent program, which has no U-Net, refuses the U-Net's configuration at
once."""

import types

import numpy as np
import pytest
import torch

from perfbench import run
from perfbench.lib import manifest, unet
from perfbench.lib.trace import Trace

UNET = "unet.train_b16_c624"
SMALL = dict(pool_images=3, image_side=96, batch=8, crop=64, planned_steps=6, warmup_steps=1)


def _bench(**config_changes):
    bench = manifest.load()
    mix, config = bench.mix, bench.config
    bench.mix = lambda t: dict(mix(t), **SMALL)
    bench.config = lambda n: dict(config(n), compute_dtype="float32", **config_changes)
    return bench


def test_a_sound_float32_unet_run_agrees_with_the_reference():
    """Widths 8-64 over three levels, float32: the same function on both
    sides, to round-off."""
    r = run.run_cell(_bench(base_width=8, level_count=3), UNET, 2**31 + 21, 0.3, False,
                     torch.device("cpu"))
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert all(c["value"] <= 1e-2 for c in r["checks"].values()), r["checks"]
    assert set(r["metrics"]) == {"train_crops_per_s", "setup_s"}


def test_a_half_batch_unet_run_comes_out_not_correct(monkeypatch):
    from perfbench.drivers import unet_train

    original = unet_train.Cell.__init__

    def half(self, config, mix, seed, device, half_batch=False):
        original(self, config, mix, seed, device, half_batch=True)

    monkeypatch.setattr(unet_train.Cell, "__init__", half)
    r = run.run_cell(_bench(base_width=8, level_count=3), UNET, 2**31 + 22, 0.3, False,
                     torch.device("cpu"))
    assert not r["correct"], r["checks"]


def test_a_program_without_the_unet_refuses_its_configuration(monkeypatch):
    """The parent commit's SegNetConfig has no ``topology``: the cell's
    set-up fails before any weight or scene is made."""
    import dataclasses

    from annonet_tpu_torch.models import segnet

    @dataclasses.dataclass(frozen=True)
    class Old:
        class_count: int = 2
        level_count: int = 2
        width_scaler: float = 1.0
        min_filter_count: int = 1
        grayscale: bool = False
        base_width: int = 16
        compute_dtype: str = "bfloat16"

    monkeypatch.setattr(segnet, "SegNetConfig", Old)
    from perfbench.drivers import unet_train

    with pytest.raises(TypeError, match="topology"):
        unet_train.Cell(manifest.load().config("unet_bn_rgb"), dict(SMALL), 1,
                        torch.device("cpu"))


def test_the_unet_counts():
    """The configuration file's counts: 1,470,208 forward FLOP a pixel,
    31.0 M parameters (the batch norms' gamma and beta included), 488
    batch norm channels a pixel, 9.08 ms of the op's byte bound a step at
    batch 16 of 624^2."""
    config = manifest.load().config("unet_bn_rgb")
    assert unet.flop_per_pixel(config) == 1470208
    tree = unet.train_tree(torch.Generator().manual_seed(1), config)
    assert sum(v.size for v in tree.values()) == config["parameters"] == 31037763
    assert unet.bn_channels_per_pixel(config) == 488
    assert unet.bn_relu_bound_ms(config, 16 * 624 ** 2) == pytest.approx(9.0754, abs=1e-4)
    assert unet.step_flop(config, 16 * 624 ** 2) == pytest.approx(27.478e12, rel=1e-4)


def _event(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_the_unet_readers_on_a_known_trace():
    """Two steps: 100 ms of conv kernels, 20 of the op's, 3 of pools and
    others: each reader's share of its count."""
    bench = manifest.load()
    config = bench.config("unet_bn_rgb")
    mix = bench.mix("train_b16_c624")
    names = {"sm90_xmma_fprop_implicit_gemm_bf16": 40e3, "cutlass_tensorop_s16816dgrad": 35e3,
             "sm80_xmma_wgrad_implicit_gemm": 25e3,
             "void annonet::(anonymous namespace)::bn_reduce_kernel<__nv_bfloat16>": 8e3,
             "void annonet::(anonymous namespace)::bn_relu_apply_kernel<...>": 4e3,
             "void annonet::(anonymous namespace)::bn_relu_grad_kernel<...>": 8e3,
             "void at::native::max_pool_forward_nhwc<c10::BFloat16>": 1e3,
             "void at::native::max_pool_backward_nhwc<c10::BFloat16>": 2e3,
             "void at::native::elementwise_kernel<128, 4>": 5e3}
    events, ts = [], 0.0
    for name, dur in names.items():
        events.append(_event(name, ts, dur))
        ts += dur
    trace = Trace(events, ts * 1e-6)
    runs = types.SimpleNamespace(config=config, mix=mix, trace=trace,
                                 window={"calls": 2, "seconds": ts * 1e-6})
    flop = unet.step_flop(config, 16 * 624 ** 2) * 2
    got = {m: bench.reader(m)(runs) for m in ("conv_peak_pct.unet", "bn_relu_bound_pct.unet",
                                              "pool_device_ms.unet", "mfu_pct.unet")}
    assert got["conv_peak_pct.unet"] == pytest.approx(100 * flop / 0.1 / 989e12)
    assert got["bn_relu_bound_pct.unet"] == pytest.approx(100 * 2 * 9.0754e-3 / 0.020, rel=1e-4)
    assert got["pool_device_ms.unet"] == pytest.approx(1.5)
    assert got["mfu_pct.unet"] == pytest.approx(100 * flop / (ts * 1e-6) / 989e12)
    empty = types.SimpleNamespace(config=config, mix=mix, trace=Trace([], 1.0),
                                  window={"calls": 2, "seconds": 1.0})
    assert all(bench.reader(m)(empty) is None
               for m in ("conv_peak_pct.unet", "bn_relu_bound_pct.unet", "pool_device_ms.unet"))


def test_the_seed_makes_the_unet_weights():
    config = manifest.load().config("unet_bn_rgb")
    small = dict(config, base_width=4)
    a = unet.train_tree(torch.Generator().manual_seed(2**31 + 9), small)
    b = unet.train_tree(torch.Generator().manual_seed(2**31 + 9), small)
    np.testing.assert_array_equal(a["dec4/up"], b["dec4/up"])
    assert a["dec4/up"].shape == (2, 2, 64, 32) and not a["dec4/up_bias"].any()
