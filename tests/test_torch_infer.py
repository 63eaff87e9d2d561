"""The port's tiled inference (annonet_tpu_torch/infer/core.py) against the
JAX package's ``TiledInferer``.

Plans equal the JAX default inferer's (the folded net), but for its
3-tile bump, which the port does not make. Against the JAX inferer with
the unfolded net (``use_folded_net=False``), whose plan is the same at the
64-px tiles used here: on a float32 config with a multi-tile plan the
label maps agree on >= 99.9% of pixels (identical is expected; the margin
covers a near-tie flipped by another summation order). This holds with and
without gains, with detection levels (seeds and the blob veto), under the
reference blend semantics, and for same-size image batches. Against the
default width-folded JAX inferer, whose convs sum in yet another order, the
labels agree on >= 99.5%.
"""

import dataclasses

import numpy as np
import pytest
import torch

from annonet_tpu.infer import core as jax_core
from annonet_tpu.infer.tiling import TilingParameters as JaxTilingParameters
from annonet_tpu.models.segnet import SegNetConfig as JaxSegNetConfig
from annonet_tpu_torch.infer import core
from annonet_tpu_torch.infer.tiling import TilingParameters, default_tile_max
from annonet_tpu_torch.models.folded_runtime import folding_supported
from annonet_tpu_torch.models.segnet import (
    SegNetConfig,
    init_runtime_params,
    required_input_dimension,
)
from tests.test_torch_model import jax_runtime_tree

CONFIG = SegNetConfig(class_count=3, level_count=2, base_width=4, compute_dtype="float32")
RF = required_input_dimension(CONFIG)
TILING = TilingParameters(64, 64, RF, RF)
SHAPE = (150, 200, 3)  # a 3 x 6 grid of 64x64 tiles
GAINS = [0.0, 0.15, -0.1]
LEVELS = [0.0, 0.3, 0.1]


@pytest.fixture(scope="module")
def tree():
    return jax_runtime_tree(CONFIG, seed=21)


@pytest.fixture(scope="module")
def image():
    rng = np.random.default_rng(5)
    # smooth structure so the random net's classes come in blobs
    coarse = rng.integers(0, 256, size=(10, 14, 3)).astype(np.float32)
    smooth = np.kron(coarse, np.ones((16, 16, 1)))[: SHAPE[0], : SHAPE[1]]
    noise = rng.integers(-20, 21, size=SHAPE)
    return np.clip(smooth + noise, 0, 255).astype(np.uint8)


def _pair(tree, reference_blend=False):
    ours = core.TiledInferer(tree, CONFIG, TILING, device="cpu",
                             reference_blend_semantics=reference_blend)
    theirs = jax_core.TiledInferer(
        tree, JaxSegNetConfig(**CONFIG.to_dict()),
        JaxTilingParameters(**dataclasses.asdict(TILING)), use_folded_net=False,
        reference_blend_semantics=reference_blend,
    )
    return ours, theirs


def _agree(a, b):
    assert a.shape == b.shape
    return float((np.asarray(a) == np.asarray(b)).mean())


@pytest.mark.parametrize("shape", [(150, 200), (64, 64), (700, 90), (4096, 4096), (1500, 2300)])
def test_plans_equal_the_jax_unfolded_plans(tree, shape):
    """At 64-px tiles the lane round-up changes nothing, so the port's plans
    are also the JAX unfolded inferer's: the label comparisons below rest
    on that."""
    ours, theirs = _pair(tree)
    assert dataclasses.astuple(ours.plan(*shape)) == dataclasses.astuple(theirs.plan(*shape))


FLAGSHIP = SegNetConfig(class_count=3, level_count=3, base_width=16)
# 4 * 32 = 128 lanes, but fold 4 < 2**3: this config does not fold
NO_FOLD = SegNetConfig(class_count=3, level_count=3, base_width=32)


def _grid(plan):
    return len({y for y, _ in plan.tile_yx}), len({x for _, x in plan.tile_yx})


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["float", "int8"])
@pytest.mark.parametrize("config", [FLAGSHIP, CONFIG, NO_FOLD], ids=["flagship", "small", "no_fold"])
@pytest.mark.parametrize("shape", [(4096, 4096), (1500, 2300), (3000, 5000), (150, 200),
                                   (700, 90), (2048, 1100)])
def test_plans_equal_the_jax_default_plans(shape, config, quantize):
    """Against JAX's default inferer (the folded net, the default tile
    max of the CUDA build, 1024): equal plans, except that the port does
    not bump an axis of exactly 3 tiles to 4 (a TPU measurement); there the
    plan is JAX's ``plan_tiles`` without the lane round-up."""
    from annonet_tpu.infer.tiling import plan_tiles as jax_plan_tiles

    tiling = core.default_tiling(config)
    params = init_runtime_params(config, 0)
    jcfg = JaxSegNetConfig(**config.to_dict())
    jtiling = JaxTilingParameters(**dataclasses.asdict(tiling))
    ours = core.TiledInferer(params, config, device="cpu", quantize=quantize)
    theirs = jax_core.TiledInferer(params, jcfg, jtiling, quantize=quantize)
    got, want = ours.plan(*shape), theirs.plan(*shape)
    folds = folding_supported(config, 8 * 128) > 0
    if folds and 3 in _grid(got):
        assert _grid(want) != _grid(got)  # JAX bumped the 3-tile axis
        want = jax_plan_tiles(*shape, jcfg, jtiling, canvas_bucket=128,
                              lane_align_tiles=False)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)


def test_flagship_plan_at_4096():
    """The default tile max is the reference's CUDA 1024: a 4096x4096
    image plans to 25 tiles of 872x872 with overlap 62, as JAX's default
    inferer plans it (no lane round-up: 872 = 8 * 109 folds by 8, so the
    int8 path and the folded net apply)."""
    inferer = core.TiledInferer(
        init_runtime_params(FLAGSHIP, 0), FLAGSHIP, device="cpu"
    )
    plan = inferer.plan(4096, 4096)
    assert default_tile_max() == 1024
    assert (plan.tile_count, plan.tile_height, plan.tile_width, plan.overlap_y) == (
        25, 872, 872, 62
    )
    assert _grid(plan) == (5, 5) and folding_supported(FLAGSHIP, plan.tile_width) == 8
    # the 2300x1500 image has 3 columns: the port keeps them (no bump)
    assert _grid(inferer.plan(1500, 2300))[1] == 3


@pytest.mark.parametrize(
    "gains,levels,reference_blend",
    [(None, None, False), (GAINS, None, False), (GAINS, LEVELS, False),
     (None, LEVELS, True), (GAINS, LEVELS, True)],
)
def test_labels_and_seeds_agree_with_jax(tree, image, gains, levels, reference_blend):
    ours, theirs = _pair(tree, reference_blend)
    labels, seeds = ours.infer_arrays(image, gains, levels)
    want_labels, want_seeds = theirs.infer_arrays(image, gains, levels)
    assert labels.shape == SHAPE[:2]
    assert _agree(labels, want_labels) >= 0.999
    assert len(np.unique(labels)) > 1
    if levels is None:
        assert seeds is None and want_seeds is None
    else:
        assert seeds.dtype == np.bool_ and seeds.any()
        assert _agree(seeds, want_seeds) >= 0.999
        result = core.annonet_infer(ours, image, gains, levels)
        want = jax_core.annonet_infer(theirs, image, gains, levels)
        assert result.dtype == np.uint16
        assert _agree(result, want) >= 0.999
        assert (result == 0).sum() >= (labels == 0).sum()  # the veto only clears


def test_image_batch_agrees_with_jax_and_with_single_images(tree, image):
    ours, theirs = _pair(tree)
    batch = np.stack([image, image[::-1].copy(), 255 - image])
    labels, seeds = ours.infer_arrays_batch(batch, GAINS, LEVELS)
    want_labels, want_seeds = theirs.infer_arrays_batch(batch, GAINS, LEVELS)
    assert labels.shape == (3,) + SHAPE[:2]
    assert _agree(labels, want_labels) >= 0.999 and _agree(seeds, want_seeds) >= 0.999
    for i in range(3):
        single, single_seeds = ours.infer_arrays(batch[i], GAINS, LEVELS)
        np.testing.assert_array_equal(labels[i], single)
        np.testing.assert_array_equal(seeds[i], single_seeds)
    result = core.annonet_infer_batch(ours, batch, GAINS, LEVELS)
    want = jax_core.annonet_infer_batch(theirs, batch, GAINS, LEVELS)
    assert result.shape == batch.shape[:3] and _agree(result, want) >= 0.999


@pytest.mark.parametrize("levels", [None, LEVELS], ids=["plain", "detection"])
def test_device_output_is_the_padded_canvas_as_in_jax(tree, image, levels):
    """device_output=True keeps the labels and seeds of the padded canvas
    on the inferer's device, in the shapes and dtypes of JAX's
    device_output (single and batched); cropped (on the device, or by
    HostReadback) they equal the default call's results. pad_to_bucket is
    accepted as True, False or an int >= M, and an int < M raises, as in
    JAX."""
    ours, theirs = _pair(tree)
    h, w = SHAPE[:2]
    labels, seeds = ours.infer_arrays(image, GAINS, levels, device_output=True)
    want_labels, want_seeds = theirs.infer_arrays(image, GAINS, levels, device_output=True)
    assert isinstance(labels, torch.Tensor) and labels.device == ours.device
    assert tuple(labels.shape) == want_labels.shape == (256, 256)
    assert labels.numpy().dtype == want_labels.dtype
    if levels is None:
        assert seeds is None and want_seeds is None
    else:
        assert tuple(seeds.shape) == want_seeds.shape and seeds.dtype == torch.bool
    crop_labels, crop_seeds = ours.infer_arrays(image, GAINS, levels)
    np.testing.assert_array_equal(labels[:h, :w].numpy(), crop_labels)
    host_labels, host_seeds = core.HostReadback(labels, seeds, h, w).wait()
    assert host_labels.dtype == np.int32
    np.testing.assert_array_equal(host_labels, crop_labels)
    if levels is not None:
        np.testing.assert_array_equal(seeds[:h, :w].numpy(), crop_seeds)
        np.testing.assert_array_equal(host_seeds, crop_seeds)

    batch = np.stack([image, 255 - image])
    want_batch = theirs.infer_arrays_batch(batch, GAINS, levels, device_output=True)[0]
    crop_batch = ours.infer_arrays_batch(batch, GAINS, levels)[0]
    for pad in (True, False, 2, 5):
        got, got_seeds = ours.infer_arrays_batch(batch, GAINS, levels, device_output=True,
                                                 pad_to_bucket=pad)
        assert tuple(got.shape) == want_batch.shape == (2, 256, 256)
        assert (got_seeds is None) == (levels is None)
        np.testing.assert_array_equal(core.HostReadback(got, got_seeds, h, w).wait()[0],
                                      crop_batch)
    for impl in (ours, theirs):
        with pytest.raises(ValueError, match="pad_to_bucket"):
            impl.infer_arrays_batch(batch, GAINS, levels, device_output=True, pad_to_bucket=1)


def test_labels_agree_with_the_default_folded_jax_inferer(tree, image):
    ours, _ = _pair(tree)
    folded = jax_core.TiledInferer(
        tree, JaxSegNetConfig(**CONFIG.to_dict()),
        JaxTilingParameters(**dataclasses.asdict(TILING)),
    )
    assert _agree(ours.infer_arrays(image)[0], folded.infer_arrays(image)[0]) >= 0.995


def test_forward_chunks_give_the_same_labels(tree, image, monkeypatch):
    inferer = core.TiledInferer(tree, CONFIG, TILING, device="cpu")
    plan = inferer.plan(*SHAPE[:2])
    assert inferer._chunk(plan, 18) == 18
    whole = inferer.infer_arrays(image, GAINS)[0]
    # a budget of 4 tiles' activations: 18 tiles run in chunks of 4, 4, 4, 4, 2
    monkeypatch.setattr(core, "FORWARD_BUDGET_BYTES", 4 * 16 * 4 * 64 * 64)
    assert inferer._chunk(plan, 18) == 4
    np.testing.assert_array_equal(whole, inferer.infer_arrays(image, GAINS)[0])


def test_detection_veto_matches_jax():
    rng = np.random.default_rng(2)
    labels = np.kron(rng.integers(0, 3, size=(12, 12)), np.ones((5, 5), np.int64))
    labels = labels.astype(np.int32)
    seeds = rng.random(labels.shape) < 0.01
    np.testing.assert_array_equal(
        core.detection_veto(labels, seeds), jax_core.detection_veto(labels, seeds)
    )
    np.testing.assert_array_equal(
        core.detection_veto(labels, None), labels.astype(np.uint16)
    )


@pytest.mark.parametrize("kwargs", [{"quantize": "int8"}, {"mesh": object()}])
def test_unported_options_raise(tree, kwargs):
    if "quantize" in kwargs:  # ported: int8 constructs, other modes are refused
        assert core.TiledInferer(tree, CONFIG, TILING, device="cpu", **kwargs).quantize == "int8"
        with pytest.raises(ValueError, match="unsupported quantize mode"):
            core.TiledInferer(tree, CONFIG, TILING, device="cpu", quantize="int4")
        return
    # ported: a mesh is a sequence of devices (tests/test_torch_parallel_infer.py);
    # anything else is refused
    with pytest.raises(ValueError, match="mesh must be a sequence of devices"):
        core.TiledInferer(tree, CONFIG, TILING, device="cpu", **kwargs)
    assert core.TiledInferer(tree, CONFIG, TILING, mesh=["cpu", "cpu"]).mesh == (
        torch.device("cpu"),) * 2
