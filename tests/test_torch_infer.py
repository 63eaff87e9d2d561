"""The port's tiled inference (annonet_tpu_torch/infer/core.py) against the
JAX package's ``TiledInferer``.

Against the JAX inferer with the unfolded net (``use_folded_net=False``):
the plans are equal, and on a float32 config with a multi-tile plan the
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

from annonet_tpu.infer import core as jax_core
from annonet_tpu.infer.tiling import TilingParameters as JaxTilingParameters
from annonet_tpu.models.segnet import SegNetConfig as JaxSegNetConfig
from annonet_tpu_torch.infer import core
from annonet_tpu_torch.infer.tiling import TilingParameters, default_tile_max
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
    ours, theirs = _pair(tree)
    assert dataclasses.astuple(ours.plan(*shape)) == dataclasses.astuple(theirs.plan(*shape))


def test_flagship_plan_at_4096():
    """The default tile max is the reference's CUDA 1024: a 4096x4096
    image plans to 25 tiles of 896x896 with overlap 62."""
    flagship = SegNetConfig(class_count=3, level_count=3, base_width=16)
    inferer = core.TiledInferer(
        init_runtime_params(flagship, 0), flagship, device="cpu"
    )
    plan = inferer.plan(4096, 4096)
    assert default_tile_max() == 1024
    assert (plan.tile_count, plan.tile_height, plan.tile_width, plan.overlap_y) == (
        25, 896, 896, 62
    )


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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        core.TiledInferer(tree, CONFIG, TILING, device="cpu", **kwargs)
