"""The training ops of the port (annonet_tpu_torch/ops: loss, weighting,
augment, crop_gather) against the JAX package's, on the CPU.

Tolerances: the loss and the batched weights within 1e-6 relative (f32,
the same operations); ``set_weights`` is the JAX package's numpy code, so
equal. ``augment_batch`` is fed JAX's own draws (split from the same key,
as augment_batch splits it): equal, except for at most one intensity
level where a pixel sits at a .5 rounding edge after exp or pow (the two
libraries' f32 exp and pow may differ in the last bit). The crop gather is
bit-identical to JAX's and to ``data/crop.py::extract_crop``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from annonet_tpu.ops import augment as jax_augment
from annonet_tpu.ops import crop_gather as jax_gather
from annonet_tpu.ops import loss as jax_loss
from annonet_tpu.ops import weighting as jax_weighting
from annonet_tpu_torch.classes import IGNORE_LABEL
from annonet_tpu_torch.data.crop import CropOptions, extract_crop
from annonet_tpu_torch.ops.augment import AugmentDraws, augment_batch, draw_augmentations
from annonet_tpu_torch.ops.crop_gather import gather_crops, gather_crops_packed
from annonet_tpu_torch.ops.loss import weighted_pixel_cross_entropy
from annonet_tpu_torch.ops.weighting import batched_label_weights, set_weights


def _labels(rng, n, h, w, k, ignore=0.2, absent=None):
    labels = rng.integers(0, k, (n, h, w)).astype(np.int32)
    if absent is not None:
        labels[labels == absent] = 0
    labels[rng.random((n, h, w)) < ignore] = IGNORE_LABEL
    return labels


@pytest.mark.parametrize("k", [2, 3, 7])
def test_loss_matches_jax(k):
    rng = np.random.default_rng(k)
    logits = (rng.standard_normal((3, 9, 11, k)) * 3).astype(np.float32)
    labels = _labels(rng, 3, 9, 11, k)
    labels[0, 0, :4] = IGNORE_LABEL
    weights = rng.uniform(0.0, 3.0, (3, 9, 11)).astype(np.float32)
    want = float(jax_loss.weighted_pixel_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(weights)))
    got = weighted_pixel_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                       torch.from_numpy(weights)).item()
    assert abs(got - want) <= 1e-6 * abs(want)
    # ignored pixels count nothing, whatever their weight
    weights_ignored = np.where(labels == IGNORE_LABEL, 1e6, weights).astype(np.float32)
    again = weighted_pixel_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                         torch.from_numpy(weights_ignored)).item()
    assert abs(again - got) <= 1e-6 * abs(got)


@pytest.mark.parametrize("class_weight,image_weight", [(0.0, 0.0), (0.5, 0.5), (1.0, 1.0),
                                                       (0.3, 0.8)])
def test_batched_label_weights_match_jax(class_weight, image_weight):
    rng = np.random.default_rng(int(class_weight * 10 + image_weight * 100))
    k = 4
    labels = _labels(rng, 4, 12, 10, k, absent=2)
    labels[1] = IGNORE_LABEL  # a crop with no valid pixel
    labels[2] = 3  # one class only
    want = np.asarray(jax_weighting.batched_label_weights(
        jnp.asarray(labels), class_weight, image_weight, k))
    got = batched_label_weights(torch.from_numpy(labels), class_weight, image_weight, k)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    # and the per-crop numpy version (a copy of the JAX package's)
    for i in range(labels.shape[0]):
        crop = labels[i].astype(np.uint16)
        np.testing.assert_array_equal(
            set_weights(crop, class_weight, image_weight),
            jax_weighting.set_weights(crop, class_weight, image_weight))
        np.testing.assert_allclose(got[i].numpy(), set_weights(crop, class_weight,
                                                                image_weight), rtol=1e-5)


def _jax_draws(key, n, shape):
    """The draws augment_batch makes from ``key`` (its 8-way split)."""
    ks = jax.random.split(key, 8)

    def u(k, s):
        return torch.tensor(np.asarray(jax.random.uniform(k, s, jnp.float32)))

    def g(k, s):
        return torch.tensor(np.asarray(jax.random.normal(k, s)))

    return AugmentDraws(
        flip_lr=u(ks[0], (n,)) > 0.5, flip_ud=u(ks[1], (n,)) > 0.5,
        bright_u=u(ks[2], (n,)), bright_normal=g(ks[3], (n,)),
        noise_normal=g(ks[4], (n,)), noise_u=u(ks[5], (n,) + tuple(shape)),
        gamma_u=u(ks[6], (n,)), scales_u=u(ks[7], (n, 3)),
    )


_STAGES = {
    "flips": dict(allow_flip_left_right=True, allow_flip_upside_down=True),
    "brightness": dict(multiplicative_brightness_change_probability=0.7,
                       multiplicative_brightness_change_sigma=0.3),
    "noise": dict(noise_level_stddev=3.0),
    "colour": dict(allow_random_color_offset=True),
    "all": dict(allow_flip_left_right=True, allow_flip_upside_down=True,
                multiplicative_brightness_change_probability=0.5,
                noise_level_stddev=2.0, allow_random_color_offset=True),
}


@pytest.mark.parametrize("stage", sorted(_STAGES))
@pytest.mark.parametrize("channels", [3, 1])
def test_augment_batch_with_jax_draws(stage, channels):
    flags = _STAGES[stage]
    rng = np.random.default_rng(len(stage) + channels)
    n, h, w = 16, 24, 20
    images = rng.integers(0, 256, (n, h, w, channels), dtype=np.uint8)
    labels = _labels(rng, n, h, w, 3)
    key = jax.random.PRNGKey(len(stage))
    want_x, want_l = jax_augment.augment_batch(key, jnp.asarray(images), jnp.asarray(labels),
                                               **flags)
    got_x, got_l = augment_batch(_jax_draws(key, n, (h, w, channels)),
                                 torch.from_numpy(images), torch.from_numpy(labels), **flags)
    want_x = np.asarray(want_x)
    assert got_x.dtype == torch.float32
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    diff = np.abs(got_x.numpy() - want_x)
    assert diff.max() <= 1.0
    if stage in ("flips", "noise"):  # no exp or pow: exact
        assert diff.max() == 0.0
    else:  # only pixels at a rounding edge may land one level apart
        assert (diff > 0).mean() < 1e-3, (diff > 0).sum()


def test_flips_pre_applied_skips_only_the_flips():
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (8, 16, 16, 3), dtype=np.uint8)
    labels = _labels(rng, 8, 16, 16, 3)
    flags = _STAGES["all"]
    draws = _jax_draws(jax.random.PRNGKey(9), 8, (16, 16, 3))
    x = torch.from_numpy(images)
    lab = torch.from_numpy(labels)
    sel = draws.flip_lr[:, None, None, None]
    x = torch.where(sel, x.flip(2), x)
    lab = torch.where(sel[..., 0], lab.flip(2), lab)
    sel = draws.flip_ud[:, None, None, None]
    x = torch.where(sel, x.flip(1), x)
    lab = torch.where(sel[..., 0], lab.flip(1), lab)
    pre = augment_batch(draws, x, lab, flips_pre_applied=True, **flags)
    full = augment_batch(draws, torch.from_numpy(images), torch.from_numpy(labels), **flags)
    assert torch.equal(pre[0], full[0]) and torch.equal(pre[1], full[1])


def test_draw_augmentations_follow_the_options():
    options = CropOptions(dim=16, **_STAGES["all"])
    draws = []
    for _ in range(2):
        gen = torch.Generator()
        gen.manual_seed(5)
        draws.append(draw_augmentations(gen, 4, (16, 16, 3), options))
    a, b = draws
    assert a.flip_lr.dtype == torch.bool and a.noise_u.shape == (4, 16, 16, 3)
    assert a.scales_u.shape == (4, 3) and a.gamma_u.shape == (4,)
    assert all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("flip_lr", "bright_normal", "noise_u", "scales_u"))
    assert 0.0 <= a.noise_u.min() and a.noise_u.max() < 1.0
    none = draw_augmentations(torch.Generator(), 4, (16, 16, 1),
                              CropOptions(dim=16, allow_random_color_offset=True))
    assert none.flip_lr is None and none.noise_u is None and none.gamma_u is None


def _pool(rng, sizes, channels=3, pad=96):
    s = len(sizes)
    images = np.zeros((s, pad, pad, channels), np.uint8)
    labels = np.zeros((s, pad, pad), np.uint16)
    for i, (h, w) in enumerate(sizes):
        images[i, :h, :w] = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
        lab = rng.integers(0, 5, (h, w)).astype(np.uint16)
        lab[rng.random((h, w)) < 0.1] = IGNORE_LABEL
        labels[i, :h, :w] = lab
    return images, labels


@pytest.mark.parametrize("flips", [False, True])
def test_gather_crops_bit_identical_to_jax_and_extract_crop(flips):
    rng = np.random.default_rng(int(flips))
    sizes = [(60, 80), (40, 30), (96, 96)]
    images, labels = _pool(rng, sizes)
    dim = 32
    # interior, past every edge and corner, smaller images than the crop
    rects = [(0, 5, 7), (0, -10, -20), (0, 50, 70), (1, -5, 10), (1, 20, -3),
             (2, 64, 64), (2, 80, -15), (1, 35, 25)]
    slot = np.array([r[0] for r in rects], np.int32)
    y0 = np.array([r[1] for r in rects], np.int32)
    x0 = np.array([r[2] for r in rects], np.int32)
    vh = np.array([sizes[s][0] for s in slot], np.int32)
    vw = np.array([sizes[s][1] for s in slot], np.int32)
    flip_lr = rng.random(len(rects)) < 0.5 if flips else None
    flip_ud = rng.random(len(rects)) < 0.5 if flips else None
    want_i, want_l = jax_gather.gather_crops(
        jnp.asarray(images), jnp.asarray(labels), *(jnp.asarray(a) for a in (slot, y0, x0, vh, vw)),
        dim, flip_lr=None if flip_lr is None else jnp.asarray(flip_lr),
        flip_ud=None if flip_ud is None else jnp.asarray(flip_ud))
    pool_labels = torch.from_numpy(labels).to(torch.int32)
    got_i, got_l = gather_crops(
        torch.from_numpy(images), pool_labels, *(torch.from_numpy(a) for a in (slot, y0, x0, vh, vw)),
        dim, flip_lr=None if flip_lr is None else torch.from_numpy(flip_lr),
        flip_ud=None if flip_ud is None else torch.from_numpy(flip_ud))
    assert got_i.dtype == torch.uint8 and got_l.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    packed = torch.from_numpy(np.stack([slot, y0, x0, vh, vw]))
    again = gather_crops_packed(torch.from_numpy(images), pool_labels, packed, dim,
                                flip_lr=None if flip_lr is None else torch.from_numpy(flip_lr),
                                flip_ud=None if flip_ud is None else torch.from_numpy(flip_ud))
    assert torch.equal(again[0], got_i) and torch.equal(again[1], got_l)
    for i, (s, y, x) in enumerate(rects):
        h, w = sizes[s]
        img, lab = extract_crop(images[s, :h, :w], labels[s, :h, :w],
                                (x, y, x + dim - 1, y + dim - 1))
        if flips and flip_lr[i]:
            img, lab = img[:, ::-1], lab[:, ::-1]
        if flips and flip_ud[i]:
            img, lab = img[::-1], lab[::-1]
        np.testing.assert_array_equal(got_i[i].numpy(), img)
        np.testing.assert_array_equal(got_l[i].numpy(), lab.astype(np.int32))
