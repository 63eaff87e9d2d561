"""Batched training augmentations on the device (the port of
``annonet_tpu/ops/augment.py``), with the random draws as an input.

torch cannot reproduce jax.random's streams, so the draws are a seam:
``draw_augmentations`` makes them from a torch.Generator on the device,
and ``augment_batch`` takes them as one ``AugmentDraws`` (a test feeds
JAX's own draws through it). The stages are the JAX package's, stage for
stage (the reference's randomly_crop_image and add_random_noise,
annonet_train_main.cpp:73-103,184-231):

  * flips of image and labels, left-right then upside-down
  * multiplicative brightness: with probability p, multiply by
    exp(N(0, sigma)), round half to even, clamp to [0, 255]
  * additive noise: per-crop level L = round(|N(0, sigma)|), per-pixel
    integer noise floor(u * 2L) - L, uniform over the half-open [-L, L)
    (dlib's get_integer_in_range), clamp
  * colour offset (RGB only): gamma max(0, 1 + 0.5 (u - 0.5)), per-channel
    scales 1 - 0.2 u divided by their max, round and clamp

Every stage keeps integer-valued float32 pixels, as the reference's uint8
intermediate stores do.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass
class AugmentDraws:
    """The random inputs of one ``augment_batch`` call, one row per crop;
    None where the stage is off (n crops of [H, W, C])."""

    flip_lr: Optional[torch.Tensor] = None  # [n] bool
    flip_ud: Optional[torch.Tensor] = None  # [n] bool
    bright_u: Optional[torch.Tensor] = None  # [n] uniform [0, 1): apply?
    bright_normal: Optional[torch.Tensor] = None  # [n] standard normal
    noise_normal: Optional[torch.Tensor] = None  # [n] standard normal: level
    noise_u: Optional[torch.Tensor] = None  # [n, H, W, C] uniform [0, 1)
    gamma_u: Optional[torch.Tensor] = None  # [n] uniform [0, 1)
    scales_u: Optional[torch.Tensor] = None  # [n, 3] uniform [0, 1)

    def to(self, device) -> "AugmentDraws":
        return AugmentDraws(**{
            f.name: None if getattr(self, f.name) is None else getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
        })


def draw_augmentations(
    generator: torch.Generator,
    n: int,
    shape: Tuple[int, int, int],  # (H, W, C) of one crop
    crop_options,  # data.crop.CropOptions
) -> AugmentDraws:
    """The draws of the stages that ``crop_options`` turns on, made on the
    generator's device, in a fixed order (flips, brightness, noise,
    colour)."""
    co = crop_options
    device = generator.device

    def uniform(*size):
        return torch.rand(size, generator=generator, device=device)

    def normal(*size):
        return torch.randn(size, generator=generator, device=device)

    d = AugmentDraws()
    if co.allow_flip_left_right:
        d.flip_lr = uniform(n) > 0.5
    if co.allow_flip_upside_down:
        d.flip_ud = uniform(n) > 0.5
    if co.multiplicative_brightness_change_probability > 0.0:
        d.bright_u, d.bright_normal = uniform(n), normal(n)
    if co.noise_level_stddev > 0.0:
        d.noise_normal, d.noise_u = normal(n), uniform(n, *shape)
    if co.allow_random_color_offset and shape[-1] == 3:
        d.gamma_u, d.scales_u = uniform(n), uniform(n, 3)
    return d


def _round_clamp(x):
    return torch.clamp(torch.round(x), 0.0, 255.0)


def _flip(x, labels, flip, dim):
    sel = flip[:, None, None]
    x = torch.where(sel[..., None], x.flip(dim), x)
    return x, torch.where(sel, labels.flip(dim), labels)


def augment_batch(
    draws: AugmentDraws,
    images: torch.Tensor,  # [N,H,W,C] uint8 or float
    labels: torch.Tensor,  # [N,H,W] integer
    *,
    allow_flip_left_right: bool = False,
    allow_flip_upside_down: bool = False,
    multiplicative_brightness_change_probability: float = 0.0,
    multiplicative_brightness_change_sigma: float = 0.1,
    noise_level_stddev: float = 0.0,
    allow_random_color_offset: bool = False,
    flips_pre_applied: bool = False,
):
    """Augment a minibatch: (images float32 0..255, labels).
    ``flips_pre_applied`` marks crops that the pool gather already
    mirrored (with ``draws.flip_lr`` / ``flip_ud``): the flip stages are
    skipped and nothing else changes."""
    x = images.to(torch.float32)

    if allow_flip_left_right and not flips_pre_applied:
        x, labels = _flip(x, labels, draws.flip_lr, 2)
    if allow_flip_upside_down and not flips_pre_applied:
        x, labels = _flip(x, labels, draws.flip_ud, 1)

    if multiplicative_brightness_change_probability > 0.0:
        apply = draws.bright_u < multiplicative_brightness_change_probability
        factor = torch.exp(draws.bright_normal * multiplicative_brightness_change_sigma)
        factor = torch.where(apply, factor, 1.0)
        x = _round_clamp(x * factor[:, None, None, None])

    if noise_level_stddev > 0.0:
        level = torch.round(torch.abs(draws.noise_normal * noise_level_stddev))
        span = (2.0 * level)[:, None, None, None]
        noise = torch.floor(draws.noise_u * span) - level[:, None, None, None]
        x = torch.clamp(x + noise, 0.0, 255.0)

    if allow_random_color_offset and x.shape[-1] == 3:
        gamma = torch.clamp(1.0 + 0.5 * (draws.gamma_u - 0.5), min=0.0)
        scales = 1.0 - 0.2 * draws.scales_u
        scales = scales / scales.max(dim=-1, keepdim=True).values
        v = torch.pow(torch.clamp(x, min=0.0) / 255.0, gamma[:, None, None, None])
        x = _round_clamp(255.0 * v * scales[:, None, None, :])

    return x, labels
