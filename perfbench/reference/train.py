"""The plain reference of annonet's training step, in float32 PyTorch.

One step, as reunanen/annonet's annonet_train describes it
(annonet_train_main.cpp, annonet_train.h), on crop decisions and random
draws that the benchmark made:

  * crops cut from the pool images at the decided rectangles, pixels
    outside the image replicating its nearest edge pixel, labels outside it
    ignored (65535);
  * left-right and upside-down flips of image and labels;
  * brightness: with probability p, times exp(N * sigma), rounded half to
    even, clamped to [0, 255];
  * noise: a crop's level L = round(|N * sigma|), per pixel floor(u * 2L) -
    L added, clamped;
  * colour offset: gamma max(0, 1 + 0.5 (u - 0.5)), channel scales 1 - 0.2 u
    over their largest, 255 * (x / 255) ** gamma * scale rounded and clamped;
  * loss weights per crop: class c of n_c valid pixels weighs
    n_c ** -class_weight, scaled so that the crop's total is n * (H W / n) **
    image_weight over its n valid pixels; ignored pixels weigh 0;
  * the loss: the weighted softmax cross-entropy summed over every pixel
    and divided by N H W;
  * SGD with momentum and weight decay on the 4-D kernels:
    v = mu v - lr (g + wd p), p = p + v.

Everything is float32 with TF32 off; the gradient is autograd's.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench.reference.segnet import exact, train_forward

IGNORE = 65535


def crops(pool_images: torch.Tensor, pool_labels: torch.Tensor, slots: np.ndarray,
          rects: np.ndarray, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, dim, dim, C] float32 pixels and [B, dim, dim] int64 labels."""
    _s, h, w = pool_labels.shape
    device = pool_images.device
    top = torch.as_tensor(rects[:, 1], device=device)[:, None] + torch.arange(dim, device=device)
    left = torch.as_tensor(rects[:, 0], device=device)[:, None] + torch.arange(dim, device=device)
    rows, cols = top.clamp(0, h - 1), left.clamp(0, w - 1)
    s = torch.as_tensor(slots, device=device)[:, None, None]
    images = pool_images[s, rows[:, :, None], cols[:, None, :]].to(torch.float32)
    labels = pool_labels[s, rows[:, :, None], cols[:, None, :]].to(torch.int64)
    outside = ~(((top >= 0) & (top < h))[:, :, None] & ((left >= 0) & (left < w))[:, None, :])
    return images, labels.masked_fill(outside, IGNORE)


def augment(x: torch.Tensor, labels: torch.Tensor, d: Dict[str, torch.Tensor],
            aug: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    if aug["flip_left_right"]:
        f = d["flip_lr"]
        x = torch.where(f[:, None, None, None], x.flip(2), x)
        labels = torch.where(f[:, None, None], labels.flip(2), labels)
    if aug["flip_upside_down"]:
        f = d["flip_ud"]
        x = torch.where(f[:, None, None, None], x.flip(1), x)
        labels = torch.where(f[:, None, None], labels.flip(1), labels)
    if aug["brightness_probability"] > 0:
        factor = torch.exp(d["bright_normal"] * aug["brightness_sigma"])
        factor = torch.where(d["bright_u"] < aug["brightness_probability"], factor, 1.0)
        x = torch.round(x * factor[:, None, None, None]).clamp(0, 255)
    if aug["noise_sigma"] > 0:
        level = torch.round((d["noise_normal"] * aug["noise_sigma"]).abs())[:, None, None, None]
        x = (x + torch.floor(d["noise_u"] * 2 * level) - level).clamp(0, 255)
    if aug["color_offset"] and x.shape[-1] == 3:
        gamma = (1 + 0.5 * (d["gamma_u"] - 0.5)).clamp(min=0)[:, None, None, None]
        scales = 1 - 0.2 * d["scales_u"]
        scales = (scales / scales.max(dim=1, keepdim=True).values)[:, None, None, :]
        x = torch.round(255 * (x / 255) ** gamma * scales).clamp(0, 255)
    return x, labels


def loss_weights(labels: torch.Tensor, k: int, class_weight: float,
                 image_weight: float) -> torch.Tensor:
    n, h, w = labels.shape
    valid = labels < k
    out = torch.zeros(labels.shape, dtype=torch.float32, device=labels.device)
    for i in range(n):
        counts = torch.bincount(labels[i][valid[i]], minlength=k).to(torch.float64)
        total = counts.sum()
        if total == 0:
            continue
        per_class = torch.where(counts > 0, counts.clamp(min=1) ** -class_weight, 0.0)
        scale = total * (h * w / total) ** image_weight / (counts * per_class).sum()
        out[i] = torch.where(valid[i], (per_class * scale)[labels[i].clamp(max=k - 1)], 0.0).float()
    return out


def loss(logits: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    k = logits.shape[-1]
    valid = labels < k
    logp = torch.log_softmax(logits, dim=-1)
    ce = -logp.gather(-1, labels.clamp(max=k - 1)[..., None])[..., 0]
    return (torch.where(valid, ce, 0.0) * weights).sum() / labels.numel()


def steps(params0: Dict[str, np.ndarray], config: Dict, hp: Dict, pool_images: np.ndarray,
          pool_labels: np.ndarray, decisions: List[Tuple[np.ndarray, np.ndarray]],
          draws: List[Dict[str, np.ndarray]], device, quant=None) -> Dict:
    """Run ``len(decisions)`` steps from ``params0`` with zero velocity:
    {"losses", "velocity1" (after the first step), "params3" (after the
    last), "stats1" (the first step's batch statistics, "block/bnX/mean"
    and "/var")}, the trees as numpy float32 keyed by name. ``quant``: the
    rounding of every tensor the program keeps in bfloat16 (``segnet.fp8``:
    the control)."""
    images = torch.as_tensor(pool_images, device=device)
    labels = torch.as_tensor(pool_labels.astype(np.int64), device=device)
    p = {k: torch.tensor(v, dtype=torch.float32, device=device, requires_grad=True)
         for k, v in params0.items()}
    v = {k: torch.zeros_like(t) for k, t in p.items()}
    out: Dict = {"losses": []}
    with exact():
        for (slots, rects), d in zip(decisions, draws):
            dd = {k: torch.as_tensor(a, device=device) for k, a in d.items()}
            x, lab = crops(images, labels, slots, rects, hp["crop"])
            x, lab = augment(x, lab, dd, hp["augmentation"])
            wts = loss_weights(lab, config["class_count"], hp["class_weight"],
                               hp["image_weight"])
            stats: Dict = {}
            value = loss(train_forward(p, config, x, quant, stats), lab, wts)
            grads = torch.autograd.grad(value, list(p.values()))
            with torch.no_grad():
                for (name, t), g in zip(p.items(), grads):
                    decay = hp["weight_decay"] * t if t.dim() == 4 else 0.0
                    v[name].mul_(hp["momentum"]).sub_(hp["learning_rate"] * (g + decay))
                    t.add_(v[name])
            out["losses"].append(float(value.detach()))
            if "velocity1" not in out:
                out["velocity1"] = {k: t.cpu().numpy().copy() for k, t in v.items()}
                out["stats1"] = {k: t.cpu().numpy() for k, t in stats.items()}
    out["params3"] = {k: t.detach().cpu().numpy() for k, t in p.items()}
    return out
