"""The training driver: ``Trainer.train_step_decisions`` on a device image
pool, back to back.

Mix keys: ``pool_images`` and ``image_side`` (the pool's synthetic scenes
with labels), ``batch``, ``crop``, ``augmentation`` (the CLI's flags),
``class_weight``, ``image_weight``, ``learning_rate``, ``momentum``,
``weight_decay``, ``relative_training_length`` and ``loss_sync_interval``
(the CLI's defaults), ``planned_steps`` (crop decisions drawn ahead),
``warmup_steps``, ``trace_seconds``.

One object, the trainer with its state, is built from the seed, driven
through its first steps by the window's own call and feed (steps 1-3 are
the ones the reference follows), then handed to the window. The crop
rectangles (a class present in the image, a pixel of that class, a crop
holding it, as annonet_train draws them) and the augmentation draws are the
benchmark's, from the seed, so the reference gets the same ones. The
window ends at a readback of every pending loss, so the steps it counts
have finished.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from perfbench.lib import scenes, weights
from perfbench.lib.parts import mark
from perfbench.reference import compare
from perfbench.reference import train as reference

CHECKED_STEPS = 3
_MODEL_KEYS = ("class_count", "level_count", "width_scaler", "min_filter_count",
               "grayscale", "base_width", "compute_dtype")


def _flat(tree: Dict, prefix: str = "") -> Dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _numpy(tree: Dict) -> Dict[str, np.ndarray]:
    """A copy of a tree of tensors on the host, keyed by slash-joined names."""
    return {k: t.detach().cpu().numpy().copy() for k, t in _flat(tree).items()}


class Cell:
    def __init__(self, config: Dict, mix: Dict, seed: int, device, half_batch: bool = False):
        from annonet_tpu_torch.data.crop import CropOptions
        from annonet_tpu_torch.data.sample import Sample
        from annonet_tpu_torch.models.segnet import SegNetConfig
        from annonet_tpu_torch.train.device_cache import DeviceImagePool
        from annonet_tpu_torch.train.trainer import Trainer, TrainerConfig

        self.config, self.mix, self.device = config, mix, device
        self.half_batch = half_batch
        self.setup_parts = {}
        t = time.perf_counter()
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        self.params0 = weights.train_tree(gen, config)
        t = mark(self.setup_parts, "weights", t)
        channels = 1 if config["grayscale"] else 3
        side = mix["image_side"]
        self.pool_images, self.pool_labels = scenes.make_scenes(
            gen, mix["pool_images"], side, side, channels, mix["defect_share"])
        t = mark(self.setup_parts, "inputs", t)
        self.draw_gen = gen
        aug = mix["augmentation"]
        self.options = CropOptions(
            dim=mix["crop"], class_weight=mix["class_weight"], image_weight=mix["image_weight"],
            allow_flip_left_right=aug["flip_left_right"],
            allow_flip_upside_down=aug["flip_upside_down"],
            multiplicative_brightness_change_probability=aug["brightness_probability"],
            multiplicative_brightness_change_sigma=aug["brightness_sigma"],
            noise_level_stddev=aug["noise_sigma"],
            allow_random_color_offset=aug["color_offset"])
        self._decide(np.random.default_rng([seed, 0x7A1]))
        t = mark(self.setup_parts, "crop_decisions", t)
        self.samples = [Sample(input_image=img, label_image=lab)
                        for img, lab in zip(self.pool_images, self.pool_labels)]
        length = mix["relative_training_length"]
        self.trainer = Trainer(
            SegNetConfig(**{key: config[key] for key in _MODEL_KEYS}),
            TrainerConfig(
                initial_learning_rate=mix["learning_rate"], momentum=mix["momentum"],
                weight_decay=mix["weight_decay"],
                iterations_without_progress_threshold=int(round(length * 2000)),
                previous_loss_values_dump_amount=int(round(length * 400)),
                bn_stats_window=int(round(length * 100)),
                loss_sync_interval=mix["loss_sync_interval"]),
            seed=seed, device=device)
        with torch.no_grad():
            for name, leaf in _flat(self.trainer.params).items():
                leaf.copy_(torch.from_numpy(self.params0[name]))
        self.pool = DeviceImagePool(slots=mix["pool_images"], device=device)
        t = mark(self.setup_parts, "trainer", t)
        self.steps = 0
        self._reference: Optional[Dict] = None
        # steps 1-3 through the window's own call, with what the reference needs
        self.checked_draws: List[Dict[str, np.ndarray]] = []
        self.program: Dict = {}
        for _ in range(CHECKED_STEPS):
            draws = self._step()
            self.checked_draws.append({k: v.cpu().numpy() for k, v in draws.items()})
            if self.steps == 1:
                # the first update's running statistics are its batch's
                self.program["velocity1"] = _numpy(self.trainer.velocity)
                self.program["stats1"] = _numpy(self.trainer.bn_stats)
        self.program["params3"] = _numpy(self.trainer.params)
        self.trainer.flush_losses()
        self.program["losses"] = list(self.trainer.previous_loss_values[:CHECKED_STEPS])
        t = mark(self.setup_parts, "checked_steps_and_pool_upload", t)
        for _ in range(mix["warmup_steps"]):
            self._step()
        self.trainer.flush_losses()
        mark(self.setup_parts, "warmup_steps", t)

    def _decide(self, rng: np.random.Generator) -> None:
        """Crop decisions for ``planned_steps`` steps: per crop an image, a
        class present in it, one of its pixels, a crop holding that pixel."""
        n, b, dim = self.mix["planned_steps"], self.mix["batch"], self.mix["crop"]
        count = n * b
        slots = rng.integers(0, len(self.pool_labels), count)
        u_class, u_point = rng.random(count), rng.random(count)
        flat = np.empty(count, np.int64)
        for s, lab in enumerate(self.pool_labels):
            present = np.unique(lab)
            cls = (u_class * len(present)).astype(np.int64)
            for j, c in enumerate(present):
                pts = np.flatnonzero(lab.ravel() == c)
                mine = (slots == s) & (cls == j)
                flat[mine] = pts[(u_point[mine] * len(pts)).astype(np.int64)]
        py, px = np.divmod(flat, self.pool_labels.shape[2])
        left = px - rng.integers(0, dim, count)
        top = py - rng.integers(0, dim, count)
        self.slots = slots.reshape(n, b)
        self.rects = np.stack([left, top, left + dim - 1, top + dim - 1], 1).reshape(n, b, 4)

    def _draws(self, n: int) -> Dict[str, torch.Tensor]:
        gen, dev, aug, dim = self.draw_gen, self.device, self.mix["augmentation"], self.mix["crop"]
        channels = 1 if self.config["grayscale"] else 3

        def u(*size):
            return torch.rand(size, generator=gen, device=dev)

        def z(*size):
            return torch.randn(size, generator=gen, device=dev)

        d = {}
        if aug["flip_left_right"]:
            d["flip_lr"] = u(n) > 0.5
        if aug["flip_upside_down"]:
            d["flip_ud"] = u(n) > 0.5
        if aug["brightness_probability"] > 0:
            d["bright_u"], d["bright_normal"] = u(n), z(n)
        if aug["noise_sigma"] > 0:
            d["noise_normal"], d["noise_u"] = z(n), u(n, dim, dim, channels)
        if aug["color_offset"] and channels == 3:
            d["gamma_u"], d["scales_u"] = u(n), u(n, 3)
        return d

    def _step(self) -> Dict[str, torch.Tensor]:
        from annonet_tpu_torch.ops.augment import AugmentDraws

        i = self.steps % self.mix["planned_steps"]
        b = self.mix["batch"] // 2 if self.half_batch else self.mix["batch"]
        draws = self._draws(self.mix["batch"])
        used = {k: v[:b] for k, v in draws.items()}
        samples = [self.samples[s] for s in self.slots[i][:b]]
        rects = [tuple(int(v) for v in r) for r in self.rects[i][:b]]
        with record_function("perfbench.train_step"):
            self.trainer.train_step_decisions(self.pool, samples, rects, self.options,
                                              draws=AugmentDraws(**used))
        self.steps += 1
        return draws

    def window(self, seconds: float) -> Dict:
        t0 = time.perf_counter()
        first = self.steps
        while time.perf_counter() - t0 < seconds:
            self._step()
        with record_function("perfbench.loss_readback"):
            self.trainer.flush_losses()
        steps = self.steps - first
        return {"seconds": time.perf_counter() - t0, "calls": steps,
                "crops": steps * self.mix["batch"]}

    def release(self) -> None:
        self.trainer = self.pool = self.samples = None
        torch.cuda.empty_cache()

    def hyper(self) -> Dict:
        """The step's settings the reference needs, from the mix."""
        return {k: self.mix[k] for k in ("crop", "augmentation", "class_weight", "image_weight",
                                         "learning_rate", "momentum", "weight_decay")}

    def reference_steps(self, quant=None) -> Dict:
        """The reference's checked steps from the same state, crops and
        draws, in ``self.program``'s layout (``reference.steps``)."""
        decisions = [(self.slots[i], self.rects[i]) for i in range(CHECKED_STEPS)]
        return reference.steps(self.params0, self.config, self.hyper(), self.pool_images,
                               self.pool_labels, decisions, self.checked_draws, self.device,
                               quant)

    def _sides(self):
        """(program, reference, params0, hp) for ``compare``; the float32
        reference runs once."""
        if self._reference is None:
            self._reference = self.reference_steps()
        return self.program, self._reference, self.params0, self.hyper()

    def numbers(self) -> Dict[str, float]:
        """The checked steps' numbers against the float32 reference."""
        return compare.train_numbers(*self._sides())

    def leaves(self) -> Dict[str, Dict[str, float]]:
        """The same, leaf by leaf."""
        return compare.leaf_readings(*self._sides())

    def bn_layers(self) -> Dict[str, float]:
        """The first step's batch statistics, layer by layer."""
        return compare.bn_readings(*self._sides()[:2])

    def end_to_end(self, w: Dict) -> Dict[str, float]:
        return {"train_crops_per_s": w["crops"] / w["seconds"]}
