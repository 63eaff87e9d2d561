"""The U-Net's training driver: ``drivers/train.py``'s cell (the mix's keys
are its), with the configuration's ``topology`` ("unet") in the program's
architecture config, the U-Net's weights from the seed
(``perfbench/lib/unet.py``) and its plain reference
(``perfbench/reference/unet.py``) deciding ``correct``.

``Cell.__init__`` is ``drivers/train.py``'s with two changes: the
program's architecture config is made first, so that a program without the
topology refuses the configuration before any weight or scene is made (the
run exits non-zero), and the weights are the U-Net's. The window, the steps
and the comparison are ``drivers/train.py``'s.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench.drivers import train
from perfbench.lib import scenes, unet
from perfbench.lib.parts import mark
from perfbench.reference import unet as reference


class Cell(train.Cell):
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
        model_config = SegNetConfig(**{key: config[key] for key in train._MODEL_KEYS},
                                    topology=config["topology"])
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        self.params0 = unet.train_tree(gen, config)
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
            model_config,
            TrainerConfig(
                initial_learning_rate=mix["learning_rate"], momentum=mix["momentum"],
                weight_decay=mix["weight_decay"],
                iterations_without_progress_threshold=int(round(length * 2000)),
                previous_loss_values_dump_amount=int(round(length * 400)),
                bn_stats_window=int(round(length * 100)),
                loss_sync_interval=mix["loss_sync_interval"]),
            seed=seed, device=device)
        with torch.no_grad():
            for name, leaf in train._flat(self.trainer.params).items():
                leaf.copy_(torch.from_numpy(self.params0[name]))
        self.pool = DeviceImagePool(slots=mix["pool_images"], device=device)
        t = mark(self.setup_parts, "trainer", t)
        self.steps = 0
        self._reference: Optional[Dict] = None
        # steps 1-3 through the window's own call, with what the reference needs
        self.checked_draws: List[Dict[str, np.ndarray]] = []
        self.program: Dict = {}
        for _ in range(train.CHECKED_STEPS):
            draws = self._step()
            self.checked_draws.append({k: v.cpu().numpy() for k, v in draws.items()})
            if self.steps == 1:
                # the first update's running statistics are its batch's
                self.program["velocity1"] = train._numpy(self.trainer.velocity)
                self.program["stats1"] = train._numpy(self.trainer.bn_stats)
        self.program["params3"] = train._numpy(self.trainer.params)
        self.trainer.flush_losses()
        self.program["losses"] = list(self.trainer.previous_loss_values[:train.CHECKED_STEPS])
        t = mark(self.setup_parts, "checked_steps_and_pool_upload", t)
        for _ in range(mix["warmup_steps"]):
            self._step()
        self.trainer.flush_losses()
        mark(self.setup_parts, "warmup_steps", t)

    def reference_steps(self, quant=None) -> Dict:
        decisions = [(self.slots[i], self.rects[i]) for i in range(train.CHECKED_STEPS)]
        return reference.steps(self.params0, self.config, self.hyper(), self.pool_images,
                               self.pool_labels, decisions, self.checked_draws, self.device,
                               quant)
