"""The trainer: SGD with momentum and plateau-driven learning-rate
decay, on one device (the port of ``annonet_tpu/train/trainer.py``).

The dlib dnn_trainer semantics behind the reference's NetPimpl::TrainingNet
(annonet_train_main.cpp:396-410,569-577,609), as the JAX package has them:

  * momentum SGD with weight decay on the conv kernels only:
    v = mu v - lr (g + wd p), p = p + v (not torch.optim.SGD, whose
    v = mu v + g, p -= lr v is another function and another velocity)
  * a window of recent losses; when both the plain and the robust
    steps-without-decrease counts exceed the threshold, the learning rate
    shrinks and the window clears; training stops below the minimum rate
  * a synchronization file with the whole state, written at most every
    ``sync_interval_seconds`` and resumed on construction: the JAX
    package's npz file, so either package resumes the other's
  * the BN running statistics' window as dlib's schedule
    (``bn_momentum_for_step``)

One step: [crop gather from the device image pool] -> augmentation (draws
from a torch.Generator seeded with seed ^ 0x5EED, or given) -> loss
weights -> forward with batch-stat BN -> weighted loss -> backward ->
SGD, all on the device; losses stay there and are read back every
``loss_sync_interval`` steps. The convs run through autograd (cuDNN on the
card); the inference kernels have no backward, and the JAX package's
training uses none of its Pallas kernels either. Each unit's batch norm and
ReLU, which XLA fuses in the JAX package, is one hand-written op on the
card, forward and backward (``ops/bn_relu.py``).
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from annonet_tpu_torch import serialization
from annonet_tpu_torch.models.segnet import (
    Params,
    SegNetConfig,
    apply_train,
    fold_batchnorm,
    init_state,
    require_segnet,
    train_state_from_numpy,
    tree_items,
    tree_to_numpy,
)
from annonet_tpu_torch.ops.augment import AugmentDraws, augment_batch, draw_augmentations
from annonet_tpu_torch.ops.crop_gather import gather_crops_packed
from annonet_tpu_torch.ops.int8_train import int8_convs
from annonet_tpu_torch.ops.loss import weighted_pixel_cross_entropy
from annonet_tpu_torch.ops.weighting import batched_label_weights
from annonet_tpu_torch.train.plateau import (
    count_steps_without_decrease,
    count_steps_without_decrease_robust,
)
from annonet_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class TrainerConfig:
    """Knobs mirroring the NetPimpl::TrainingNet setters."""

    initial_learning_rate: float = 0.1  # SetLearningRate
    learning_rate_shrink_factor: float = 0.1  # SetLearningRateShrinkFactor
    min_learning_rate: float = 1e-6
    iterations_without_progress_threshold: int = 4000  # rel_training_len*2000
    previous_loss_values_dump_amount: int = 800  # rel_training_len*400
    bn_stats_window: int = 200  # rel_training_len*100
    momentum: float = 0.9
    weight_decay: float = 0.0005
    remat: bool = False  # recompute each conv unit in the backward pass
    # the 3x3 convs' forward in int8 (straight-through; ops/int8_train.py)
    int8_forward: bool = False
    # device losses are read back in batches of this size: with 1 every
    # step blocks on the device (reference-like); larger values keep steps
    # in flight while the plateau detector sees losses up to 2N-1 late
    loss_sync_interval: int = 1
    sync_file: Optional[str] = None
    sync_interval_seconds: float = 600.0
    verbose: bool = False


def bn_momentum_for_step(step_count: int, window: int) -> float:
    """dlib's BN running-stats schedule: the update factor is
    1/min(t, window) for the t-th update (a cumulative average until the
    window fills, then an EMA with momentum 1 - 1/window); ``step_count``
    updates came before (0 on the first step, whose running statistics
    are then exactly its batch's)."""
    return 1.0 - 1.0 / max(1, min(step_count + 1, window))


def _sgd(params: List[torch.Tensor], velocity: List[torch.Tensor],
         grads: List[torch.Tensor], lr: float, mu: float, wd: float) -> None:
    """v = mu v - lr (g + wd p) (weight decay on 4-D kernels only), then
    p = p + v; in place, over the whole parameter list."""
    conv = [i for i, p in enumerate(params) if p.dim() == 4]
    grads = list(grads)
    if conv and wd:
        decayed = torch._foreach_add([grads[i] for i in conv], [params[i] for i in conv],
                                     alpha=wd)
        for i, g in zip(conv, decayed):
            grads[i] = g
    torch._foreach_mul_(velocity, mu)
    torch._foreach_add_(velocity, grads, alpha=-lr)
    torch._foreach_add_(params, velocity)


def train_forward(params, bn_stats, images, model_config: SegNetConfig,
                  trainer_config: TrainerConfig, bn_momentum: float, reducer=None):
    """The training forward the config asks for: ``apply_train`` with the
    int8 conv under ``int8_forward``. ``reducer``: the data-parallel forward
    over a list of shards (``parallel/train.py``)."""
    return apply_train(
        params, bn_stats, images, model_config, bn_momentum=bn_momentum,
        remat=trainer_config.remat,
        conv_impl=int8_convs if trainer_config.int8_forward else None,
        reducer=reducer,
    )


def make_train_step(model_config: SegNetConfig, trainer_config: TrainerConfig) -> Callable:
    """The train step:

    (params, bn_stats, velocity, lr, bn_momentum, images, labels, weights)
        -> (new bn_stats, loss on the device)

    updating ``params`` and ``velocity`` (trees of f32 tensors) in place.
    ``images`` are uint8 or float 0..255 [N,H,W,C], ``labels`` integer
    [N,H,W] (IGNORE_LABEL allowed), ``weights`` f32 [N,H,W]."""
    mu = trainer_config.momentum
    wd = trainer_config.weight_decay

    def step(params, bn_stats, velocity, lr, bn_momentum, images, labels, weights):
        names = [k for k, _ in tree_items(params)]
        p_leaves = [t for _, t in tree_items(params)]
        v_by_name = dict(tree_items(velocity))
        device = images.device
        with torch.enable_grad():
            with span("forward", True, device):
                logits, new_stats = train_forward(params, bn_stats, images, model_config,
                                                  trainer_config, bn_momentum)
            with span("loss", True, device):
                loss = weighted_pixel_cross_entropy(logits, labels, weights)
            with span("backward", True, device):
                grads = torch.autograd.grad(loss, p_leaves)
        with torch.no_grad(), span("sgd", True, device):
            _sgd(p_leaves, [v_by_name[k] for k in names], grads, lr, mu, wd)
        return new_stats, loss.detach()

    return step


def _augment_and_weigh(images, labels, crop_options, class_count, draws,
                       flips_pre_applied: bool, timed: bool = True):
    """Augmentation, then the loss weights; ``timed``: their spans are
    timed on ``images``' device (the one-device trainer's)."""
    co = crop_options
    with span("augment", timed, images.device):
        images_f, labels = augment_batch(
            draws, images, labels,
            flips_pre_applied=flips_pre_applied,
            allow_flip_left_right=co.allow_flip_left_right,
            allow_flip_upside_down=co.allow_flip_upside_down,
            multiplicative_brightness_change_probability=(
                co.multiplicative_brightness_change_probability
            ),
            multiplicative_brightness_change_sigma=co.multiplicative_brightness_change_sigma,
            noise_level_stddev=co.noise_level_stddev,
            allow_random_color_offset=co.allow_random_color_offset,
        )
    with span("weighting", timed, images.device):
        weights = batched_label_weights(labels, co.class_weight, co.image_weight, class_count)
    return images_f, labels, weights


class Trainer:
    """Owns the parameters, the velocity and the learning-rate schedule on
    one device, checks plateaus, writes the sync file and exports the
    BN-folded runtime net."""

    def __init__(
        self,
        model_config: SegNetConfig,
        trainer_config: TrainerConfig = TrainerConfig(),
        seed: int = 0,
        *,
        device,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            # f32 convs and matmuls stay f32 (TF32 would keep 10 mantissa
            # bits): the f32 compute dtype means f32, as in the JAX package
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        if trainer_config.int8_forward:
            require_segnet(model_config, "int8 training (--int8-training)")
        self.model_config = model_config
        self.config = trainer_config
        params, bn_stats = init_state(model_config, seed)
        self.params, self.bn_stats, self.velocity = train_state_from_numpy(
            params, bn_stats, None, self.device
        )
        self.learning_rate = trainer_config.initial_learning_rate
        self.step_count = 0
        # step index of the last RECORDED loss (behind step_count while
        # losses wait on the device)
        self._recorded_steps = 0
        self.previous_loss_values: list = []
        self._pending_losses: list = []
        self.steps_without_progress = 0
        # optional structured-metrics callback, as the JAX Trainer's: a dict
        # per recorded loss and per learning-rate shrink
        self.metrics_hook = None
        # multi-process runs (parallel/train.py): ranks other than 0 write
        # no file, and a time-triggered sync save must not read back the
        # pending losses (a rank's clock would decide when its plateau
        # logic sees them, and the ranks' learning rates could part)
        self.io_process = True
        self.sync_flush = True
        self._last_sync = time.monotonic()
        self._step_fn = make_train_step(model_config, trainer_config)
        self._generator: Optional[torch.Generator] = None
        self._loss_window_cap = (
            trainer_config.iterations_without_progress_threshold
            + trainer_config.previous_loss_values_dump_amount
        )
        if trainer_config.sync_file:
            self._try_resume(trainer_config.sync_file)

    # ----------------------------------------------------------- train

    @property
    def pool_replicas(self):
        """The devices that hold a copy of the device image pool besides
        ``device`` (a data-parallel trainer's mesh)."""
        return ()

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        a = np.ascontiguousarray(a)
        return torch.from_numpy(a if a.flags.writeable else a.copy()).to(self.device)

    def _labels(self, labels: np.ndarray) -> torch.Tensor:
        """uint16 host labels -> int32 on the device (2 bytes a pixel over
        the link; IGNORE_LABEL stays 65535)."""
        labels = np.asarray(labels)
        if labels.dtype == np.uint16:
            return self._tensor(labels).to(torch.int32)
        return self._tensor(labels.astype(np.int32))

    def train_step(self, images: np.ndarray, labels: np.ndarray,
                   weights: np.ndarray) -> Optional[float]:
        """One update from host crops and host weights (no augmentation).
        Returns the loss when loss_sync_interval == 1, else None."""
        with span("train_step", True, self.device):
            loss = self._dispatch(self._tensor(images), self._labels(labels),
                                  self._tensor(weights.astype(np.float32)))
        return self._finish_step(loss)

    def augmentation_generator(self, seed: int = 0) -> torch.Generator:
        """The augmentation draws' generator on the device, seeded with
        seed ^ 0x5EED on first use (one stream for both fused entries)."""
        if self._generator is None:
            self._generator = torch.Generator(device=self.device)
            self._generator.manual_seed(seed ^ 0x5EED)
        return self._generator

    def train_step_crops(
        self,
        images: np.ndarray,  # [N,H,W,C] uint8 raw crops
        labels: np.ndarray,  # [N,H,W] uint16 (IGNORE_LABEL allowed)
        crop_options,  # data.crop.CropOptions
        seed: int = 0,
        draws: Optional[AugmentDraws] = None,
    ) -> Optional[float]:
        """One update from raw crops: augmentation, loss weights, forward,
        backward and SGD on the device. ``draws`` replaces the generator's
        draws (the seam a test or a cross-device check feeds)."""
        with span("train_step", True, self.device):
            x, lab = self._tensor(images), self._labels(labels)
            if draws is None:
                draws = draw_augmentations(self.augmentation_generator(seed), x.shape[0],
                                           tuple(x.shape[1:]), crop_options)
            x, lab, w = _augment_and_weigh(x, lab, crop_options, self.model_config.class_count,
                                           draws.to(self.device), flips_pre_applied=False)
            loss = self._dispatch(x, lab, w)
        return self._finish_step(loss)

    @staticmethod
    def _packed_decisions(pool, samples, rects, crop_options):
        """(crop side, [5, B] int32 slot, y0, x0, valid_h, valid_w) of the
        crop decisions, their images made resident in ``pool``."""
        fdf = crop_options.further_downscaling_factor
        if fdf > 1.0:
            raise ValueError(
                "train_step_decisions requires further_downscaling_factor "
                "<= 1 (the resize path materializes pixels on the host)"
            )
        slot_idx = pool.ensure(samples)
        valid_h, valid_w = pool.valid_dims(slot_idx)
        packed = np.stack([
            np.asarray(slot_idx, np.int32),
            np.asarray([r[1] for r in rects], np.int32),
            np.asarray([r[0] for r in rects], np.int32),
            valid_h, valid_w,
        ])
        return int(round(crop_options.dim * fdf)), packed

    def train_step_decisions(
        self,
        pool,  # train.device_cache.DeviceImagePool
        samples,  # list[Sample], one per crop (repeats allowed)
        rects,  # list[(l, t, r, b)] inclusive crop rects
        crop_options,  # data.crop.CropOptions
        seed: int = 0,
        draws: Optional[AugmentDraws] = None,
    ) -> Optional[float]:
        """One update from crop decisions against the device image pool:
        the pixels stay on the device and the host ships a [5, B] int32
        array (slot, y0, x0, valid_h, valid_w). Flips apply in the gather;
        the result equals train_step_crops on the same crops and draws."""
        with span("train_step", True, self.device):
            dim, packed = self._packed_decisions(pool, samples, rects, crop_options)
            if draws is None:
                draws = draw_augmentations(
                    self.augmentation_generator(seed), packed.shape[1],
                    (dim, dim, pool.images.shape[-1]), crop_options,
                )
            draws = draws.to(self.device)
            with span("gather", True, self.device):
                images, labels = gather_crops_packed(
                    pool.images, pool.labels, self._tensor(packed), dim,
                    flip_lr=draws.flip_lr, flip_ud=draws.flip_ud,
                )
            x, lab, w = _augment_and_weigh(images, labels, crop_options,
                                           self.model_config.class_count, draws,
                                           flips_pre_applied=True)
            loss = self._dispatch(x, lab, w)
        return self._finish_step(loss)

    def _dispatch(self, images, labels, weights) -> torch.Tensor:
        """Launch one update; the loss stays on the device."""
        self.bn_stats, loss = self._step_fn(
            self.params, self.bn_stats, self.velocity, self.learning_rate,
            self._bn_momentum(), images, labels, weights,
        )
        return loss

    def _bn_momentum(self) -> float:
        """The BN momentum of the next update (step_count persists in the
        sync file, so a resumed run keeps the schedule)."""
        return bn_momentum_for_step(self.step_count, max(1, self.config.bn_stats_window))

    def _finish_step(self, loss: torch.Tensor) -> Optional[float]:
        """Book-keep one step: the loss as a float when loss_sync_interval
        == 1 (blocking, reference behaviour); else it waits on the device,
        and once 2x the interval are pending the oldest interval is read
        back (those steps are long done, so the readback does not drain
        the queue of work)."""
        self.step_count += 1
        if self.config.loss_sync_interval <= 1:
            value = float(loss)
            self._record_loss(value)
            self._maybe_sync()
            return value
        self._pending_losses.append(loss)
        if len(self._pending_losses) >= 2 * self.config.loss_sync_interval:
            self.flush_losses(self.config.loss_sync_interval)
        return None

    def flush_losses(self, count: Optional[int] = None) -> None:
        """Read back the pending device losses (the oldest ``count``,
        default all) in one copy and run the plateau logic on them."""
        if not self._pending_losses:
            return
        if count is None or count >= len(self._pending_losses):
            batch, self._pending_losses = self._pending_losses, []
        else:
            batch = self._pending_losses[:count]
            self._pending_losses = self._pending_losses[count:]
        with span("loss_readback", True, self.device):
            for value in torch.stack(batch).tolist():
                self._record_loss(float(value))
        self._maybe_sync()

    def _record_loss(self, loss_value: float) -> None:
        self._recorded_steps += 1
        if not math.isfinite(loss_value):
            # the update already ran on a non-finite loss, so the
            # parameters are poisoned: fail loudly (the CLI exits 2)
            raise RuntimeError(
                f"training diverged: loss is {loss_value} at step "
                f"{self._recorded_steps} (learning rate "
                f"{self.learning_rate:g}) — lower --initial-learning-rate"
            )
        self.previous_loss_values.append(loss_value)
        if len(self.previous_loss_values) > self._loss_window_cap:
            del self.previous_loss_values[: len(self.previous_loss_values) - self._loss_window_cap]
        threshold = self.config.iterations_without_progress_threshold
        self.steps_without_progress = count_steps_without_decrease(self.previous_loss_values)
        if self.steps_without_progress > threshold:
            robust = count_steps_without_decrease_robust(self.previous_loss_values)
            if robust > threshold:
                self.learning_rate *= self.config.learning_rate_shrink_factor
                self.previous_loss_values.clear()
                self.steps_without_progress = 0
                if self.config.verbose:
                    print(f"step {self._recorded_steps}: learning rate "
                          f"shrunk to {self.learning_rate:g}")
                if self.metrics_hook is not None:
                    self.metrics_hook({
                        "event": "learning_rate_shrink",
                        "step": self._recorded_steps,
                        "learning_rate": self.learning_rate,
                    })
        if self.metrics_hook is not None:
            self.metrics_hook({
                "event": "loss",
                "step": self._recorded_steps,
                "loss": loss_value,
                "learning_rate": self.learning_rate,
                "steps_without_progress": self.steps_without_progress,
            })
        if self.config.verbose and self._recorded_steps % 100 == 0:
            dump = self.previous_loss_values[-self.config.previous_loss_values_dump_amount:]
            avg = sum(dump) / max(1, len(dump))
            print(
                f"step {self._recorded_steps}: learning rate "
                f"{self.learning_rate:g}, "
                f"average loss {avg:.6f}, steps without apparent progress "
                f"{self.steps_without_progress}"
            )

    @property
    def should_stop(self) -> bool:
        """True once plateau decay took the learning rate below
        ``min_learning_rate`` (annonet_train_main.cpp:569-571)."""
        return self.learning_rate < self.config.min_learning_rate

    # ----------------------------------------------------------- export

    def runtime_net(self) -> Params:
        """The BN-folded inference tree (numpy, the JAX layout)."""
        return fold_batchnorm(self.params, self.bn_stats, self.model_config)

    # ----------------------------------------------------------- sync

    def save_sync_file(self, path: Optional[str] = None, flush: bool = True) -> None:
        """Write the whole training state in the JAX package's
        trainer-state file, after reading back every pending loss unless
        ``flush`` is false (the file's loss window then lags its step
        count by the pending readbacks). Only the I/O process writes."""
        if flush:
            self.flush_losses()
        self._last_sync = time.monotonic()
        if not self.io_process:
            return
        path = path or self.config.sync_file
        if not path:
            return
        params = tree_to_numpy(self.params)
        meta = {
            "learning_rate": self.learning_rate,
            "step_count": self.step_count,
            "previous_loss_values": self.previous_loss_values[-self._loss_window_cap:],
            "model_config": self.model_config.to_dict(),
            "weights_fingerprint": serialization.weights_fingerprint(params),
        }
        serialization.save_trainer_state(path, {
            "params": params,
            "bn_stats": tree_to_numpy(self.bn_stats),
            "velocity": tree_to_numpy(self.velocity),
        }, meta)

    def _maybe_sync(self) -> None:
        if (
            self.config.sync_file
            and time.monotonic() - self._last_sync >= self.config.sync_interval_seconds
        ):
            self.save_sync_file(flush=self.sync_flush)

    def _try_resume(self, path: str) -> None:
        if not os.path.exists(path):
            return
        try:
            trees, meta = serialization.load_trainer_state(path)
        except Exception as e:
            raise RuntimeError(
                f"cannot resume: synchronization file {path} is unreadable "
                f"or corrupt ({e}); delete it to start fresh"
            ) from e
        if meta.get("model_config") != self.model_config.to_dict():
            raise RuntimeError(
                f"sync file {path} was written for a different model config; "
                "delete it or match the configuration"
            )
        self.params, self.bn_stats, self.velocity = train_state_from_numpy(
            trees["params"], trees["bn_stats"], trees["velocity"], self.device
        )
        self.learning_rate = float(meta["learning_rate"])
        self.step_count = int(meta["step_count"])
        self._recorded_steps = self.step_count
        self.previous_loss_values = [float(v) for v in meta["previous_loss_values"]]
        if self.config.verbose:
            print(f"resumed from {path} at step {self.step_count}, "
                  f"learning rate {self.learning_rate:g}")
