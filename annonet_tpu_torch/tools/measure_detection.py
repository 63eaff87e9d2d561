"""The detection-graded benchmark on the port: train on the synthetic
detection set, score with gains and detection levels, per region.

The counterpart of the JAX package's ``scripts/measure_detection.py``
(``run_benchmark``), with its configuration (``PARITY_TARGETS.json``
``detection_benchmark.config``): 10 training images of 256² (3 with
oversize smears, region filter by_area 8.0) and 6 clean evaluation images
from ``data/synthetic.py``, 5 defects each; the plateau loop (window 120,
min LR 0.0002, cap 2500 steps) at batch 8, 64² crops, level 2, width 32,
f32 compute, learning rate 0.02, with flips, brightness (p 0.5, sigma 0.1),
noise (stddev 2) and colour offsets; scored by the tiled inferer (128²
tiles, the receptive field as overlap) with gains [0, 0.5, 0.5] and
detection levels [0, 1.5, 2.0], per-pixel and per-region confusion.

    python -m annonet_tpu_torch.tools.measure_detection [--seeds 0 1 2]

It runs on the CUDA device (``ANNONET_TPU_TORCH_DEVICE=cpu`` runs it on
the CPU), prints each run's record as one JSON line and, on stderr, the
pinned floors of ``PARITY_TARGETS.json`` the run falls under. The init
(numpy, from the seed) and the augmentation draws (the trainer's
torch.Generator, seeded with 0 ^ 0x5EED in every run, as the JAX script's
trainer keys its draws with seed 0) are not jax.random's, so a seed's run
is not the JAX run of that seed; the crop-decision stream is
(``deterministic=True``).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile

import numpy as np
import torch

BENCH = dict(
    train_images=10,
    eval_images=6,
    size=256,
    defect_count=5,
    oversize_images=3,
    level_count=2,
    base_width=32,
    crop_dim=64,
    batch=8,
    lr=0.02,
    plateau_window=120,
    min_lr=2e-4,
    max_steps=2500,
    gains=[0.0, 0.5, 0.5],
    detection_levels=[0.0, 1.5, 2.0],
    region_filter_area=8.0,
    noise_stddev=2.0,
    brightness_prob=0.5,
    brightness_stddev=0.1,
    color_offset=True,
)

_TARGETS = pathlib.Path(__file__).resolve().parents[2] / "PARITY_TARGETS.json"


def pinned_floors():
    """(region recall floors [3], pixel accuracy floor) of
    PARITY_TARGETS.json's detection benchmark."""
    bench = json.loads(_TARGETS.read_text())["detection_benchmark"]
    return bench["pinned_region_recall_floor"], bench["pinned_pixel_accuracy_floor"]


def run_benchmark(seed: int, *, device, steps=None, verbose: bool = True,
                  score_device=None):
    """One run: train on ``device`` (the plateau loop to its min-LR stop,
    or ``steps`` steps), then score on ``score_device`` (default
    ``device``). Returns the JAX script's record: steps, LR shrinks,
    losses, pixel accuracy, region recall and precision, pixel recall, the
    region confusion matrix."""
    # cuDNN's default algorithms may sum in a different order run to run;
    # deterministic ones make a seed's run repeatable on one card
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _run(seed, BENCH, device, steps, verbose,
                    device if score_device is None else score_device)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _run(seed, b, device, steps, verbose, score_device):
    from annonet_tpu_torch.classes import parse_anno_classes
    from annonet_tpu_torch.data.crop import CropOptions
    from annonet_tpu_torch.data.dataset import find_image_files
    from annonet_tpu_torch.data.pipeline import CropPipeline, RegionFilterOptions
    from annonet_tpu_torch.data.sample import read_sample
    from annonet_tpu_torch.data.synthetic import write_detection_dataset
    from annonet_tpu_torch.infer.core import TiledInferer, annonet_infer
    from annonet_tpu_torch.infer.evaluation import (
        new_confusion_matrix,
        update_confusion_matrix_per_pixel,
        update_confusion_matrix_per_region,
    )
    from annonet_tpu_torch.infer.tiling import TilingParameters
    from annonet_tpu_torch.models.segnet import SegNetConfig, required_input_dimension
    from annonet_tpu_torch.train.trainer import Trainer, TrainerConfig

    with tempfile.TemporaryDirectory() as td:
        td = pathlib.Path(td)
        write_detection_dataset(
            td / "train", n_images=b["train_images"], size=b["size"], seed=seed,
            defect_count=b["defect_count"], oversize_images=b["oversize_images"],
        )
        write_detection_dataset(
            td / "eval", n_images=b["eval_images"], size=b["size"], seed=seed + 1000,
            defect_count=b["defect_count"], oversize_images=0,
        )
        anno_classes = parse_anno_classes((td / "train" / "anno_classes.json").read_text())
        config = SegNetConfig(class_count=3, level_count=b["level_count"],
                              base_width=b["base_width"], compute_dtype="float32")
        rfield = required_input_dimension(config)
        files = find_image_files(str(td / "train"), require_ground_truth=True, verbose=False)
        region_filter = RegionFilterOptions(receptive_field_side=rfield,
                                            by_area=b["region_filter_area"])
        trainer = Trainer(
            config,
            TrainerConfig(
                initial_learning_rate=b["lr"],
                iterations_without_progress_threshold=b["plateau_window"],
                previous_loss_values_dump_amount=b["plateau_window"],
                min_learning_rate=b["min_lr"],
            ),
            seed=seed,
            device=device,
        )
        events = []
        trainer.metrics_hook = lambda e: (
            events.append(e) if e["event"] == "learning_rate_shrink" else None
        )
        crop_options = CropOptions(
            dim=b["crop_dim"], allow_flip_left_right=True, allow_flip_upside_down=True,
            multiplicative_brightness_change_probability=b["brightness_prob"],
            multiplicative_brightness_change_sigma=b["brightness_stddev"],
            noise_level_stddev=b["noise_stddev"],
            allow_random_color_offset=b["color_offset"],
        )
        with CropPipeline(files, anno_classes, crop_options, thread_count=2, seed=seed,
                          deterministic=True, region_filter=region_filter) as pipe:
            losses = []
            while len(losses) < (b["max_steps"] if steps is None else steps):
                if steps is None and trainer.should_stop:
                    break
                images, labels = pipe.next_minibatch(b["batch"], warn=None)
                # no seed, as the JAX script: every seed's run draws its
                # augmentations from the stream of seed 0
                losses.append(trainer.train_step_crops(images, labels, crop_options))

        tiling = TilingParameters(
            max_tile_width=b["size"] // 2, max_tile_height=b["size"] // 2,
            overlap_x=rfield, overlap_y=rfield,
        )
        inferer = TiledInferer(trainer.runtime_net(), config, tiling, device=score_device)
        cm_pixel = new_confusion_matrix(3)
        cm_region = new_confusion_matrix(3)
        for fns in find_image_files(str(td / "eval"), require_ground_truth=True,
                                    verbose=False):
            s = read_sample(fns, anno_classes, True, 1.0)
            if s.error:
                raise RuntimeError(s.error)
            result = annonet_infer(inferer, s.input_image, gains=b["gains"],
                                   detection_levels=b["detection_levels"])
            update_confusion_matrix_per_pixel(cm_pixel, s.labeled_points_by_class, result)
            update_confusion_matrix_per_region(cm_region, s.labeled_points_by_class,
                                               s.label_image, result)

    def recalls(cm):
        return [float(cm[c, c] / cm[c, :].sum()) if cm[c, :].sum() else None
                for c in range(3)]

    def precisions(cm):
        return [float(cm[c, c] / cm[:, c].sum()) if cm[:, c].sum() else None
                for c in range(3)]

    out = {
        "seed": seed,
        "steps": len(losses),
        "stopped_at_min_lr": bool(steps is None and trainer.should_stop),
        "final_learning_rate": float(trainer.learning_rate),
        "lr_shrinks": [{"step": e["step"], "learning_rate": e["learning_rate"]}
                       for e in events],
        "loss_first": float(np.mean(losses[:5])),
        "loss_last": float(np.mean(losses[-5:])),
        "pixel_accuracy": float(np.trace(cm_pixel) / cm_pixel.sum()),
        "region_recall": recalls(cm_region),
        "region_precision": precisions(cm_region),
        "pixel_recall": recalls(cm_pixel),
        "region_cm": cm_region.tolist(),
    }
    if verbose:
        print(json.dumps(out))
    return out


def below_floors(run) -> list:
    """The floors a run falls under: [] when it clears them all."""
    recall_floor, pixel_floor = pinned_floors()
    missed = [
        f"region recall of class {c}: {r} < {f}"
        for c, (r, f) in enumerate(zip(run["region_recall"], recall_floor))
        if r is None or r < f
    ]
    if run["pixel_accuracy"] < pixel_floor:
        missed.append(f"pixel accuracy {run['pixel_accuracy']} < {pixel_floor}")
    return missed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="measure_detection")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args(argv)

    from annonet_tpu_torch.cli.common import resolve_device

    device = resolve_device()
    for seed in args.seeds:
        missed = below_floors(run_benchmark(seed, device=device))
        if missed:
            print(f"seed {seed} under the floors: {'; '.join(missed)}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
