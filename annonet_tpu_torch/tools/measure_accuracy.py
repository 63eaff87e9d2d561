"""The end-to-end accuracy floors on a net the port trains: the recipe of
``tests/test_end_to_end.py`` (the JAX package's round trip, and
``scripts/measure_parity.py``, which pinned ``PARITY_TARGETS.json``'s
floors) run on the port.

A synthetic 4-image 48x48 two-class set (bright red defects on green,
``write_separable_dataset``, the JAX test's ``write_synthetic_dataset``
pixel for pixel); ``SegNetConfig(level_count=1, base_width=8,
compute_dtype="float32")``; 40 steps of batch 8 at learning rate 0.05 on
16x16 crops with left-right flips from ``CropPipeline(thread_count=2,
deterministic=True)``; then the artifact is saved, loaded back and tiled
over every image by the float inferer and the int8 one, and scored by the
per-pixel confusion matrix: pixel accuracy and mIoU (float), pixel
accuracy (int8), against ``pinned_pixel_accuracy_floor`` and
``pinned_miou_floor``.

A seed ``s`` runs the trainer with seed ``s`` and the crop stream with
seed ``s + 1``, as ``scripts/measure_parity.py`` does; seed 0 is the
test's recipe. The port's init and augmentation draws are its own
(numpy He init, a torch.Generator), so a seed's run is not JAX's run of
that seed.

    python -m annonet_tpu_torch.tools.measure_accuracy [--seeds 0 1 2]

It trains on the CUDA device (``ANNONET_TPU_TORCH_DEVICE=cpu`` on the
CPU) and prints each run's record as one JSON line, and on stderr the
floors a run falls under.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile

import numpy as np

_TARGETS = pathlib.Path(__file__).resolve().parents[2] / "PARITY_TARGETS.json"


def pinned_floors():
    """(pixel accuracy floor, mIoU floor) of PARITY_TARGETS.json."""
    targets = json.loads(_TARGETS.read_text())
    return targets["pinned_pixel_accuracy_floor"], targets["pinned_miou_floor"]


def write_separable_dataset(root, n_images: int = 4, size: int = 48, seed: int = 0):
    """Trivially separable 2-class data, defect pixels bright red: the
    files ``tests/test_end_to_end.py::write_synthetic_dataset`` writes."""
    from PIL import Image

    from annonet_tpu_torch.classes import AnnoClass, anno_classes_to_json

    classes = [AnnoClass(0, (0, 255, 0, 64), "clean"),
               AnnoClass(1, (255, 0, 0, 128), "defect")]
    root = pathlib.Path(root)
    rng = np.random.default_rng(seed)
    (root / "anno_classes.json").write_text(anno_classes_to_json(classes))
    for i in range(n_images):
        labels = np.zeros((size, size), dtype=np.uint16)
        for _ in range(3):
            y, x = rng.integers(4, size - 10, size=2)
            h, w = rng.integers(4, 8, size=2)
            labels[y : y + h, x : x + w] = 1
        noise = rng.integers(0, 40, size=(size, size, 3))
        image = np.where(
            labels[..., None] == 1,
            np.array([220, 30, 30]) + noise - 20,
            np.array([40, 120, 40]) + noise - 20,
        ).clip(0, 255).astype(np.uint8)
        mask = np.zeros((size, size, 4), dtype=np.uint8)
        mask[labels == 0] = classes[0].rgba_label
        mask[labels == 1] = classes[1].rgba_label
        Image.fromarray(image).save(root / f"img{i}.png")
        Image.fromarray(mask, mode="RGBA").save(root / f"img{i}.png_mask.png")


def pixel_scores(cm) -> tuple:
    """(pixel accuracy, mIoU over the classes present in the ground truth)
    of a per-pixel confusion matrix, as the JAX test computes them."""
    ious = []
    for c in range(cm.shape[0]):
        tp = cm[c, c]
        if cm[c, :].sum() > 0:
            ious.append(tp / max(1, cm[c, :].sum() + cm[:, c].sum() - tp))
    return float(np.trace(cm) / cm.sum()), float(sum(ious) / len(ious))


def train_and_score(data_dir, seed: int = 0, *, device, steps: int = 40,
                    infer_device=None) -> dict:
    """The recipe on ``data_dir`` (``write_separable_dataset``): train on
    ``device``, save and load the artifact, infer on ``infer_device``
    (default ``device``) with the float and the int8 inferer. Returns
    {seed, losses, pixel_accuracy, miou, int8_pixel_accuracy,
    ground_truth_pixels}."""
    import torch

    from annonet_tpu_torch import serialization
    from annonet_tpu_torch.classes import parse_anno_classes
    from annonet_tpu_torch.data.crop import CropOptions
    from annonet_tpu_torch.data.dataset import find_image_files
    from annonet_tpu_torch.data.pipeline import CropPipeline
    from annonet_tpu_torch.data.sample import read_sample
    from annonet_tpu_torch.infer.core import TiledInferer, annonet_infer
    from annonet_tpu_torch.infer.evaluation import (
        new_confusion_matrix,
        update_confusion_matrix_per_pixel,
    )
    from annonet_tpu_torch.models.segnet import SegNetConfig
    from annonet_tpu_torch.train.trainer import Trainer, TrainerConfig

    data_dir = pathlib.Path(data_dir)
    infer_device = device if infer_device is None else infer_device
    files = find_image_files(str(data_dir), require_ground_truth=True, verbose=False)
    anno_classes_json = (data_dir / "anno_classes.json").read_text()
    anno_classes = parse_anno_classes(anno_classes_json)
    config = SegNetConfig(class_count=len(anno_classes), level_count=1, base_width=8,
                          compute_dtype="float32")
    trainer = Trainer(config, TrainerConfig(initial_learning_rate=0.05), seed=seed,
                      device=device)
    crop_options = CropOptions(dim=16, allow_flip_left_right=True)
    losses = []
    # deterministic: the crop stream is a function of (seed, dataset), not
    # of how the two loader threads interleave
    with CropPipeline(files, anno_classes, crop_options, thread_count=2, seed=seed + 1,
                      deterministic=True) as pipe:
        for _ in range(steps):
            images, labels = pipe.next_minibatch(8, warn=None)
            losses.append(trainer.train_step_crops(images, labels, crop_options, seed=seed))

    with tempfile.TemporaryDirectory() as td:
        model_path = str(pathlib.Path(td) / "annonet.dnn")
        serialization.save_model(model_path, trainer.runtime_net(), config,
                                 anno_classes_json, downscaling_factor=1.0)
        params, config, json_back, factor = serialization.load_model(model_path)
    classes_back = parse_anno_classes(json_back)
    samples = [read_sample(f, classes_back, require_ground_truth=False,
                           downscaling_factor=factor)
               for f in find_image_files(str(data_dir), require_ground_truth=False,
                                         verbose=False)]
    record = {"seed": seed, "losses": [float(v) for v in losses]}
    for name, kwargs in (("float", {}), ("int8", {"quantize": "int8"})):
        inferer = TiledInferer(params, config, device=infer_device, **kwargs)
        cm = new_confusion_matrix(config.class_count)
        gt_pixels = 0
        with torch.inference_mode():
            for sample in samples:
                gt_pixels += update_confusion_matrix_per_pixel(
                    cm, sample.labeled_points_by_class, annonet_infer(inferer, sample.input_image))
        accuracy, miou = pixel_scores(cm)
        if name == "float":
            record.update(pixel_accuracy=accuracy, miou=miou, ground_truth_pixels=gt_pixels,
                          confusion_per_pixel=cm.tolist())
        else:
            if inferer.float_fallbacks or not inferer._quantized:
                raise RuntimeError("the int8 inferer did not run the int8 net")
            record.update(int8_pixel_accuracy=accuracy)
    return record


def below_floors(run) -> list:
    """The floors a run falls under: [] when it clears them all."""
    pixel_floor, miou_floor = pinned_floors()
    missed = []
    if run["pixel_accuracy"] < pixel_floor:
        missed.append(f"pixel accuracy {run['pixel_accuracy']:.4f} < {pixel_floor}")
    if run["miou"] < miou_floor:
        missed.append(f"mIoU {run['miou']:.4f} < {miou_floor}")
    if run["int8_pixel_accuracy"] < pixel_floor:
        missed.append(f"int8 pixel accuracy {run['int8_pixel_accuracy']:.4f} < {pixel_floor}")
    return missed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="measure_accuracy")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    args = ap.parse_args(argv)

    from annonet_tpu_torch.cli.common import resolve_device

    device = resolve_device()
    for seed in args.seeds:
        with tempfile.TemporaryDirectory() as td:
            write_separable_dataset(td)
            run = train_and_score(td, seed, device=device)
        run.pop("losses")
        print(json.dumps(run), flush=True)
        missed = below_floors(run)
        if missed:
            print(f"seed {seed} under the floors: {'; '.join(missed)}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
