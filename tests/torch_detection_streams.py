"""Where the port's detection runs part from JAX's: a measurement script,
not a test (pytest does not collect it; it imports no jax).

``annonet_tpu_torch/tools/measure_detection.py`` trains with the trainer's
augmentation generator on the training device: on a CUDA device that is
Philox's stream, on the CPU the CPU generator's. This script runs the
tool's recipe at each seed in arms that change one thing at a time:

  device         the tool as it is: draws from the device's generator,
                 trained and scored on the device
  device_scored_cpu  the same training (deterministic on one card), the
                 trained net scored on the CPU
  cpu_draws      the draws of the CPU generator (seeded 0 ^ 0x5EED, as a
                 CPU run makes them), moved to the device; trained and
                 scored on the device

so that ``device`` against ``device_scored_cpu`` isolates the scoring
device, ``cpu_draws`` against the tool's CPU run (``measure_detection
--seeds ...`` with ``ANNONET_TPU_TORCH_DEVICE=cpu``) the training device,
and ``device`` against ``cpu_draws`` the generator's stream. It prints one
JSON record a seed and arm.

    PYTHONPATH=. python tests/torch_detection_streams.py --seeds 16 17 18
"""

from __future__ import annotations

import argparse
import json
import sys

import torch


def cpu_draws(device):
    """A draw_augmentations stand-in that draws from one CPU generator
    seeded 0 ^ 0x5EED and moves the draws to ``device``."""
    from annonet_tpu_torch.ops import augment

    generator = torch.Generator()
    generator.manual_seed(0 ^ 0x5EED)
    draw = augment.draw_augmentations

    def draws(_generator, n, shape, crop_options):
        return draw(generator, n, shape, crop_options).to(device)

    return draws


def run(seed: int, arm: str, device) -> dict:
    import annonet_tpu_torch.train.trainer as trainer
    from annonet_tpu_torch.tools import measure_detection

    saved = trainer.draw_augmentations
    if arm == "cpu_draws":
        trainer.draw_augmentations = cpu_draws(device)
    try:
        record = measure_detection.run_benchmark(
            seed, device=device, verbose=False,
            score_device="cpu" if arm == "device_scored_cpu" else None)
    finally:
        trainer.draw_augmentations = saved
    return {"arm": arm, **record}


def main(argv=None) -> int:
    from annonet_tpu_torch.cli.common import resolve_device

    ap = argparse.ArgumentParser(prog="torch_detection_streams")
    ap.add_argument("--seeds", type=int, nargs="+", default=[16, 17, 18])
    ap.add_argument("--arms", nargs="+", default=["device", "device_scored_cpu", "cpu_draws"])
    args = ap.parse_args(argv)
    device = resolve_device()
    for seed in args.seeds:
        for arm in args.arms:
            print(json.dumps(run(seed, arm, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
