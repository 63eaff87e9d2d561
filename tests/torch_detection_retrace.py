"""The port's detection benchmark fed the JAX package's randomness: a
measurement script, not a test (pytest does not collect it).

``annonet_tpu_torch/tools/measure_detection.py`` draws its init from numpy
and its augmentations from a torch.Generator, so a seed's run is another
random realisation than ``scripts/measure_detection.py``'s run of that
seed, while the dataset and the crop decisions are the same. This script
runs the port's ``run_benchmark`` with the JAX package's ``init_state``
for the seed and the augmentation draws that the JAX script's trainer
makes (the key carry of ``jax.random.PRNGKey(0 ^ 0x5EED)``, split once a
step, each step's key split into the eight stage keys of
``annonet_tpu.ops.augment.augment_batch``), so that the port's training
and scoring meet the JAX run's own random numbers. It prints one JSON
record a seed, as both measure_detection scripts do.

    PYTHONPATH=. python tests/torch_detection_retrace.py --seeds 0 1 2

It runs on the CPU (f32, as the recipe).
"""

from __future__ import annotations

import argparse
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch


def jax_draws():
    """A draw_augmentations stand-in that hands out the JAX script's
    per-step draws in order."""
    from annonet_tpu_torch.ops.augment import AugmentDraws

    state = {"carry": jax.random.PRNGKey(0 ^ 0x5EED)}

    def draws(_generator, n, shape, _crop_options):
        state["carry"], step_key = jax.random.split(state["carry"])
        keys = jax.random.split(step_key, 8)

        def uniform(k, size):
            return torch.from_numpy(np.array(jax.random.uniform(keys[k], size, jnp.float32)))

        def normal(k, size):
            return torch.from_numpy(np.array(jax.random.normal(keys[k], size)))

        return AugmentDraws(
            flip_lr=uniform(0, (n,)) > 0.5, flip_ud=uniform(1, (n,)) > 0.5,
            bright_u=uniform(2, (n,)), bright_normal=normal(3, (n,)),
            noise_normal=normal(4, (n,)), noise_u=uniform(5, (n, *shape)),
            gamma_u=uniform(6, (n,)), scales_u=uniform(7, (n, 3)))

    return draws


def jax_init(config, seed):
    """The JAX package's init_state for ``seed``, as numpy trees."""
    from annonet_tpu.models import segnet as jax_segnet

    params, stats = jax_segnet.init_state(
        jax.random.PRNGKey(seed), jax_segnet.SegNetConfig(**config.to_dict()))
    return (jax.tree_util.tree_map(np.asarray, params),
            jax.tree_util.tree_map(np.asarray, stats))


def run(seed: int) -> dict:
    import annonet_tpu_torch.train.trainer as trainer
    from annonet_tpu_torch.tools import measure_detection

    saved = trainer.draw_augmentations, trainer.init_state
    trainer.draw_augmentations, trainer.init_state = jax_draws(), jax_init
    try:
        return measure_detection.run_benchmark(seed, device="cpu", verbose=False)
    finally:
        trainer.draw_augmentations, trainer.init_state = saved


def main(argv=None) -> int:
    jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser(prog="torch_detection_retrace")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(run(seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
