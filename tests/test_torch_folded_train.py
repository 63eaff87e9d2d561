"""The port's folded training (annonet_tpu_torch/models/folded_runtime.py
apply_train_folded) against the JAX package's, on the CPU, in f32.

From one JAX init_state, the logits, the new BN statistics and the
gradients of the original parameters agree with JAX's apply_train_folded
within 1e-4 of each tensor's scale (the same function, summed in another
order), and with the port's own apply_train likewise; the trainer takes the
folded path behind JAX's gate (not remat, crop width % 8 == 0, RGB), and
the folded data-parallel step equals the folded single-device step within
JAX's DP tolerances (loss rtol 1e-4, params rtol 1e-3, atol 1e-5), and one
folded step of the flagship updates every parameter as the unfolded step
does, within 5e-3 of the update.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from annonet_tpu.models import folded_runtime as jax_folded
from annonet_tpu.models.segnet import SegNetConfig as JaxSegNetConfig
from annonet_tpu.models.segnet import init_state as jax_init_state
from annonet_tpu_torch.data.crop import CropOptions
from annonet_tpu_torch.models import folded_runtime
from annonet_tpu_torch.models.segnet import (
    SegNetConfig,
    apply_train,
    train_state_from_numpy,
    tree_items,
)
from annonet_tpu_torch.parallel import ensure_virtual_devices
from annonet_tpu_torch.parallel.train import DataParallelTrainer
from annonet_tpu_torch.train import Trainer, TrainerConfig

TOL = 1e-4


def _scaled_gap(mine, theirs) -> float:
    mine, theirs = np.asarray(mine), np.asarray(theirs)
    return float(np.abs(mine - theirs).max() / max(np.abs(theirs).max(), 1e-12))


def _setup(level_count, shape, seed):
    config = SegNetConfig(class_count=3, level_count=level_count, base_width=4,
                          compute_dtype="float32")
    jcfg = JaxSegNetConfig(**config.to_dict())
    p, s = jax.tree_util.tree_map(np.asarray, jax_init_state(jax.random.PRNGKey(seed), jcfg))
    x = np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)
    return config, jcfg, p, s, x


@pytest.mark.parametrize("level_count", [0, 1, 2, 3])
def test_forward_matches_jax_and_apply_train(level_count):
    config, jcfg, p, s, x = _setup(level_count, (2, 16, 32, 3), level_count)
    logits_j, stats_j = jax_folded.apply_train_folded(p, s, jnp.asarray(x), jcfg, 0.9, fold0=8)
    tp, ts, _v = train_state_from_numpy(p, s, None, "cpu")
    with torch.no_grad():
        logits, stats = folded_runtime.apply_train_folded(tp, ts, torch.from_numpy(x), config,
                                                          0.9)
        ref_logits, ref_stats = apply_train(tp, ts, torch.from_numpy(x), config, 0.9)
    assert _scaled_gap(logits, logits_j) < TOL
    assert _scaled_gap(logits, ref_logits) < TOL
    jstats = dict(tree_items(jax.tree_util.tree_map(np.asarray, stats_j)))
    ref = dict(tree_items(ref_stats))
    for k, v in tree_items(stats):
        assert _scaled_gap(v, jstats[k]) < TOL, k
        assert _scaled_gap(v, ref[k]) < TOL, k


def test_gradients_match_jax():
    """The gradients of the ORIGINAL parameters through the folded kernels
    (index scatters of the live weights) equal JAX's."""
    config, jcfg, p, s, x = _setup(2, (1, 16, 16, 3), 3)

    def jax_loss(params):
        logits, _ = jax_folded.apply_train_folded(params, s, jnp.asarray(x), jcfg, 0.9, fold0=8)
        return jnp.sum(logits ** 2)

    g_j = dict(tree_items(jax.tree_util.tree_map(np.asarray, jax.grad(jax_loss)(p))))
    tp, ts, _v = train_state_from_numpy(p, s, None, "cpu")
    logits, _ = folded_runtime.apply_train_folded(tp, ts, torch.from_numpy(x), config, 0.9)
    names = [k for k, _t in tree_items(tp)]
    grads = torch.autograd.grad((logits ** 2).sum(), [t for _k, t in tree_items(tp)])
    for k, g in zip(names, grads):
        assert _scaled_gap(g, g_j[k]) < TOL, k


def test_fold_width_kernel_matches_jax():
    from annonet_tpu.ops.folded_conv import fold_width_kernel

    w = np.random.default_rng(1).standard_normal((3, 3, 5, 6)).astype(np.float32)
    for fold in (1, 2, 4, 8):
        want = np.asarray(fold_width_kernel(jnp.asarray(w), fold))
        got = folded_runtime.fold_width_kernel(torch.from_numpy(w), fold).numpy()
        np.testing.assert_array_equal(got, want)


def test_the_gate_is_jaxs():
    rgb = SegNetConfig(class_count=2, level_count=1, base_width=4)
    gray = SegNetConfig(class_count=2, level_count=1, base_width=4, grayscale=True)
    assert folded_runtime.folded_training_applies(rgb, 48, remat=False)
    assert not folded_runtime.folded_training_applies(rgb, 48, remat=True)
    assert not folded_runtime.folded_training_applies(rgb, 44, remat=False)
    assert not folded_runtime.folded_training_applies(gray, 48, remat=False)


def _batch(n=8, dim=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, dim, dim, 3), dtype=np.uint8),
            rng.integers(0, 2, (n, dim, dim)).astype(np.uint16))


def test_trainer_takes_the_folded_path_behind_the_gate(monkeypatch):
    config = SegNetConfig(class_count=2, level_count=1, base_width=4, compute_dtype="float32")
    calls = []
    real = folded_runtime.apply_train_folded
    monkeypatch.setattr("annonet_tpu_torch.train.trainer.apply_train_folded",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    images, labels = _batch()
    losses = {}
    for name, tc in (("folded", TrainerConfig(folded_training=True)),
                     ("remat", TrainerConfig(folded_training=True, remat=True)),
                     ("plain", TrainerConfig())):
        before = len(calls)
        trainer = Trainer(config, tc, seed=0, device="cpu")
        losses[name] = trainer.train_step_crops(images, labels, CropOptions(dim=16))
        assert (len(calls) > before) == (name == "folded"), name
    assert abs(losses["folded"] - losses["plain"]) <= 1e-5 * losses["plain"]


@pytest.mark.parametrize("shards", [2, 4])
def test_folded_dp_step_equals_single_device(shards):
    config = SegNetConfig(class_count=2, level_count=1, base_width=4, compute_dtype="float32")
    tc = TrainerConfig(initial_learning_rate=0.01, folded_training=True)
    images, labels = _batch()
    single = Trainer(config, tc, seed=0, device="cpu")
    dp = DataParallelTrainer(config, tc, seed=0, mesh=ensure_virtual_devices(shards, "cpu"))
    loss_single = single.train_step_crops(images, labels, CropOptions(dim=16))
    loss_dp = dp.train_step_crops(images, labels, CropOptions(dim=16))
    assert np.isclose(loss_single, loss_dp, rtol=1e-4)
    for tree_s, tree_d in ((single.params, dp.params), (single.bn_stats, dp.bn_stats)):
        for (k, a), (_k, b) in zip(tree_items(tree_d), tree_items(tree_s)):
            np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-3,
                                       atol=1e-5, err_msg=k)


def test_folded_step_updates_match_the_unfolded_step():
    """One SGD step of the flagship (level 3, width 16, 4 crops of 192²,
    f32) folded and unfolded from one init: every parameter's update within
    5e-3 of its largest element (chip_smoke.py phase 11f's tolerance). BN's
    input gradient is a difference of nearly equal terms, and a leaf's
    one-step update can be small against them, so this holds the folded
    BN's summation structure, not only its function."""
    config = SegNetConfig(class_count=3, level_count=3, base_width=16, compute_dtype="float32")
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (4, 192, 192, 3), dtype=np.uint8)
    labels = (rng.random((4, 192, 192)) * 3).astype(np.uint16)
    weights = np.ones((4, 192, 192), np.float32)
    steps = {}
    for folded in (False, True):
        trainer = Trainer(config, TrainerConfig(folded_training=folded), seed=0, device="cpu")
        before = {k: v.detach().clone() for k, v in tree_items(trainer.params)}
        trainer.train_step(images, labels, weights)
        steps[folded] = {k: v.detach() - before[k] for k, v in tree_items(trainer.params)}
    for k, update in steps[False].items():
        gap = float((steps[True][k] - update).abs().max() / update.abs().max().clamp(min=1e-30))
        assert gap < 5e-3, (k, gap)
