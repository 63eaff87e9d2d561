"""The port's data-parallel training (annonet_tpu_torch/parallel/train.py)
on virtual shards of the CPU: the counterpart of tests/test_parallel.py.

The DP step on 2, 4 and 8 shards equals the port's single-device step (f32,
level 1, width 4, no augmentation) within JAX's tolerances (loss rtol 1e-4;
params and BN statistics rtol 1e-3, atol 1e-5: sync BN makes it the same
function, only summation order differs), and equals JAX's
DataParallelTrainer on the 8 virtual CPU devices conftest sets up, from one
state and batch, within 1e-4 of each tensor's scale. It trains, refuses an
indivisible batch, its pool step equals the single-device pool step, its
augmentation draws are per global shard, and its sync file crosses to JAX's
DataParallelTrainer and back.
"""

import jax
import numpy as np
import pytest
import torch

from annonet_tpu.data.crop import CropOptions as JaxCropOptions
from annonet_tpu.models.segnet import SegNetConfig as JaxSegNetConfig
from annonet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from annonet_tpu.parallel.train import DataParallelTrainer as JaxDataParallelTrainer
from annonet_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from annonet_tpu_torch.data.crop import CropOptions
from annonet_tpu_torch.models.segnet import SegNetConfig, train_state_from_numpy, tree_items
from annonet_tpu_torch.parallel import ensure_virtual_devices
from annonet_tpu_torch.parallel.train import DataParallelTrainer
from annonet_tpu_torch.train import DeviceImagePool, Trainer, TrainerConfig
from tests.test_torch_train_step import AUGMENT, _decisions, _errors, _numpy, _samples

CONFIG = SegNetConfig(class_count=2, level_count=1, base_width=4, compute_dtype="float32")


def make_batch(n=8, dim=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, size=(n, dim, dim, 3), dtype=np.uint8),
            rng.integers(0, 2, size=(n, dim, dim)).astype(np.uint16))


def _close(mine, theirs):
    for tree_m, tree_t in ((mine.params, theirs.params), (mine.bn_stats, theirs.bn_stats)):
        for (k, a), (_k, b) in zip(tree_items(tree_m), tree_items(tree_t)):
            np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-3,
                                       atol=1e-5, err_msg=k)


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_dp_step_matches_single_device(shards):
    tc = TrainerConfig(initial_learning_rate=0.01)
    images, labels = make_batch()
    single = Trainer(CONFIG, tc, seed=0, device="cpu")
    dp = DataParallelTrainer(CONFIG, tc, seed=0, mesh=ensure_virtual_devices(shards, "cpu"))
    assert dp.device_count == shards
    loss_single = single.train_step_crops(images, labels, CropOptions(dim=16))
    loss_dp = dp.train_step_crops(images, labels, CropOptions(dim=16))
    assert np.isclose(loss_single, loss_dp, rtol=1e-4), (loss_single, loss_dp)
    _close(dp, single)


def test_dp_step_matches_jax_data_parallel_trainer():
    """From JAX's state, the port's DP step on 8 virtual shards against
    JAX's DataParallelTrainer on its 8 virtual CPU devices (no
    augmentation, so no draws): loss, parameters, velocity and statistics
    within 1e-4 of scale."""
    jt = JaxDataParallelTrainer(JaxSegNetConfig(**CONFIG.to_dict()),
                                JaxTrainerConfig(initial_learning_rate=0.01), seed=0,
                                mesh=jax_make_mesh(8))
    port = DataParallelTrainer(CONFIG, TrainerConfig(initial_learning_rate=0.01), seed=0,
                               mesh=ensure_virtual_devices(8, "cpu"))
    port.params, port.bn_stats, port.velocity = train_state_from_numpy(
        _numpy(jt.params), _numpy(jt.bn_stats), _numpy(jt.velocity), "cpu")
    images, labels = make_batch(seed=1)
    jax_loss = jt.train_step_crops(images, labels, JaxCropOptions(dim=16))
    loss = port.train_step_crops(images, labels, CropOptions(dim=16))
    assert abs(loss - jax_loss) <= 1e-4 * abs(jax_loss)
    for mine, theirs in ((port.params, jt.params), (port.velocity, jt.velocity),
                         (port.bn_stats, jt.bn_stats)):
        errors = _errors(mine, theirs)
        assert max(errors.values()) < 1e-4, max(errors.items(), key=lambda kv: kv[1])


def test_dp_step_trains():
    tc = TrainerConfig(initial_learning_rate=0.05)
    co = CropOptions(dim=16, allow_flip_left_right=True, noise_level_stddev=2.0)
    dp = DataParallelTrainer(CONFIG, tc, seed=1, mesh=ensure_virtual_devices(8, "cpu"))
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(10):
        labels = rng.integers(0, 2, size=(16, 16, 16)).astype(np.uint16)
        images = np.where(labels[..., None] == 1, 200, 50).astype(np.uint8).repeat(3, -1)
        losses.append(dp.train_step_crops(images, labels, co))
    assert losses[-1] < losses[0]
    assert dp.step_count == 10


def test_dp_rejects_indivisible_batch():
    dp = DataParallelTrainer(CONFIG, TrainerConfig(), mesh=ensure_virtual_devices(8, "cpu"))
    images, labels = make_batch(n=6)
    with pytest.raises(ValueError, match="divisible"):
        dp.train_step_crops(images, labels, CropOptions(dim=16))
    samples, rects = _decisions(_samples(), 16)
    with pytest.raises(ValueError, match="divisible"):
        dp.train_step_decisions(DeviceImagePool(2, device="cpu"), samples[:3], rects[:3],
                                CropOptions(dim=16))


@pytest.mark.parametrize("shards", [2, 4])
def test_dp_pool_step_equals_single_device_pool_step(shards):
    """The pool path with augmentation, fed the same draws: each shard
    gathers its columns from its replica of the pool."""
    config = SegNetConfig(class_count=3, level_count=2, base_width=8, compute_dtype="float32")
    dim = 32
    samples, rects = _decisions(_samples(), dim)
    options = CropOptions(dim=dim, **AUGMENT)
    gen = torch.Generator()
    gen.manual_seed(7)
    from annonet_tpu_torch.ops.augment import draw_augmentations

    draws = draw_augmentations(gen, len(rects), (dim, dim, 3), options)
    single = Trainer(config, TrainerConfig(), seed=0, device="cpu")
    dp = DataParallelTrainer(config, TrainerConfig(), seed=0,
                             mesh=ensure_virtual_devices(shards, "cpu"))
    loss_single = single.train_step_decisions(DeviceImagePool(4, device="cpu"), samples,
                                              rects, options, draws=draws)
    pool = DeviceImagePool(4, device="cpu", replicas=dp.pool_replicas)
    loss_dp = dp.train_step_decisions(pool, samples, rects, options, draws=draws)
    assert np.isclose(loss_single, loss_dp, rtol=1e-4)
    _close(dp, single)


def test_pool_replicas_hold_the_residents():
    """A pool with replicas keeps a copy on every other device through
    uploads and growth, and drops the home device from its replicas (the
    replica here is torch's meta device, which holds shapes only: the
    copies take the code path a second card takes)."""
    pool = DeviceImagePool(2, device="cpu", replicas=("cpu", "meta"))
    samples = _samples()
    pool.ensure(samples[:1])
    pool.ensure(samples)
    images, labels = pool.tensors("meta")
    assert images.shape == pool.images.shape and labels.shape == pool.labels.shape
    assert pool.tensors("cpu")[0] is pool.images
    assert pool.replicas == (torch.device("meta"),)


def test_draws_are_per_global_shard():
    """Two 'processes' of 2 shards each draw, shard for shard, what one
    process of 4 shards draws (the generators are keyed by global shard)."""
    options = CropOptions(dim=16, **AUGMENT)
    four = DataParallelTrainer(CONFIG, TrainerConfig(), seed=3,
                               mesh=ensure_virtual_devices(4, "cpu"))
    want = [four._shard_draws(3, g, 2, (16, 16, 3), options) for g in range(4)]
    got = []
    for rank in range(2):
        two = DataParallelTrainer(CONFIG, TrainerConfig(), seed=3,
                                  mesh=ensure_virtual_devices(2, "cpu"))
        two.reducer.rank, two.reducer.world = rank, 2
        got += [two._shard_draws(3, i, 2, (16, 16, 3), options) for i in range(2)]
    for a, b in zip(got, want):
        assert torch.equal(a.noise_u, b.noise_u) and torch.equal(a.flip_lr, b.flip_lr)
    assert not torch.equal(want[0].noise_u, want[1].noise_u)


def test_dp_sync_file_crosses_to_jax_and_back(tmp_path):
    """A sync file written by the port's DataParallelTrainer resumes in
    JAX's DataParallelTrainer, and the other way round: the single-device
    format, the same state."""
    images, labels = make_batch()
    path = tmp_path / "port.dat"
    port = DataParallelTrainer(CONFIG, TrainerConfig(sync_file=str(path)), seed=0,
                               mesh=ensure_virtual_devices(4, "cpu"))
    port.train_step_crops(images, labels, CropOptions(dim=16))
    port.save_sync_file()
    jt = JaxDataParallelTrainer(JaxSegNetConfig(**CONFIG.to_dict()),
                                JaxTrainerConfig(sync_file=str(path)), seed=5,
                                mesh=jax_make_mesh(8))
    assert jt.step_count == 1
    assert max(_errors(jt.params, port.params).values()) == 0.0
    jt.train_step_crops(images, labels, JaxCropOptions(dim=16))
    back = tmp_path / "jax.dat"
    jt.save_sync_file(str(back))
    resumed = DataParallelTrainer(CONFIG, TrainerConfig(sync_file=str(back)), seed=9,
                                  mesh=ensure_virtual_devices(2, "cpu"))
    assert resumed.step_count == 2
    assert max(_errors(resumed.params, jt.params).values()) == 0.0
    assert max(_errors(resumed.velocity, jt.velocity).values()) == 0.0
