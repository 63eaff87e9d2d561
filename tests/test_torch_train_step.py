"""The port's train step (annonet_tpu_torch/train/trainer.py: the pool
step, the crop step, the augmentation generator) against the JAX
package's, on the CPU.

One pool step from JAX's state with JAX's own augmentation draws (split
from the key JAX's Trainer carries): in f32 the loss, the updated
parameters, the velocity and the BN statistics agree within 1e-4 of each
tensor's scale. In bf16 the loss and the statistics agree within 5e-2 and
the parameters within 5e-2 of each tensor's scale; the velocity (the
gradient itself) is as noisy as bf16 backward arithmetic makes it in
either framework, so it is held to the f32 step instead: on average over
the tensors the port's bf16 velocity is no further from its f32 velocity
than JAX's bf16 velocity is from JAX's. Over five steps (no augmentation)
the same holds for the BN-folded runtime net: in f32 within 1e-4 of each
tensor's scale; in bf16 the port's net stays within 5e-2 of its f32 net,
tensor by tensor, while JAX's own bf16 net may move much further from its
f32 net (up to 0.72 of a folded bias's scale at this size: the CPU backend
sums bf16 gradients in bf16).
"""

import jax
import numpy as np
import torch

from annonet_tpu.data.crop import CropOptions as JaxCropOptions
from annonet_tpu.models.segnet import SegNetConfig as JaxSegNetConfig
from annonet_tpu.train.device_cache import DeviceImagePool as JaxDeviceImagePool
from annonet_tpu.train.trainer import Trainer as JaxTrainer
from annonet_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from annonet_tpu_torch.classes import IGNORE_LABEL
from annonet_tpu_torch.data.crop import CropOptions
from annonet_tpu_torch.data.sample import Sample
from annonet_tpu_torch.infer.core import TiledInferer
from annonet_tpu_torch.models.segnet import SegNetConfig, train_state_from_numpy, tree_items
from annonet_tpu_torch.train import DeviceImagePool, Trainer, TrainerConfig
from tests.test_torch_train_ops import _jax_draws

AUGMENT = dict(allow_flip_left_right=True, allow_flip_upside_down=True,
               multiplicative_brightness_change_probability=0.5,
               noise_level_stddev=2.0, allow_random_color_offset=True)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _samples(seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for h, w in [(70, 90), (50, 40)]:
        labels = rng.integers(0, 3, (h, w)).astype(np.uint16)
        labels[:4] = IGNORE_LABEL
        out.append(Sample(input_image=rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                          label_image=labels))
    return out


def _decisions(samples, dim):
    corners = [(-5, -3), (50, 40), (10, 10), (20, -10)]
    rects = [(x, y, x + dim - 1, y + dim - 1) for x, y in corners]
    return [samples[0], samples[1], samples[0], samples[1]], rects


def _pool_step(compute_dtype, dim=32):
    """One JAX pool step and the port's from the same state and draws:
    (jax trainer, port trainer, jax loss, port loss)."""
    config = SegNetConfig(class_count=3, level_count=2, base_width=8,
                          compute_dtype=compute_dtype)
    jt = JaxTrainer(JaxSegNetConfig(**config.to_dict()), JaxTrainerConfig(), seed=0)
    port = Trainer(config, TrainerConfig(), seed=0, device="cpu")
    port.params, port.bn_stats, port.velocity = train_state_from_numpy(
        _numpy(jt.params), _numpy(jt.bn_stats), _numpy(jt.velocity), "cpu")
    samples, rects = _decisions(_samples(), dim)
    jax_loss = jt.train_step_decisions(JaxDeviceImagePool(4), samples, rects,
                                       JaxCropOptions(dim=dim, **AUGMENT))
    # JAX's Trainer: carry = PRNGKey(seed ^ 0x5EED); each step splits off its key
    _carry, step_key = jax.random.split(jax.random.PRNGKey(0 ^ 0x5EED))
    loss = port.train_step_decisions(DeviceImagePool(4, device="cpu"), samples, rects,
                                     CropOptions(dim=dim, **AUGMENT),
                                     draws=_jax_draws(step_key, len(rects), (dim, dim, 3)))
    return jt, port, jax_loss, loss


def _leaves(tree):
    return {k: v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in tree_items(tree)}


def _errors(mine, theirs):
    """{leaf: max |mine - theirs| / max |theirs|} of two trees (tensors,
    numpy or JAX arrays)."""
    ref = _leaves(theirs)
    return {k: float(np.abs(v - ref[k]).max() / max(np.abs(ref[k]).max(), 1e-12))
            for k, v in _leaves(mine).items()}


def test_pool_step_from_jax_state_f32():
    jt, port, jax_loss, loss = _pool_step("float32")
    assert abs(loss - jax_loss) <= 1e-4 * abs(jax_loss)
    for mine, theirs in ((port.params, jt.params), (port.velocity, jt.velocity),
                         (port.bn_stats, jt.bn_stats)):
        errors = _errors(mine, theirs)
        assert max(errors.values()) < 1e-4, max(errors.items(), key=lambda kv: kv[1])
    assert port.step_count == jt.step_count == 1


def test_pool_step_from_jax_state_bf16():
    jt, port, jax_loss, loss = _pool_step("bfloat16")
    jt32, port32, _l, _l32 = _pool_step("float32")
    assert abs(loss - jax_loss) <= 5e-2 * abs(jax_loss)
    assert max(_errors(port.bn_stats, jt.bn_stats).values()) < 5e-2
    # the parameters that start at 0 (BN betas, the head's bias) are one
    # velocity after one step: they are held with the velocity below
    started = dict(tree_items(_numpy(JaxTrainer(
        JaxSegNetConfig(**port.model_config.to_dict()), JaxTrainerConfig(), seed=0).params)))
    errors = _errors(port.params, jt.params)
    assert max(e for k, e in errors.items() if np.abs(started[k]).max() > 0) < 5e-2
    # the velocity is one step's gradient: bf16 moves every tensor of it
    # away from the f32 step by more than f32 rounding would (measured 4e-3
    # at the least, against 1.2e-5 between the two packages' f32 steps), and
    # on average by as much as JAX's bf16 step does, within a factor of 4
    # (measured 0.153 against JAX's 0.201; JAX's CPU backend is the noisier)
    port_noise = _errors(port.velocity, port32.velocity)
    jax_noise = np.mean(list(_errors(jt.velocity, jt32.velocity).values()))
    assert min(port_noise.values()) > 1e-3, port_noise
    assert jax_noise / 4 <= np.mean(list(port_noise.values())) <= jax_noise, jax_noise


def test_decisions_equal_crops_with_the_same_draws():
    config = SegNetConfig(class_count=3, level_count=1, base_width=4)
    dim = 24
    samples, rects = _decisions(_samples(1), dim)
    options = CropOptions(dim=dim, **AUGMENT)
    gen = torch.Generator()
    gen.manual_seed(3)
    from annonet_tpu_torch.data.crop import extract_crop
    from annonet_tpu_torch.ops.augment import draw_augmentations

    draws = draw_augmentations(gen, len(rects), (dim, dim, 3), options)
    crops = [extract_crop(s.input_image, s.label_image, r) for s, r in zip(samples, rects)]
    images = np.stack([c[0] for c in crops])
    labels = np.stack([c[1] for c in crops])
    a = Trainer(config, TrainerConfig(), seed=2, device="cpu")
    b = Trainer(config, TrainerConfig(), seed=2, device="cpu")
    la = a.train_step_decisions(DeviceImagePool(2, device="cpu"), samples, rects, options,
                                draws=draws)
    lb = b.train_step_crops(images, labels, options, draws=draws)
    assert la == lb
    for (k, x), (_k, y) in zip(tree_items(a.params), tree_items(b.params)):
        assert torch.equal(x, y), k


def test_generator_stream_is_seeded_and_shared():
    config = SegNetConfig(class_count=3, level_count=1, base_width=4)
    samples, rects = _decisions(_samples(2), 16)
    options = CropOptions(dim=16, **AUGMENT)
    runs = []
    for seed in (5, 5, 6):
        t = Trainer(config, TrainerConfig(), seed=0, device="cpu")
        pool = DeviceImagePool(2, device="cpu")
        runs.append([t.train_step_decisions(pool, samples, rects, options, seed=seed)
                     for _ in range(2)])
    assert runs[0] == runs[1] and runs[0] != runs[2]
    gen = Trainer(config, TrainerConfig(), device="cpu").augmentation_generator(7)
    assert gen.initial_seed() == 7 ^ 0x5EED


def test_five_steps_runtime_net_against_the_f32_steps():
    rng = np.random.default_rng(0)
    n, d = 4, 42
    images = rng.integers(0, 256, (n, d, d, 3), dtype=np.uint8)
    images[:, :, d // 2:, 0] = 250
    labels = np.zeros((n, d, d), np.uint16)
    labels[:, :, d // 2:] = 1
    weights = np.ones((n, d, d), np.float32)
    nets = {}
    for dtype in ("float32", "bfloat16"):
        config = SegNetConfig(class_count=2, level_count=1, width_scaler=0.5,
                              compute_dtype=dtype)
        jt = JaxTrainer(JaxSegNetConfig(**config.to_dict()), JaxTrainerConfig(), seed=0)
        port = Trainer(config, TrainerConfig(), device="cpu")
        port.params, port.bn_stats, port.velocity = train_state_from_numpy(
            _numpy(jt.params), _numpy(jt.bn_stats), _numpy(jt.velocity), "cpu")
        for _ in range(5):
            jt.train_step(images, labels, weights)
            port.train_step(images, labels, weights)
        nets[dtype] = (jt.runtime_net(), port.runtime_net())
    (jax32, port32), (jax16, port16) = nets["float32"], nets["bfloat16"]
    assert max(_errors(port32, jax32).values()) < 1e-4
    port_drift = _errors(port16, port32)
    assert max(port_drift.values()) < 5e-2, port_drift
    assert np.mean(list(port_drift.values())) <= np.mean(list(_errors(jax16, jax32).values()))
    image = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    image[20:40, 10:30, 0] = 250
    config = SegNetConfig(class_count=2, level_count=1, width_scaler=0.5)
    labels = {name: TiledInferer(net, config, device="cpu").infer_arrays(image)[0]
              for name, net in (("port32", port32), ("jax32", _numpy(jax32)),
                                ("port16", port16))}
    assert (labels["port32"] == labels["jax32"]).mean() >= 0.999
    assert (labels["port16"] == labels["port32"]).mean() >= 0.99
