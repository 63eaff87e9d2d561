"""The port's trainer state and loop bookkeeping (annonet_tpu_torch/train,
utils/metrics.py, TiledInferer.update_params) against the JAX package's,
on the CPU: the BN-momentum schedule and the plateau statistics equal;
the plateau shrink, the stop and the non-finite-loss error as
tests/test_trainer.py checks them; batched loss readback; sync files in
both directions (the same npz file: every tensor equal after a resume,
f32 next steps within 1e-4); the device image pool's LRU, growth and
telemetry; the metrics events; the weight swap of the inferer.
"""

import math

import numpy as np
import pytest
import torch

from annonet_tpu.models.segnet import SegNetConfig as JaxSegNetConfig
from annonet_tpu.train import plateau as jax_plateau
from annonet_tpu.train.trainer import Trainer as JaxTrainer
from annonet_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from annonet_tpu.train.trainer import bn_momentum_for_step as jax_bn_momentum
from annonet_tpu.utils.metrics import MetricsWriter as JaxMetricsWriter
from annonet_tpu_torch.classes import IGNORE_LABEL
from annonet_tpu_torch.infer.core import TiledInferer
from annonet_tpu_torch.models.segnet import (
    SegNetConfig,
    fold_batchnorm,
    init_runtime_params,
    tree_items,
    tree_to_numpy,
)
from annonet_tpu_torch.train import (
    DeviceImagePool,
    Trainer,
    TrainerConfig,
    bn_momentum_for_step,
    count_steps_without_decrease,
    count_steps_without_decrease_robust,
)
from annonet_tpu_torch.utils.metrics import MetricsWriter
from tests.test_torch_train_step import _errors, _numpy


def test_bn_momentum_schedule_and_plateau_match_jax():
    for step in range(0, 30, 3):
        for window in (1, 5, 200):
            assert bn_momentum_for_step(step, window) == jax_bn_momentum(step, window)
    rng = np.random.default_rng(0)
    for series in (np.linspace(2, 1, 50), 1 + rng.normal(0, 0.01, 80),
                   np.concatenate([np.linspace(3, 1, 40), 1 + rng.normal(0, 0.01, 40)]), []):
        assert (count_steps_without_decrease(series)
                == jax_plateau.count_steps_without_decrease(series))
        assert (count_steps_without_decrease_robust(series)
                == jax_plateau.count_steps_without_decrease_robust(series))


def test_learning_rate_shrinks_on_plateau_and_stops():
    config = SegNetConfig(class_count=2, level_count=1, base_width=4, compute_dtype="float32")
    tc = TrainerConfig(initial_learning_rate=0.1, iterations_without_progress_threshold=50,
                       previous_loss_values_dump_amount=10, min_learning_rate=0.05)
    trainer = Trainer(config, tc, device="cpu")
    events = []
    trainer.metrics_hook = events.append
    rng = np.random.default_rng(0)
    for v in 1.0 + rng.normal(0, 0.001, 60):
        trainer._record_loss(float(v))
    assert trainer.learning_rate == pytest.approx(0.1 * tc.learning_rate_shrink_factor)
    assert len(trainer.previous_loss_values) < 15 and trainer.should_stop
    shrinks = [e for e in events if e["event"] == "learning_rate_shrink"]
    assert len(shrinks) == 1 and shrinks[0]["learning_rate"] == trainer.learning_rate
    assert sum(e["event"] == "loss" for e in events) == 60


def test_non_finite_loss_raises():
    trainer = Trainer(SegNetConfig(class_count=2, level_count=0, base_width=4),
                      TrainerConfig(), device="cpu")
    with pytest.raises(RuntimeError, match="diverged"):
        trainer._record_loss(float("nan"))
    with pytest.raises(RuntimeError, match="diverged"):
        trainer._record_loss(math.inf)


def _toy_batch(n=4, dim=16, seed=0):
    rng = np.random.default_rng(seed)
    images = np.zeros((n, dim, dim, 3), np.uint8)
    images[:, :, dim // 2:] = 220
    images += rng.integers(0, 16, images.shape).astype(np.uint8)
    labels = np.zeros((n, dim, dim), np.uint16)
    labels[:, :, dim // 2:] = 1
    return images, labels, np.ones((n, dim, dim), np.float32)


def test_loss_sync_interval_batches_the_readback():
    config = SegNetConfig(class_count=2, level_count=1, base_width=4, compute_dtype="float32")
    images, labels, weights = _toy_batch()
    blocking = Trainer(config, TrainerConfig(), device="cpu")
    batched = Trainer(config, TrainerConfig(loss_sync_interval=3), device="cpu")
    want = [blocking.train_step(images, labels, weights) for _ in range(8)]
    got = [batched.train_step(images, labels, weights) for _ in range(8)]
    assert got == [None] * 8 and len(batched.previous_loss_values) == 3
    batched.flush_losses()
    assert batched.previous_loss_values == pytest.approx(want, rel=1e-6)
    assert want[-1] < want[0]  # it learns


def _small(sync=None):
    config = SegNetConfig(class_count=2, level_count=1, base_width=4, compute_dtype="float32")
    tc = dict(initial_learning_rate=0.1, iterations_without_progress_threshold=50,
              previous_loss_values_dump_amount=10, bn_stats_window=10, sync_file=sync)
    return config, tc


def test_sync_file_jax_writes_port_resumes(tmp_path):
    sync = str(tmp_path / "state.dat")
    config, tc = _small(sync)
    jt = JaxTrainer(JaxSegNetConfig(**config.to_dict()), JaxTrainerConfig(**tc), seed=0)
    images, labels, weights = _toy_batch()
    for _ in range(3):
        jt.train_step(images, labels, weights)
    jt.learning_rate = 0.025
    jt.save_sync_file()
    port = Trainer(config, TrainerConfig(**tc), seed=123, device="cpu")
    assert port.step_count == 3 and port.learning_rate == pytest.approx(0.025)
    assert port.previous_loss_values == pytest.approx(jt.previous_loss_values)
    for mine, theirs in ((port.params, jt.params), (port.bn_stats, jt.bn_stats),
                         (port.velocity, jt.velocity)):
        assert max(_errors(mine, theirs).values()) == 0.0
    # the next step agrees too (f32)
    want = jt.train_step(images, labels, weights)
    assert port.train_step(images, labels, weights) == pytest.approx(want, rel=1e-4)


def test_sync_file_port_writes_jax_resumes(tmp_path):
    sync = str(tmp_path / "state.dat")
    config, tc = _small(sync)
    port = Trainer(config, TrainerConfig(**tc), seed=0, device="cpu")
    images, labels, weights = _toy_batch()
    for _ in range(4):
        port.train_step(images, labels, weights)
    port.learning_rate = 0.03
    port.save_sync_file()
    jt = JaxTrainer(JaxSegNetConfig(**config.to_dict()), JaxTrainerConfig(**tc), seed=9)
    assert jt.step_count == 4 and jt.learning_rate == pytest.approx(0.03)
    for mine, theirs in ((port.params, jt.params), (port.bn_stats, jt.bn_stats),
                         (port.velocity, jt.velocity)):
        assert max(_errors(mine, theirs).values()) == 0.0
    from annonet_tpu import serialization as jax_serialization
    from annonet_tpu_torch import serialization

    meta = serialization.load_trainer_meta(sync)
    assert meta == jax_serialization.load_trainer_meta(sync)
    assert meta["weights_fingerprint"] == jax_serialization.weights_fingerprint(
        _numpy(jt.params))


def test_sync_file_config_mismatch_and_corruption_raise(tmp_path):
    sync = str(tmp_path / "state.dat")
    config, tc = _small(sync)
    Trainer(config, TrainerConfig(**tc), device="cpu").save_sync_file()
    other = SegNetConfig(class_count=3, level_count=1, base_width=4, compute_dtype="float32")
    with pytest.raises(RuntimeError, match="different model config"):
        Trainer(other, TrainerConfig(**tc), device="cpu")
    (tmp_path / "state.dat").write_bytes(b"not an npz")
    with pytest.raises(RuntimeError, match="unreadable or corrupt"):
        Trainer(config, TrainerConfig(**tc), device="cpu")


class FakeSample:
    def __init__(self, rng, h, w):
        self.input_image = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        self.label_image = rng.integers(0, 3, (h, w)).astype(np.uint16)
        self.label_image[0, 0] = IGNORE_LABEL


def test_pool_residency_lru_growth_and_telemetry():
    rng = np.random.default_rng(1)
    pool = DeviceImagePool(slots=2, device="cpu")
    a, b, c = (FakeSample(rng, 32, 32) for _ in range(3))
    idx = pool.ensure([a, b, a])
    assert pool.uploads == 2 and idx[0] == idx[2] != idx[1]
    assert pool.upload_bytes == 2 * (32 * 32 * 3 + 32 * 32 * 2)
    assert pool.labels.dtype == torch.int32
    assert int(pool.labels[idx[0], 0, 0]) == IGNORE_LABEL  # 0xFFFF survives
    pool.ensure([b, a])
    assert pool.uploads == 2  # hits
    pool.ensure([c])  # evicts one of the least recently used
    assert pool.uploads == 3 and id(c) in pool._by_id and len(pool._by_id) == 2
    big = FakeSample(rng, 300, 200)
    pool.ensure([big])
    assert pool.shape[1] == 512 and pool.shape[2] == 256  # 256-px buckets
    many = [FakeSample(rng, 32, 32) for _ in range(5)]
    idx = pool.ensure(many)
    assert pool.shape[0] == 8 and len(set(idx.tolist())) == 5  # powers of two
    hs, ws = pool.valid_dims(idx)
    assert (hs == 32).all() and (ws == 32).all()
    for s, slot in zip(many, idx):
        assert np.array_equal(pool.images[slot, :32, :32].numpy(), s.input_image)


def test_metrics_writer_writes_the_jax_events(tmp_path):
    import json

    records = []
    for name, cls in (("port", MetricsWriter), ("jax", JaxMetricsWriter)):
        writer = cls(str(tmp_path / f"{name}.jsonl"), interval=2)
        writer.event("start", seed=1)
        for step in range(1, 6):
            writer.hook({"event": "loss", "step": step, "loss": 1.0 / step,
                         "learning_rate": 0.1, "steps_without_progress": 0})
        writer.hook({"event": "learning_rate_shrink", "step": 5, "learning_rate": 0.01})
        writer.event("done", steps=5)
        writer.close()
        lines = [json.loads(x) for x in (tmp_path / f"{name}.jsonl").read_text().splitlines()]
        records.append([{k: v for k, v in r.items() if k not in ("time", "steps_per_second")}
                        for r in lines])
    assert records[0] == records[1]
    assert [r["event"] for r in records[0]] == ["start", "loss", "loss",
                                                "learning_rate_shrink", "done"]


def test_update_params_drops_what_the_old_weights_made():
    config = SegNetConfig(class_count=3, level_count=2, base_width=4)
    image = np.random.default_rng(0).integers(0, 256, (70, 90, 3), dtype=np.uint8)
    old, new = init_runtime_params(config, 0), init_runtime_params(config, 1)
    for quantize in (None, "int8"):
        inferer = TiledInferer(old, config, device="cpu", quantize=quantize)
        inferer.infer_arrays(image)
        if quantize:
            assert inferer._quantized and inferer.export_calibration() is not None
        inferer.update_params(new)
        assert not inferer._quantized and inferer.export_calibration() is None
        fresh = TiledInferer(new, config, device="cpu", quantize=quantize)
        assert np.array_equal(inferer.infer_arrays(image)[0], fresh.infer_arrays(image)[0])
    folded = TiledInferer(old, config, device="cpu", use_pallas_conv=True)
    folded.infer_arrays(image)
    assert folded._folded
    folded.update_params(new)
    assert not folded._folded
    preloaded = TiledInferer(old, config, device="cpu", quantize="int8",
                             calibration=[np.ones(n, np.float32) for n in
                                          TiledInferer(old, config, device="cpu",
                                                       quantize="int8")
                                          .calibration_layer_shapes()])
    preloaded.update_params(new)
    assert preloaded._preloaded_calib is None


def test_runtime_net_is_the_fold_of_the_state():
    config = SegNetConfig(class_count=2, level_count=1, base_width=4, compute_dtype="float32")
    trainer = Trainer(config, TrainerConfig(), device="cpu")
    images, labels, weights = _toy_batch()
    for _ in range(5):
        trainer.train_step(images, labels, weights)
    folded = trainer.runtime_net()
    again = fold_batchnorm(tree_to_numpy(trainer.params), tree_to_numpy(trainer.bn_stats),
                           config)
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(tree_items(folded),
                                                               tree_items(again)))
    labels_out = TiledInferer(folded, config, device="cpu").infer_arrays(images[0])[0]
    assert (labels_out == labels[0]).mean() > 0.9


def _tampered(tmp_path, edit):
    """A port-written sync file with its meta payload or members edited."""
    import io
    import json

    from annonet_tpu_torch import serialization

    config, tc = _small()
    good = str(tmp_path / "good.dat")
    Trainer(config, TrainerConfig(**tc), device="cpu").save_sync_file(good)
    with np.load(good) as z:
        arrays = {k: z[k] for k in z.files}
    payload = json.loads(bytes(arrays["__meta__"]).decode())
    edit(payload, arrays)
    arrays["__meta__"] = np.frombuffer(json.dumps(payload).encode(), np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    path = tmp_path / "bad.dat"
    path.write_bytes(buf.getvalue())
    return str(path), serialization


@pytest.mark.parametrize("edit", [
    lambda p, a: p["meta"].update(step_count=-1),
    lambda p, a: p["meta"].update(learning_rate="fast"),
    lambda p, a: p["meta"].update(previous_loss_values=[1.0, True]),
    lambda p, a: p.update(tree_names=["params"]),
    lambda p, a: p["meta"]["model_config"].update(level_count=99),
    lambda p, a: a.pop("velocity/head/b"),
    lambda p, a: a.update({"params/head/w": np.zeros((2, 2), np.float32)}),
])
def test_trainer_state_loader_rejects_what_jax_rejects(tmp_path, edit):
    from annonet_tpu import serialization as jax_serialization

    path, serialization = _tampered(tmp_path, edit)
    with pytest.raises(RuntimeError, match="not a valid annonet-tpu trainer state file"):
        serialization.load_trainer_state(path)
    with pytest.raises(RuntimeError, match="not a valid annonet-tpu trainer_state file"):
        jax_serialization.load_trainer_state(path)
