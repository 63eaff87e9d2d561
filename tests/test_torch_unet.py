"""The U-Net topology of the port (``SegNetConfig(topology="unet")``)
against its plain reference (``tests/reference_unet.py``) on the CPU, at
widths 8-128 over four levels, batch 2 of 64² crops, seeded random
weights: the training forward's logits, the loss, every leaf's gradient,
the running statistics after one step, the folded inference forward; the
receptive field against a brute-force probe; annonet_train into
annonet_infer; the benchmark's reference against this one; the paths that
refuse the U-Net; and the artifact's ``model_config``, which carries the
topology only where it is not the default.

Tolerances. The port and the reference compute the same float32 function
(``compute_dtype="float32"``, the configuration tested) in another order:
the port takes the batch variance as E[h^2] - E[h]^2, the reference as
E[(h - mean)^2], and the convolutions sum in another order. Measured at
these sizes: logits within 3.5e-6 of their largest magnitude, the loss
within 8e-8 relative, gradients within 4.9e-6 of each leaf's norm,
statistics within 4.2e-6. The limits, 1e-4 on logits, loss and folded
logits (relative to the largest magnitude), 1e-3 on each leaf's gradient
(relative to its norm: four levels of batch norm amplify the reordering)
and 1e-4 on the running statistics, leave 24 to 1250 times that room. The
port computing in bfloat16, the precision below the tested one, reads
0.054 on the logits, 0.81 on the gradients and 0.013 on the statistics,
each over 10 times its limit (checked by
``test_bfloat16_compute_fails_the_float32_tolerances``).
"""

import json
import os

import numpy as np
import pytest
import torch

from annonet_tpu import serialization as jax_serialization
from annonet_tpu_torch import serialization
from annonet_tpu_torch.cli import infer as infer_cli
from annonet_tpu_torch.cli import train as train_cli
from annonet_tpu_torch.cli.common import DEVICE_ENV
from annonet_tpu_torch.infer.core import TiledInferer
from annonet_tpu_torch.models.segnet import (
    RuntimeSegNet,
    SegNetConfig,
    apply_train,
    fold_batchnorm,
    init_state,
    required_input_dimension,
    train_state_from_numpy,
    tree_items,
)
from annonet_tpu_torch.ops.loss import weighted_pixel_cross_entropy
from tests import reference_unet as ref
from tests.test_end_to_end import write_synthetic_dataset

CONFIG = dict(class_count=3, level_count=4, width_scaler=1.0, min_filter_count=1,
              grayscale=False, base_width=8)
LOGITS_TOL = 1e-4
GRAD_TOL = 1e-3
STATS_TOL = 1e-4
MOMENTUM = 0.9


def _config(dtype="float32"):
    return SegNetConfig(**CONFIG, compute_dtype=dtype, topology="unet")


def _batch(seed=0, n=2, side=64):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (n, side, side, 3), dtype=np.uint8)
    labels = rng.integers(0, 4, (n, side, side)).astype(np.int64)  # 3 = ignored
    weights = rng.uniform(0.5, 2.0, (n, side, side)).astype(np.float32)
    return x, labels, weights


def _port_step(dtype="float32", seed=0):
    """The port's training forward, loss and gradients on one batch:
    (logits, loss, {leaf: grad}, new running stats), float64 numpy."""
    config = _config(dtype)
    params, stats = init_state(config, seed)
    p, s, _v = train_state_from_numpy(params, stats, None, "cpu")
    x, labels, weights = _batch(seed)
    logits, new_stats = apply_train(p, s, torch.from_numpy(x), config, bn_momentum=MOMENTUM)
    loss = weighted_pixel_cross_entropy(logits, torch.from_numpy(labels),
                                        torch.from_numpy(weights))
    names = [k for k, _ in tree_items(p)]
    grads = torch.autograd.grad(loss, [t for _, t in tree_items(p)])
    f64 = lambda t: t.detach().to(torch.float64).numpy()  # noqa: E731
    return (f64(logits), float(loss.detach()), {k: f64(g) for k, g in zip(names, grads)},
            {k: f64(t) for k, t in tree_items(new_stats)}, params, stats)


def _reference_step(params, stats, seed=0):
    x, labels, weights = _batch(seed)
    p = {k: torch.tensor(np.asarray(v), requires_grad=True) for k, v in tree_items(params)}
    running = {k: torch.tensor(np.asarray(v)) for k, v in tree_items(stats)}
    batch: dict = {}
    with ref.exact():
        logits = ref.train_forward(p, CONFIG, torch.from_numpy(x), batch)
        loss = ref.loss(logits, torch.from_numpy(labels), torch.from_numpy(weights))
        grads = torch.autograd.grad(loss, list(p.values()))
    f64 = lambda t: t.detach().to(torch.float64).numpy()  # noqa: E731
    new = ref.running_update(running, batch, MOMENTUM)
    return (f64(logits), float(loss.detach()), {k: f64(g) for k, g in zip(p, grads)},
            {k: f64(t) for k, t in new.items()})


def _readings(port, reference):
    """The largest relative disagreement of each compared quantity."""
    logits, loss, grads, stats = port[:4]
    r_logits, r_loss, r_grads, r_stats = reference
    return {
        "logits": np.abs(logits - r_logits).max() / np.abs(r_logits).max(),
        "loss": abs(loss - r_loss) / abs(r_loss),
        "grad": max(np.linalg.norm(grads[k] - r_grads[k]) / np.linalg.norm(r_grads[k])
                    for k in r_grads),
        "stats": max(np.abs(stats[k] - r_stats[k]).max() / max(np.abs(r_stats[k]).max(), 1e-6)
                     for k in r_stats),
    }


@pytest.fixture(scope="module")
def float32_step():
    port = _port_step()
    return port, _reference_step(port[4], port[5])


@pytest.mark.parametrize("what, tol", [("logits", LOGITS_TOL), ("loss", LOGITS_TOL),
                                       ("grad", GRAD_TOL), ("stats", STATS_TOL)])
def test_the_training_step_matches_the_reference(float32_step, what, tol):
    port, reference = float32_step
    assert set(port[2]) == set(reference[2])  # every leaf, the up layers' biases too
    assert set(port[3]) == set(reference[3])  # 18 batch norm layers' mean and var
    assert len(port[3]) == 2 * 18
    assert _readings(port, reference)[what] <= tol


def test_bfloat16_compute_fails_the_float32_tolerances():
    """The port computing in bfloat16, the precision below the tested one,
    against the same float32 reference: each of the logits', the
    gradients' and the statistics' readings lands far outside its limit."""
    port = _port_step("bfloat16")
    got = _readings(port, _reference_step(port[4], port[5]))
    assert got["logits"] > 10 * LOGITS_TOL and got["grad"] > 10 * GRAD_TOL, got
    assert got["stats"] > 10 * STATS_TOL, got


def test_the_folded_inference_forward_matches_the_reference():
    """fold_batchnorm of a net after one step, through RuntimeSegNet (K1,
    the pools, the no-ReLU K3 in their plain versions), against the
    reference's folded forward."""
    config = _config()
    params, stats = init_state(config, 3)
    p, s, _v = train_state_from_numpy(params, stats, None, "cpu")
    x, _labels, _w = _batch(3)
    _logits, new_stats = apply_train(p, s, torch.from_numpy(x), config, bn_momentum=0.0)
    net = RuntimeSegNet(fold_batchnorm(p, new_stats, config), config, device="cpu")
    image = _batch(4, n=1, side=96)[0]
    got = net(torch.from_numpy(image)).detach().numpy()
    refp = {k: torch.tensor(np.asarray(v)) for k, v in tree_items(params)}
    running = {k: t.detach() for k, t in tree_items(new_stats)}
    with ref.exact():
        want = ref.infer_forward(ref.fold(refp, running, CONFIG), CONFIG,
                                 torch.from_numpy(image)).numpy()
    assert np.abs(got - want).max() <= LOGITS_TOL * np.abs(want).max()


def test_the_receptive_field_matches_a_brute_force_probe():
    """Change one input pixel, see which outputs move: the widest span of
    moved output columns over the 16 column parities of the four levels
    is ``required_input_dimension`` (204 at four levels; 62 for annonet's
    three-level net). The probe net (float64) has positive weights and
    zero biases, and its base image normalises to exactly zero, so every
    activation of the base is 0 and a rise of one pixel reaches every
    value its receptive field holds as a positive number, which the ReLUs
    and the max pools pass."""
    cfg = dict(CONFIG, base_width=4)
    config = SegNetConfig(**cfg, compute_dtype="float32", topology="unet")
    params, _stats = init_state(config, 5)
    folded = {}
    for key, w in tree_items(params):
        if w.ndim == 4:
            folded["head" if key == "head/w" else key] = (
                torch.tensor(np.abs(w), dtype=torch.float64),
                torch.zeros(w.shape[3], dtype=torch.float64))
    side, height, centre = 512, 32, 256
    base = torch.full((1, height, side, 3), 127.5, dtype=torch.float64)
    probes = []
    for parity in range(16):
        x = base.clone()
        x[0, height // 2, centre + parity] += 50.0
        probes.append(x)
    out = ref.infer_forward(folded, cfg, torch.cat([base] + probes))
    assert not out[0].any()
    moved = out[1:].abs().amax(dim=(1, 3)) > 0  # [parity, column]
    spans = []
    for parity in range(16):
        cols = torch.nonzero(moved[parity])[:, 0]
        spans.append(int(cols.max() - cols.min() + 1))
    assert max(spans) == required_input_dimension(config) == 204
    assert required_input_dimension(SegNetConfig(level_count=3)) == 62


def test_the_benchmark_reference_is_this_reference():
    """perfbench/reference/unet.py (recomputing each unit) against this
    file: the same logits, batch statistics and gradients."""
    from perfbench.reference import unet as bench_ref

    config = _config()
    params, _stats = init_state(config, 7)
    x = torch.from_numpy(_batch(7)[0]).to(torch.float32)
    out = []
    for forward in (lambda p, s: ref.train_forward(p, CONFIG, x, s),
                    lambda p, s: bench_ref.train_forward(p, CONFIG, x, None, s, recompute=True)):
        p = {k: torch.tensor(np.asarray(v), requires_grad=True) for k, v in tree_items(params)}
        stats: dict = {}
        with ref.exact():
            logits = forward(p, stats)
            grads = torch.autograd.grad(logits.square().mean(), list(p.values()))
        out.append((logits.detach(), {k: v.detach() for k, v in stats.items()}, grads))
    (a, sa, ga), (b, sb, gb) = out
    assert torch.allclose(a, b, rtol=0, atol=1e-6 * a.abs().max())
    assert sa.keys() == sb.keys() and all(torch.allclose(sa[k], sb[k]) for k in sa)
    assert all(torch.allclose(g, h, rtol=1e-5, atol=1e-7) for g, h in zip(ga, gb))


@pytest.fixture
def cpu_env(monkeypatch):
    monkeypatch.setenv(DEVICE_ENV, "cpu")


def test_annonet_train_into_annonet_infer(tmp_path, cpu_env, capsys):
    """annonet_train --topology unet writes an artifact that carries the
    topology, which annonet_infer of the port runs and the JAX package
    refuses."""
    data = tmp_path / "data"
    data.mkdir()
    write_synthetic_dataset(data, n_images=2, size=48)
    model = tmp_path / "unet.dnn"
    rc = train_cli.main([str(data), "--topology", "unet", "--level-count", "2",
                         "--net-width-scaler", "0.5", "-b", "2", "--max-total-steps", "2",
                         "--data-loader-thread-count", "1", "--deterministic-data",
                         "--output", str(model), "--sync-file", str(tmp_path / "s.dat")])
    assert rc == 0, capsys.readouterr().out
    _params, config, _classes, _f = serialization.load_model(str(model))
    assert config.unet and config.to_dict()["topology"] == "unet"
    with pytest.raises(Exception):
        jax_serialization.load_model(str(model))
    rc = infer_cli.main([str(data), "--model", str(model)])
    assert rc == 0, capsys.readouterr().out
    results = sorted(p for p in os.listdir(data) if p.endswith("_result.png"))
    assert len(results) == 2


def test_the_default_topology_leaves_the_artifact_as_it_was(tmp_path):
    """With the topology at its default, the artifact's model_config is the
    JAX package's, byte for byte, and reads into it."""
    config = SegNetConfig(class_count=3, level_count=1, base_width=4)
    assert "topology" not in config.to_dict()
    from annonet_tpu_torch.models.segnet import init_runtime_params

    path = str(tmp_path / "net.dnn")
    serialization.save_model(path, init_runtime_params(config, 0), config, "[]", 1.0)
    meta = json.loads(bytes(np.load(path)["__meta__"]).decode())
    assert json.dumps(meta["model_config"]) == json.dumps(
        {"class_count": 3, "level_count": 1, "width_scaler": 1.0, "min_filter_count": 1,
         "grayscale": False, "base_width": 4, "compute_dtype": "bfloat16"})
    assert jax_serialization.load_model(path)[1].level_count == 1


def _refuse_int8_inference(config):
    TiledInferer({}, config, device="cpu", quantize="int8")


def _refuse_int8_training(config):
    from annonet_tpu_torch.train import Trainer, TrainerConfig

    Trainer(config, TrainerConfig(int8_forward=True), device="cpu")


def _refuse_folded_runtime(config):
    from annonet_tpu_torch.models.folded_runtime import FoldedSegNet

    FoldedSegNet({}, config, 2, device="cpu")


def _refuse_pallas_conv(config):
    TiledInferer({}, config, device="cpu", use_pallas_conv=True)


@pytest.mark.parametrize("path", [_refuse_int8_inference, _refuse_int8_training,
                                  _refuse_folded_runtime, _refuse_pallas_conv])
def test_paths_without_the_unet_refuse_it(path):
    with pytest.raises(ValueError, match="SegNet topology only"):
        path(_config("bfloat16"))


def test_annonet_train_refuses_int8_training_of_the_unet(tmp_path, cpu_env, capsys):
    data = tmp_path / "data"
    data.mkdir()
    write_synthetic_dataset(data, n_images=1, size=48)
    rc = train_cli.main([str(data), "--topology", "unet", "--level-count", "1",
                         "--int8-training", "--max-total-steps", "1",
                         "--output", str(tmp_path / "m.dnn"), "--sync-file",
                         str(tmp_path / "s.dat")])
    assert rc == 1 and "SegNet topology only" in capsys.readouterr().out


def test_the_training_forward_names_its_pools_and_units():
    """Under a profiler on the CPU, one U-Net forward opens a ``pool``
    range a level (4) and a ``bn`` range a unit (18); annonet's
    three-level net none and 14."""
    from torch.profiler import ProfilerActivity, profile

    counts = []
    for config in (_config(), SegNetConfig(class_count=3, level_count=3, base_width=8,
                                           compute_dtype="float32")):
        params, stats = init_state(config, 0)
        p, s, _v = train_state_from_numpy(params, stats, None, "cpu")
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            apply_train(p, s, torch.from_numpy(_batch()[0]), config)
        names = [e.name for e in prof.events()]
        counts.append((names.count("pool"), names.count("bn")))
    assert counts == [(4, 18), (0, 14)]
