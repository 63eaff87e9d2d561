"""The net's layer plan (``models/segnet.py`` ``layer_plan``) against the
functions that walk it, for both topologies at every depth the tests run:
the runtime forward's taps, the parameter and state trees, and the order of
the training forward's units. A walker that departs from the plan (a conv
skipped, reordered or given another width) fails here."""

import numpy as np
import pytest
import torch

from annonet_tpu_torch.models import segnet
from annonet_tpu_torch.ops import bn_relu as op

CASES = [("segnet", level) for level in range(4)] + [("unet", level) for level in range(1, 5)]


def _config(topology, level_count):
    return segnet.SegNetConfig(class_count=3, level_count=level_count, base_width=4,
                               compute_dtype="float32", topology=topology)


def _images(config, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (2, 16, 16, config.in_channels),
                                         dtype=np.uint8))


@pytest.mark.parametrize("topology,level_count", CASES)
def test_every_walker_follows_the_plan(monkeypatch, topology, level_count):
    config = _config(topology, level_count)
    plan = segnet.layer_plan(config)
    assert segnet.layer_plan(config) is plan  # built once per config
    layers = list(segnet.conv_layers(config))
    assert layers == [(s.block, s.conv, s.shape) for s in plan
                      if s.op in (segnet.UNIT, segnet.LINEAR_UP)]

    # the runtime forward taps every conv in the plan's order, at its width
    runtime = segnet.init_runtime_params(config, seed=1)
    taps = []
    with torch.no_grad():
        logits = segnet.RuntimeSegNet(runtime, config, device="cpu")(
            _images(config), tap=lambda name, x: taps.append((name, x.shape[-1])))
    assert taps == [(f"{block}/{conv}", shape[-1]) for block, conv, shape in layers]
    assert tuple(logits.shape) == (2, 16, 16, config.class_count)

    # the shape tables are the leaves the initializers and the fold make
    params, stats = segnet.init_state(config, seed=2)
    shapes = segnet.train_state_shapes(config)
    assert shapes["params"] == {k: v.shape for k, v in segnet.tree_items(params)}
    assert shapes["bn_stats"] == {k: v.shape for k, v in segnet.tree_items(stats)}
    folded = segnet.fold_batchnorm(params, stats, config)
    want = segnet.runtime_param_shapes(config)
    assert want == {k: v.shape for k, v in segnet.tree_items(folded)}
    assert want == {k: v.shape for k, v in segnet.tree_items(runtime)}

    # the training forward runs its units in the plan's order
    p, s, _ = segnet.train_state_from_numpy(params, stats, None, "cpu")
    names = {id(leaf): key.rsplit("/", 1)[0] for key, leaf in segnet.tree_items(p)
             if key.endswith("/gamma")}
    units = []
    real = op.bn_relu

    def recording(h, gamma, beta):
        units.append(names[id(gamma)])
        return real(h, gamma, beta)

    monkeypatch.setattr(op, "bn_relu", recording)
    with torch.no_grad():
        train_logits, _ = segnet.apply_train(p, s, _images(config), config)
    assert units == [f"{step.block}/{step.bn}" for step in plan if step.op == segnet.UNIT]
    assert train_logits.shape == logits.shape
