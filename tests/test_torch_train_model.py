"""The port's training net (annonet_tpu_torch/models/segnet.py: init_state,
apply_train, fold_batchnorm) against the JAX package's, on the CPU.

Both start from the JAX ``init_state`` tree (carried across as numpy by
``train_state_from_numpy``). Tolerances: f32 logits, running statistics
and gradients within 1e-4 of each tensor's scale (the same products summed
in another order); bf16 logits and statistics within 5e-2 of scale (each
framework's CPU bf16 conv rounds in its own order); the fold within one
f32 ulp (the same five IEEE operations per element).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from annonet_tpu.models import segnet as jax_segnet
from annonet_tpu.ops.loss import weighted_pixel_cross_entropy as jax_loss
from annonet_tpu_torch.models.segnet import (
    SegNetConfig,
    apply_train,
    fold_batchnorm,
    init_state,
    recommended_input_dimension,
    train_state_from_numpy,
    train_state_shapes,
    tree_items,
    tree_map,
    tree_to_numpy,
)
from annonet_tpu_torch.ops.loss import weighted_pixel_cross_entropy

F32_TOL = 1e-4
BF16_TOL = 5e-2


def jax_state(config: SegNetConfig, seed: int = 0, perturb: bool = False):
    """JAX init_state as numpy trees; ``perturb`` draws gamma, beta and the
    running statistics away from their identity values."""
    params, stats = jax_segnet.init_state(
        jax.random.PRNGKey(seed), jax_segnet.SegNetConfig(**config.to_dict()))
    params, stats = (jax.tree_util.tree_map(np.array, t) for t in (params, stats))
    if perturb:
        rng = np.random.default_rng(seed)
        for tree in (params, stats):
            for path, leaf in tree_items(tree):
                name = path.rsplit("/", 1)[-1]
                if name in ("gamma", "var"):
                    leaf[...] = rng.uniform(0.5, 1.5, leaf.shape)
                elif name in ("beta", "mean"):
                    leaf[...] = rng.normal(0.0, 0.1, leaf.shape)
    return params, stats


def _flat(tree):
    return {k: np.asarray(v) for k, v in tree_items(jax.tree_util.tree_map(np.asarray, tree))}


def _batch(config, seed, n=2, side=None):
    side = side or recommended_input_dimension(config, 24)
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, side, side, config.in_channels), dtype=np.uint8)
    labels = rng.integers(0, config.class_count, (n, side, side)).astype(np.int32)
    labels[:, :3] = 65535  # some ignored pixels
    weights = rng.uniform(0.2, 2.0, (n, side, side)).astype(np.float32)
    return images, labels, weights


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / max(np.abs(b).max(), 1e-12))


def test_init_state_has_the_jax_tree():
    config = SegNetConfig(class_count=4, level_count=2, base_width=8)
    jp, js = jax_state(config)
    params, stats = init_state(config, seed=3)
    for mine, theirs in ((params, jp), (stats, js)):
        a, b = dict(tree_items(mine)), _flat(theirs)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype == np.float32, k
    shapes = train_state_shapes(config)
    assert shapes["params"] == {k: v.shape for k, v in tree_items(params)}
    assert shapes["bn_stats"] == {k: v.shape for k, v in tree_items(stats)}
    p = dict(tree_items(params))
    assert all((p[k] == 1).all() for k in p if k.endswith("gamma"))
    assert all((p[k] == 0).all() for k in p if k.endswith(("beta", "head/b")))
    s = dict(tree_items(stats))
    assert all((s[k] == (1 if k.endswith("var") else 0)).all() for k in s)
    # He-normal: std sqrt(2 / fan_in), from the seed
    w = p["enc2/conv1"]
    assert abs(w.std() / (2.0 / (9 * w.shape[2])) ** 0.5 - 1.0) < 0.05
    again, _ = init_state(config, seed=3)
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(tree_items(params),
                                                               tree_items(again)))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("level_count,grayscale",
                         [(0, False), (1, False), (2, False), (2, True), (3, False)])
def test_apply_train_matches_jax(level_count, grayscale, compute_dtype):
    config = SegNetConfig(class_count=3, level_count=level_count, grayscale=grayscale,
                          base_width=8, compute_dtype=compute_dtype)
    jcfg = jax_segnet.SegNetConfig(**config.to_dict())
    params, stats = jax_state(config, seed=level_count, perturb=True)
    images, _labels, _w = _batch(config, seed=1)
    logits_j, stats_j = jax.jit(jax_segnet.apply_train, static_argnums=(3,))(
        params, stats, jnp.asarray(images), jcfg, 0.9)
    p, s, _v = train_state_from_numpy(params, stats, None, "cpu")
    with torch.no_grad():
        logits, new_stats = apply_train(p, s, torch.from_numpy(images), config, bn_momentum=0.9)
    tol = F32_TOL if compute_dtype == "float32" else BF16_TOL
    assert logits.dtype == torch.float32 and tuple(logits.shape) == logits_j.shape
    assert _rel(logits.numpy(), logits_j) < tol
    theirs = _flat(stats_j)
    for k, v in tree_items(tree_to_numpy(new_stats)):
        assert _rel(v, theirs[k]) < tol, k


def test_gradients_match_jax_grad():
    config = SegNetConfig(class_count=3, level_count=2, base_width=8, compute_dtype="float32")
    jcfg = jax_segnet.SegNetConfig(**config.to_dict())
    params, stats = jax_state(config, seed=5, perturb=True)
    images, labels, weights = _batch(config, seed=2)

    def loss_j(p):
        logits, _ = jax_segnet.apply_train(p, stats, jnp.asarray(images), jcfg)
        return jax_loss(logits, jnp.asarray(labels), jnp.asarray(weights))

    loss_value_j, grads_j = jax.jit(jax.value_and_grad(loss_j))(params)
    p, s, _v = train_state_from_numpy(params, stats, None, "cpu")
    logits, _ = apply_train(p, s, torch.from_numpy(images), config)
    loss = weighted_pixel_cross_entropy(logits, torch.from_numpy(labels),
                                        torch.from_numpy(weights))
    names = [k for k, _ in tree_items(p)]
    grads = torch.autograd.grad(loss, [t for _, t in tree_items(p)])
    assert abs(loss.item() - float(loss_value_j)) < F32_TOL * abs(float(loss_value_j))
    theirs = _flat(grads_j)
    for name, g in zip(names, grads):
        assert _rel(g.numpy(), theirs[name]) < F32_TOL, name


def test_remat_gives_the_same_loss_and_gradients():
    config = SegNetConfig(class_count=3, level_count=2, base_width=8, compute_dtype="float32")
    params, stats = jax_state(config, seed=7, perturb=True)
    images, labels, weights = _batch(config, seed=3)
    out = []
    for remat in (False, True):
        p, s, _v = train_state_from_numpy(params, stats, None, "cpu")
        logits, new_stats = apply_train(p, s, torch.from_numpy(images), config, remat=remat)
        loss = weighted_pixel_cross_entropy(logits, torch.from_numpy(labels),
                                            torch.from_numpy(weights))
        grads = torch.autograd.grad(loss, [t for _, t in tree_items(p)])
        out.append((loss.item(), [g.numpy() for g in grads],
                    [v.numpy() for _, v in tree_items(new_stats)]))
    assert out[0][0] == out[1][0]
    assert all(np.array_equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    assert all(np.array_equal(a, b) for a, b in zip(out[0][2], out[1][2]))


@pytest.mark.parametrize("level_count", [0, 2])
def test_fold_batchnorm_within_one_ulp(level_count):
    config = SegNetConfig(class_count=3, level_count=level_count, base_width=8)
    params, stats = jax_state(config, seed=11, perturb=True)
    folded_j = _flat(jax_segnet.fold_batchnorm(params, stats,
                                               jax_segnet.SegNetConfig(**config.to_dict())))
    p, s, _v = train_state_from_numpy(params, stats, None, "cpu")
    for source in ((p, s), (params, stats)):  # tensors or numpy leaves
        folded = dict(tree_items(fold_batchnorm(*source, config)))
        assert sorted(folded) == sorted(folded_j)
        for k, v in folded.items():
            assert v.dtype == np.float32
            ulp = np.spacing(np.abs(folded_j[k]).astype(np.float32))
            assert (np.abs(v - folded_j[k]) <= ulp).all(), k


def test_train_state_from_numpy_round_trip():
    config = SegNetConfig(class_count=2, level_count=1, base_width=4)
    params, stats = init_state(config, seed=0)
    velocity = tree_map(lambda a: a * 0.5 + 0.25, params)
    p, s, v = train_state_from_numpy(params, stats, velocity, "cpu")
    assert all(t.requires_grad for _, t in tree_items(p))
    assert not any(t.requires_grad for _, t in tree_items(v))
    for tree, mine in ((params, p), (stats, s), (velocity, v)):
        back = dict(tree_items(tree_to_numpy(mine)))
        for k, a in tree_items(tree):
            assert np.array_equal(back[k], a)
    _p, _s, zeros = train_state_from_numpy(params, stats, None, "cpu")
    assert all((t == 0).all() for _, t in tree_items(zeros))
