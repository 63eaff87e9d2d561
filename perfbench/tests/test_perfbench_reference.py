"""The plain reference against the port on the CPU at a small size, the
comparison against runs with the timed path broken underneath, and the
control against the program.

The port is imported here, in the tests only: the reference itself imports
nothing of it. Where a test runs the float32 twin of the configuration,
the port and the reference compute the same function in the same
precision, so a sound run reads (nearly) nothing and a fault stands out
against the cell's own limits."""

import dataclasses

import numpy as np
import pytest
import torch

from perfbench import control, run
from perfbench.lib import manifest, scenes, weights
from perfbench.reference import compare

CELL = "l3rgb.train_b128"
SMALL = dict(pool_images=3, image_side=96, batch=8, crop=64, planned_steps=6, warmup_steps=1)


def _bench(dtype="float32"):
    bench = manifest.load()
    mix, config = bench.mix, bench.config
    bench.mix = lambda t: dict(mix(t), **SMALL)
    bench.config = lambda n: dict(config(n), compute_dtype=dtype)
    return bench


def test_a_sound_float32_run_agrees_with_the_reference():
    r = run.run_cell(_bench(), CELL, 2**31 + 11, 0.3, False, torch.device("cpu"))
    assert r["correct"] and r["failed"] == 0, r["checks"]
    for name, c in r["checks"].items():
        # same function, same precision: to round-off
        assert c["value"] <= 1e-2, (name, c)


def _unchanged_state(monkeypatch):
    from annonet_tpu_torch.train import trainer

    monkeypatch.setattr(trainer, "_sgd", lambda *args, **kwargs: None)


def _half_batch(monkeypatch):
    from annonet_tpu_torch.train.trainer import Trainer

    original = Trainer.train_step_decisions

    def half(self, pool, samples, rects, options, seed=0, draws=None):
        b = len(samples) // 2
        cut = type(draws)(**{f.name: None if getattr(draws, f.name) is None
                             else getattr(draws, f.name)[:b] for f in dataclasses.fields(draws)})
        return original(self, pool, samples[:b], rects[:b], options, seed, cut)

    monkeypatch.setattr(Trainer, "train_step_decisions", half)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch])
def test_a_broken_timed_path_comes_out_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    r = run.run_cell(_bench(), CELL, 2**31 + 12, 0.3, False, torch.device("cpu"))
    assert not r["correct"] and r["failed"] == 1, r["checks"]


def test_the_seed_makes_the_inputs():
    config = manifest.load().config("segnet_l3_rgb")
    a = weights.train_tree(torch.Generator().manual_seed(2**31 + 9), config)
    b = weights.train_tree(torch.Generator().manual_seed(2**31 + 9), config)
    c = weights.train_tree(torch.Generator().manual_seed(2**31 + 10), config)
    np.testing.assert_array_equal(a["stem/conv0"], b["stem/conv0"])
    assert not np.array_equal(a["stem/conv0"], c["stem/conv0"])
    images, labels = scenes.make_scenes(torch.Generator().manual_seed(1), 1, 512, 512, 3)
    assert images.dtype == np.uint8 and labels.dtype == np.uint16
    assert set(np.unique(labels)) <= {0, 1, 2} and (labels > 0).any()


def _record(grad, losses, var=1.0):
    """A side's record with ``grad`` as its first gradient (lr 1, no
    decay on 1-D leaves) and as its change."""
    stats = {"stem/bn0/mean": np.zeros(2), "stem/bn0/var": np.full(2, var)}
    return {"losses": losses, "velocity1": {k: -g for k, g in grad.items()},
            "params3": dict(grad), "stats1": stats}


_HP = {"learning_rate": 1.0, "weight_decay": 0.0}


def test_numbers_of_a_known_disagreement():
    """A sign flipped in half of a leaf keeps its norm (gap 0) and differs
    by the square root of twice it (diff 2 ** 0.5); the other leaves agree;
    a batch variance off by its own size reads 1."""
    ref = {"a": np.ones(4), "head/w": np.full(4, 2.0), "c": np.full(4, 3.0)}
    mine = dict(ref, **{"head/w": np.array([2.0, 2.0, -2.0, -2.0])})
    zeros = {k: np.zeros(4) for k in ref}
    got = compare.train_numbers(_record(mine, [1.0, 1.0, 1.0], 2.0),
                                _record(ref, [1.0, 1.0, 2.0]), zeros, _HP)
    assert got["grad_gap"] == 0 and got["grad_diff"] == pytest.approx(2 ** 0.5)
    assert got["head_grad_diff"] == got["grad_diff"] and got["bn_median_var_gap"] == 1
    assert got["grad_median_diff"] == 0 and got["loss_gap"] == 0.5 and got["loss1_gap"] == 0
    assert not compare.passed(compare.held(got, {"grad_diff": 0.5}))
    assert not compare.passed(compare.held({}, {"grad_diff": 0.5}))


def test_a_negligible_leaf_counts_in_no_number():
    ref = {"a": np.ones(4), "head/b": np.full(4, 2.0), "c": np.full(4, 1e-6)}
    mine = dict(ref, c=np.full(4, 1.0))
    zeros = {k: np.zeros(4) for k in ref}
    leaves = compare.leaf_readings(_record(mine, [1.0]), _record(ref, [1.0]), zeros, _HP)
    assert set(leaves) == {"a", "head/b"}


def _readings(mode, seeds, device, dtype, mix_changes):
    bench = _bench(dtype) if mix_changes else manifest.load()
    return [numbers for _s, _w, numbers, _l, _b in control.readings(
        bench, CELL, mode, seeds, 0.0, device, mix_changes)]


def test_the_control_reads_above_the_program_in_bfloat16():
    """On the CPU in the cell's own precision, at a small size: the control
    (the reference in float8 in the program's place) reads at least three
    times the program's bfloat16 step on the number its limit is set to
    catch."""
    limits = manifest.load().limits(CELL)
    key = "head_grad_diff"
    assert key in limits
    cpu = torch.device("cpu")
    program = _readings("program", [21], cpu, "bfloat16", SMALL)
    fp8 = _readings("fp8_reference", [21], cpu, "bfloat16", SMALL)
    assert fp8[0][key] > 3 * program[0][key], (program, fp8)


@pytest.mark.cuda
def test_the_control_comes_out_not_correct_at_the_cells_size(cuda_device):
    """On the card at the cell's own size, three seeds: the control fails
    one of the cell's limits on each, the program none."""
    limits = manifest.load().limits(CELL)
    for mode, want in (("fp8_reference", False), ("program", True)):
        for numbers in _readings(mode, [31, 32, 33], cuda_device, None, None):
            assert compare.passed(compare.held(numbers, limits)) is want, (mode, numbers)
