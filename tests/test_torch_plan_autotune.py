"""The port's measured plan selection (``TiledInferer(plan_autotune=True)``,
``annonet_infer --plan-autotune``) and ``plan_for_counts`` against the JAX
package: the plans equal JAX's over a grid of canvases and counts (the
``None`` cases included); the candidates equal those JAX's autotune times
for the same canvas, where both inferers' default plans agree (JAX bumps
a 3-tile axis to 4, the port does not); the chosen plan is cached per
canvas bucket and later images reuse it; the labels equal a twin pinned to
the chosen plan; the CLI prints the JAX CLI's report line.
"""

import dataclasses
import itertools

import numpy as np
import pytest

from annonet_tpu.infer.core import TiledInferer as JaxTiledInferer
from annonet_tpu.infer.tiling import TilingParameters as JaxTilingParameters
from annonet_tpu.infer.tiling import plan_for_counts as jax_plan_for_counts
from annonet_tpu.models.segnet import SegNetConfig as JaxSegNetConfig
from annonet_tpu_torch.cli import infer as cli
from annonet_tpu_torch.cli.common import DEVICE_ENV
from annonet_tpu_torch.infer.core import TiledInferer
from annonet_tpu_torch.infer.tiling import TilingParameters, plan_for_counts
from annonet_tpu_torch.models.segnet import SegNetConfig
from tests.test_end_to_end import write_synthetic_dataset
from tests.test_torch_cli import _save_model
from tests.test_torch_model import jax_runtime_tree

CONFIG = dict(class_count=3, level_count=1, base_width=8, compute_dtype="float32")
OVERLAP = 14  # required_input_dimension of CONFIG


def as_tuple(plan):
    return None if plan is None else dataclasses.astuple(plan)


@pytest.mark.parametrize("level_count, width", [(1, 8), (2, 16)])
@pytest.mark.parametrize("lane_align", [False, True])
def test_plan_for_counts_equals_jax(level_count, width, lane_align):
    cfg = dict(class_count=3, level_count=level_count, base_width=width)
    config, jconfig = SegNetConfig(**cfg), JaxSegNetConfig(**cfg)
    seen_none = seen_plan = 0
    for (h, w), max_tile, cy, cx in itertools.product(
            ((100, 100), (150, 130), (300, 200), (1500, 2300), (4096, 4096)),
            (96, 256, 1024), (1, 2, 3, 5, 9), (1, 2, 4, 7)):
        ov = 14 if level_count == 1 else 30
        args = (h, w, config, TilingParameters(max_tile, max_tile, ov, ov), cy, cx)
        ours = plan_for_counts(*args, lane_align_tiles=lane_align)
        theirs = jax_plan_for_counts(h, w, jconfig, JaxTilingParameters(max_tile, max_tile, ov, ov),
                                     cy, cx, lane_align_tiles=lane_align)
        assert as_tuple(ours) == as_tuple(theirs), (h, w, max_tile, cy, cx)
        seen_none += ours is None
        seen_plan += ours is not None
    assert seen_none > 20 and seen_plan > 20


@pytest.fixture(scope="module")
def params():
    return jax_runtime_tree(SegNetConfig(**CONFIG), seed=0)


def inferers(params, **kwargs):
    tiling = TilingParameters(96, 96, OVERLAP, OVERLAP)
    return TiledInferer(params, SegNetConfig(**CONFIG), tiling, device="cpu", **kwargs)


@pytest.mark.parametrize("shape", [(100, 100), (120, 90)])
def test_candidates_equal_what_the_jax_autotune_times(params, shape, monkeypatch):
    monkeypatch.setenv("ANNONET_TPU_AUTOTUNE_ITERS", "1")
    image = np.random.default_rng(1).integers(0, 256, (*shape, 3), dtype=np.uint8)
    jax_inferer = JaxTiledInferer(params, JaxSegNetConfig(**CONFIG),
                                  JaxTilingParameters(96, 96, OVERLAP, OVERLAP),
                                  plan_autotune=True)
    jax_inferer.infer_arrays(image)
    (key, report), = jax_inferer.autotune_reports.items()
    ours = inferers(params, plan_autotune=True)
    candidates = ours.autotune_candidates(*shape)
    assert len(candidates) == 3
    assert {as_tuple(p) for p in candidates} == {as_tuple(p) for p, _rate in report}
    ours.infer_arrays(image)
    assert list(ours.autotune_reports) == [key]


def test_autotune_caches_its_choice_and_equals_a_pinned_twin(params, monkeypatch):
    monkeypatch.setenv("ANNONET_TPU_AUTOTUNE_ITERS", "1")
    rng = np.random.default_rng(2)
    image = rng.integers(0, 256, (150, 150, 3), dtype=np.uint8)
    tuned = inferers(params, plan_autotune=True)
    labels, _ = tuned.infer_arrays(image, detection_levels=[0.0, 0.5, 0.0])
    (key, report), = tuned.autotune_reports.items()
    assert key == (256, 256) and len(report) >= 2
    rates = [r for _p, r in report]
    assert rates == sorted(rates, reverse=True) and rates[-1] > 0
    chosen = report[0][0]
    assert tuned.plan(150, 150) == chosen
    # every candidate made its constants; the next image of the bucket reuses the choice
    assert tuned.compiled_programs == len(report)
    other = rng.integers(0, 256, (140, 160, 3), dtype=np.uint8)
    tuned.infer_arrays(other)
    assert len(tuned.autotune_reports) == 1 and tuned.plan(140, 160) == chosen
    again, _ = tuned.infer_arrays(image, detection_levels=[0.0, 0.5, 0.0])
    np.testing.assert_array_equal(labels, again)
    twin = inferers(params)
    twin._plan_override = chosen
    pinned, _ = twin.infer_arrays(image, detection_levels=[0.0, 0.5, 0.0])
    np.testing.assert_array_equal(labels, pinned)
    # a batch of the bucket runs the cached plan too
    batch, _ = tuned.infer_arrays_batch(np.stack([image, image]))
    np.testing.assert_array_equal(batch[1], twin.infer_arrays(image)[0])


def test_time_plans_times_any_plan_list_in_order(params, monkeypatch):
    """``_time_plans`` (the autotune's timing loop, which chip_smoke.py
    also gives a plan outside the candidates) rates each plan of the list
    in its order, repeats included, without a choice or an override left
    behind, and makes no calibration or cache entry."""
    monkeypatch.setenv("ANNONET_TPU_AUTOTUNE_ITERS", "1")
    image = np.random.default_rng(3).integers(0, 256, (100, 100, 3), dtype=np.uint8)
    inferer = inferers(params)
    default = inferer.plan(100, 100)
    extra = plan_for_counts(100, 100, SegNetConfig(**CONFIG), inferer.tiling, 3, 3,
                            canvas_bucket=128, lane_align_tiles=False)
    assert extra is not None and extra != default
    timed = inferer._time_plans(image, [default, extra, default])
    assert [p for _r, p in timed] == [default, extra, default]
    assert all(r > 0 for r, _p in timed)
    assert inferer._plan_override is None and not inferer.autotune_reports
    assert inferer.plan(100, 100) == default


def test_cli_plan_autotune_prints_the_report(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    monkeypatch.setenv("ANNONET_TPU_AUTOTUNE_ITERS", "1")
    write_synthetic_dataset(tmp_path, n_images=2, size=150)
    model = _save_model(tmp_path, (tmp_path / "anno_classes.json").read_text())
    assert cli.main([str(tmp_path), "--model", model, "--plan-autotune", "-w", "96",
                     "-h", "96"]) == 0
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("Plan autotune for canvas")]
    assert len(lines) == 1 and lines[0].startswith("Plan autotune for canvas 256x256: chose ")
    assert "(candidates: " in lines[0] and "Mpx/s" in lines[0]
