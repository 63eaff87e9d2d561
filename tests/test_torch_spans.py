"""The port's spans (annonet_tpu_torch/utils/profiling.py) on the CPU: off
(no profiler, no ANNONET_TPU_STEP_TIMING) a training step opens no
``record_function`` range and the recorder stays empty; under
``torch.profiler`` one ``Trainer.train_step_decisions`` step records each
phase once, nested as the trainer opens them, and its Chrome trace holds
the ranges ``chip_smoke.py`` reads; the recorder's device side (events
paired, resolved only once complete, in order, never waited on) against
fake CUDA events; and annonet_train's ANNONET_TPU_STEP_TIMING lines."""

import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from annonet_tpu_torch.cli import train as cli
from annonet_tpu_torch.cli.common import DEVICE_ENV
from annonet_tpu_torch.data.crop import CropOptions
from annonet_tpu_torch.data.sample import Sample
from annonet_tpu_torch.models.segnet import SegNetConfig
from annonet_tpu_torch.train import DeviceImagePool, Trainer, TrainerConfig
from annonet_tpu_torch.utils import profiling
from annonet_tpu_torch.utils.profiling import reset_span_stats, span, span_stats
from tests.test_end_to_end import write_synthetic_dataset

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("gather", "augment", "weighting", "forward", "loss", "backward", "sgd")
AUGMENT = dict(allow_flip_left_right=True, allow_flip_upside_down=True,
               multiplicative_brightness_change_probability=0.5,
               noise_level_stddev=2.0, allow_random_color_offset=True)


def _chip_smoke_stages():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.STAGES


def _step():
    """A one-device trainer and a function that runs one decisions step."""
    rng = np.random.default_rng(0)
    samples = [Sample(input_image=rng.integers(0, 256, (40, 48, 3), dtype=np.uint8),
                      label_image=rng.integers(0, 3, (40, 48)).astype(np.uint16))
               for _ in range(2)]
    dim = 16
    rects = [(x, y, x + dim - 1, y + dim - 1) for x, y in [(0, 0), (20, 10)]]
    trainer = Trainer(SegNetConfig(class_count=3, level_count=1, base_width=4),
                      TrainerConfig(loss_sync_interval=4), seed=0, device="cpu")
    pool = DeviceImagePool(2, device="cpu")
    options = CropOptions(dim=dim, **AUGMENT)
    return trainer, lambda: trainer.train_step_decisions(pool, samples, rects, options)


@pytest.fixture
def quiet(monkeypatch):
    """The recorder emptied, before and after, and off but for a profiler."""
    reset_span_stats()
    monkeypatch.setattr(profiling._RECORDER, "by_env", False)
    yield
    reset_span_stats()


def test_off_a_step_opens_no_range_and_records_nothing(quiet, monkeypatch):
    trainer, step = _step()
    opened, entered = [], []
    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__",
                        lambda self: opened.append(self.name))
    monkeypatch.setattr(profiling._RECORDER, "enter",
                        lambda *a: entered.append(a) or pytest.fail("recorder entered"))
    step()
    trainer.flush_losses()
    assert opened == [] and entered == []
    assert span_stats() == {}
    assert span("x") is span("y", True, torch.device("cpu"))  # the shared no-op


def _intervals(events, name):
    return [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") == "user_annotation" and e.get("name") == name]


def test_a_profiled_step_records_each_phase_once_nested(quiet, tmp_path):
    trainer, step = _step()
    step()  # the first step's lazy set-up stays out of the window
    reset_span_stats()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
        trainer.flush_losses()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    stats = span_stats()
    assert set(stats) == {"train_step", "loss_readback", *PHASES}
    for name, entry in stats.items():
        assert entry["count"] == 1 and entry["host_s"] > 0, name
        assert entry["device_count"] == 0 and entry["newest"] is None, name  # CPU
    inner = sum(stats[name]["host_s"] for name in PHASES)
    assert inner <= stats["train_step"]["host_s"]
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    (step_a, step_b), = _intervals(events, "train_step")
    (fwd_a, fwd_b), = _intervals(events, "forward")
    for name in PHASES:
        (a, b), = _intervals(events, name)
        assert step_a <= a <= b <= step_b, name
        if name != "forward":
            assert b <= fwd_a or a >= fwd_b, name  # siblings of the forward
    for name in ("conv_forward", "bn"):
        ranges = _intervals(events, name)
        assert ranges and all(fwd_a <= a <= b <= fwd_b for a, b in ranges), name
    emitted = set(_chip_smoke_stages()) - {"shard_params", "grad_sum", "backward_conv",
                                           "backward_other", "other"}
    names = {e.get("name") for e in events if e.get("cat") == "user_annotation"}
    assert emitted <= names and "backward" in names
    (a, b), = _intervals(events, "loss_readback")
    assert a >= step_b  # after the step's last launch


def test_reset_clears_the_recorder(quiet):
    with profile(activities=[ProfilerActivity.CPU]):
        with span("a", True):
            pass
    assert span_stats()["a"]["count"] == 1
    reset_span_stats()
    assert span_stats() == {}


def test_step_timing_without_a_profiler_records_host_time(quiet, monkeypatch):
    trainer, step = _step()
    monkeypatch.setattr(profiling._RECORDER, "by_env", True)
    opened = []
    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__",
                        lambda self: opened.append(self.name))
    step()
    step()
    stats = span_stats()
    assert opened == []  # the recorder without a profiler opens no range
    assert {name: e["count"] for name, e in stats.items()} == dict.fromkeys(
        ("train_step", *PHASES), 2)


class _Clock:
    """A fake device: events stamped with a device time, complete once the
    device's clock passes them."""

    def __init__(self):
        self.now, self.made, self.queried = 0.0, 0, 0
        clock = self

        class Event:
            def __init__(self, enable_timing=False):
                assert enable_timing
                clock.made += 1
                self.at = None

            def record(self, stream):
                assert stream == "stream"
                self.at = clock.stamp

            def query(self):
                clock.queried += 1
                return self.at <= clock.now

            def elapsed_time(self, end):
                assert self.at <= clock.now and end.at <= clock.now  # no wait
                return end.at - self.at

        self.Event = Event
        self.stamp = 0.0


def test_device_pairs_resolve_in_order_once_complete(quiet, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(torch.cuda, "Event", clock.Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: "stream")
    monkeypatch.setattr(profiling._RECORDER, "by_env", True)
    dev = torch.device("cuda", 0)

    def one_step(t0):
        # device times (ms): step t0..t0+10, a t0+1..t0+3, b t0+4..t0+9
        clock.stamp = t0
        with span("step", True, dev):
            clock.stamp = t0 + 1
            with span("a", True, dev):
                clock.stamp = t0 + 3
            clock.stamp = t0 + 4
            with span("b", True, dev):
                clock.stamp = t0 + 9
            clock.stamp = t0 + 10

    one_step(0)
    one_step(100)
    stats = span_stats()
    assert {n: (e["count"], e["device_count"]) for n, e in stats.items()} == {
        "step": (2, 0), "a": (2, 0), "b": (2, 0)}  # nothing has completed
    clock.now = 100 + 3  # the first step and the second's "a" are done
    stats = span_stats()
    assert stats["step"]["device_count"] == 1 and stats["a"]["device_count"] == 2
    assert stats["b"]["device_count"] == 1
    assert stats["step"]["newest"] == {"index": 0, "device_s": pytest.approx(10e-3),
                                       "inner": pytest.approx({"a": 2e-3, "b": 5e-3})}
    assert stats["a"]["device_s"] == pytest.approx(4e-3)
    clock.now = 1000
    stats = span_stats()
    assert stats["step"]["device_s"] == pytest.approx(20e-3)
    assert stats["step"]["newest"]["index"] == 1
    made = clock.made
    one_step(200)  # the resolved pairs' events are reused
    assert clock.made == made
    clock.now = 10_000
    assert span_stats()["b"]["device_count"] == 3


def test_step_timing_lines_start_with_the_step(quiet, tmp_path, capsys, monkeypatch):
    (tmp_path / "train").mkdir()
    write_synthetic_dataset(tmp_path / "train", n_images=3, size=48)
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    monkeypatch.setenv(profiling.STEP_TIMING_ENV, "1")
    try:
        rc = cli.main([str(tmp_path / "train"), "--level-count", "1",
                       "--net-width-scaler", "0.5", "-b", "4",
                       "--data-loader-thread-count", "2", "--deterministic-data",
                       "--max-total-steps", "3", "--save-interval", "1000",
                       "--output", str(tmp_path / "a.dnn"),
                       "--sync-file", str(tmp_path / "a.dat")])
        stats = span_stats()
    finally:
        monkeypatch.delenv(profiling.STEP_TIMING_ENV)
        reset_span_stats()
    assert rc == 0
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("[step ")]
    assert [int(re.match(r"\[step (\d+)\] \d+\.\d{3}s", line).group(1))
            for line in lines] == [0, 1, 2]
    assert stats["train_step"]["count"] == 3  # the loop turned the recorder on


def test_device_part_of_the_step_timing_line():
    assert cli._device_step({}) == ""
    assert cli._device_step({"train_step": {"newest": None}}) == ""
    newest = {"index": 7, "device_s": 0.0485, "inner": {"gather": 0.0002, "sgd": 0.0011}}
    assert cli._device_step({"train_step": {"newest": newest}}) == (
        " device[step 7] 48.500ms (gather 0.200, sgd 1.100)")
