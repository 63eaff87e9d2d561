"""The six readers of the program's spans (``perfbench/lib/spans.py``) on
a hand-made trace and recorder state: their arithmetic, None where a
span's count differs from the window's steps or the program has no
recorder, and the manifest's entries for them."""

import types

import pytest

from perfbench.lib import manifest, spans
from perfbench.lib.trace import Trace

CELL = "l3rgb.train_b128"
READERS = {
    "input_device_ms.train": ("gather", "augment", "weighting"),
    "forward_device_ms.train": ("forward", "loss"),
    "backward_device_ms.train": ("backward",),
    "sgd_device_ms.train": ("sgd",),
}
IDLE = {"forward_idle_ms.train": "forward", "backward_idle_ms.train": "backward"}
DEVICE_S = {"train_step": 0.1, "gather": 0.001, "augment": 0.002, "weighting": 0.003,
            "forward": 0.02, "loss": 0.004, "backward": 0.05, "sgd": 0.006}


def _recorder(calls, **changes):
    stats = {name: {"count": calls, "host_s": 0.5, "device_s": s, "device_count": calls,
                    "newest": None} for name, s in DEVICE_S.items()}
    for name, change in changes.items():
        stats[name].update(change)
    return stats


def _run(calls, trace=None):
    return types.SimpleNamespace(window={"calls": calls, "seconds": 1.0, "crops": 0},
                                 trace=trace, config={}, mix={})


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_the_manifest_loads_with_the_six_span_metrics():
    bench = manifest.load()
    mine = {m["name"]: m for m in bench.data["per_layer"]
            if m["name"] in set(READERS) | set(IDLE)}
    assert len(mine) == 6
    for name, m in mine.items():
        assert (m["unit"], m["better"], m["source"], m["moves"], m["workloads"]) == (
            "ms", "lower", "program_span", "train_crops_per_s", [CELL]), name
        assert callable(bench.reader(name))
    assert set(mine) <= {m["name"] for m in bench.per_layer(CELL)}


@pytest.mark.parametrize("name", sorted(READERS))
def test_device_readers_sum_their_spans_over_the_steps(name, monkeypatch):
    monkeypatch.setattr(spans, "_stats", lambda: _recorder(2))
    value = manifest.load().reader(name)(_run(2))
    assert value == pytest.approx(1e3 * sum(DEVICE_S[n] for n in READERS[name]) / 2)


@pytest.mark.parametrize("changes", [
    {"forward": {"count": 3}},  # a span left more often than the window's steps
    {"train_step": {"count": 4}},  # the recorder saw steps outside the window
    {"loss": {"device_count": 1}},  # a pair not resolved on the device
])
def test_device_readers_refuse_counts_off_the_window(changes, monkeypatch):
    monkeypatch.setattr(spans, "_stats", lambda: _recorder(2, **changes))
    bench = manifest.load()
    assert bench.reader("forward_device_ms.train")(_run(2)) is None
    sgd = bench.reader("sgd_device_ms.train")(_run(2))
    if "train_step" in changes:
        assert sgd is None
    else:
        assert sgd == pytest.approx(3.0)  # the other spans still read


def test_device_readers_without_a_recorder_or_steps(monkeypatch):
    bench = manifest.load()
    monkeypatch.setattr(spans, "_stats", lambda: None)  # a program without span_stats
    assert bench.reader("backward_device_ms.train")(_run(2)) is None
    monkeypatch.setattr(spans, "_stats", lambda: {})  # nothing recorded
    assert bench.reader("backward_device_ms.train")(_run(2)) is None
    monkeypatch.setattr(spans, "_stats", lambda: _recorder(0))
    assert bench.reader("backward_device_ms.train")(_run(0)) is None


def _trace(span_name, spans_us):
    """Kernels busy over [0, 10], [20, 30], [25, 35] and [50, 60] us (gaps
    [10, 20] and [35, 50]) and ``span_name`` ranges over ``spans_us``."""
    events = [_x("kernel", "k", a, b - a) for a, b in [(0, 10), (20, 30), (25, 35), (50, 60)]]
    events += [_x("user_annotation", span_name, a, b - a) for a, b in spans_us]
    events.append(_x("cpu_op", "aten::add", 0, 70))
    return Trace(events, 70e-6)


@pytest.mark.parametrize("name", sorted(IDLE))
def test_idle_readers_overlap_the_gaps_with_their_ranges(name):
    reader = manifest.load().reader(name)
    # [5, 25] holds gap [10, 20]; [40, 55] holds 10 us of gap [35, 50]
    run = _run(2, _trace(IDLE[name], [(5, 25), (40, 55)]))
    assert reader(run) == pytest.approx(1e3 * 20e-6 / 2)
    # inside one busy interval, and before the first
    run = _run(2, _trace(IDLE[name], [(21, 29), (-5, 0)]))
    assert reader(run) == pytest.approx(0.0)


def test_idle_readers_refuse_counts_off_the_window():
    reader = manifest.load().reader("forward_idle_ms.train")
    assert reader(_run(3, _trace("forward", [(5, 25), (40, 55)]))) is None
    assert reader(_run(2, _trace("backward", [(5, 25), (40, 55)]))) is None
    assert reader(_run(2, None)) is None


def test_device_ms_reads_the_program_recorder():
    """The reader against the program's own recorder: a profiled window on
    the CPU times the host only, so the device reading is None."""
    from torch.profiler import ProfilerActivity, profile

    from annonet_tpu_torch.utils.profiling import reset_span_stats, span, span_stats

    reset_span_stats()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(2):
                with span("train_step", True), span("sgd", True):
                    pass
        assert span_stats()["sgd"]["count"] == 2
        assert spans.device_ms(_run(2), ("sgd",)) is None
    finally:
        reset_span_stats()
