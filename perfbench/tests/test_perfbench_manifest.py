"""The manifest and the files it names: found by name, checked; a new cell
is new files and a new entry; the arithmetic; the no-JAX guard."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench import roofline
from perfbench.lib import guard, manifest

ROOT = manifest.ROOT


def _bench(root=ROOT):
    return manifest.load(root)


def test_every_config_mix_cell_and_metric_is_found_by_name():
    bench = _bench()
    for cell in bench.data["workloads"]:
        config = bench.config(cell["config"])
        assert config["name"] == cell["config"]
        mix = bench.mix(cell["traffic"])
        assert os.path.isfile(os.path.join(ROOT, "perfbench", "drivers", f"{mix['driver']}.py"))
        assert bench.limits(cell["name"])
        names = {m["name"] for m in bench.end_to_end(cell["name"])}
        assert "setup_s" in names and len(names) >= 2
        for m in bench.per_layer(cell["name"]):
            assert callable(bench.reader(m["name"]))


@pytest.mark.parametrize("edit, message", [
    (lambda d: d["workloads"].append(dict(d["workloads"][0])), "twice"),
    (lambda d: d["end_to_end"][0].update(bound=0.5), "bound"),
    (lambda d: d["per_layer"][0].update(moves="nothing"), "moves"),
    (lambda d: d["per_layer"][0].update(why="x"), "keys"),
    (lambda d: d["workloads"][0].update(config="nope"), "unknown config"),
])
def test_the_manifest_refuses_what_breaks_the_contract(tmp_path, edit, message):
    root = _copy(tmp_path)
    path = root / "BENCHMARK.json"
    data = json.loads(path.read_text())
    edit(data)
    path.write_text(json.dumps(data))
    with pytest.raises(manifest.ManifestError, match=message):
        _bench(str(root))


def _config(name):
    with open(os.path.join(ROOT, "perfbench", "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("changes, flop", [
    ({}, 57024),
    ({"level_count": 2, "grayscale": True, "class_count": 2}, 39264),
])
def test_flop_per_pixel(changes, flop):
    """The flagship's, and the LEVEL_COUNT=2 grayscale build's."""
    assert roofline.flop_per_pixel(dict(_config("segnet_l3_rgb"), **changes)) == flop


def test_a_training_step_is_three_forwards():
    config = _config("segnet_l3_rgb")
    assert roofline.step_flop(config, 100 * 192 * 192) == 3 * 57024 * 100 * 192 * 192


@pytest.mark.parametrize("name, bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax", True),
    ("annonet_tpu", True), ("annonet_tpu.infer.core", True),
    ("annonet_tpu_torch", False), ("annonet_tpu_torch.infer", False), ("jaxtyping", False),
    ("torch", False),
])
def test_the_guard_compares_whole_top_level_names(name, bad):
    assert guard.forbidden_modules([name]) == ([name] if bad else [])


def test_the_reference_imports_nothing_of_jax_nor_of_the_program():
    code = ("import sys; import perfbench.reference.train, perfbench.reference.compare, "
            "perfbench.roofline, perfbench.lib.scenes, perfbench.lib.weights; "
            "print('\\n'.join(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=300).stdout.split()
    tops = {n.split(".")[0] for n in out}
    assert not tops & {"jax", "jaxlib", "flax", "annonet_tpu", "annonet_tpu_torch"}


def test_a_run_without_a_card_exits_non_zero_and_prints_nothing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "l3rgb.train_b128",
                        "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode != 0 and r.stdout == ""


def _copy(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    shutil.copytree(os.path.join(ROOT, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return root


def test_a_new_cell_is_new_files_and_a_new_entry(tmp_path):
    """A configuration, a traffic mix, a cell's limits and a per-layer
    metric added as files, with manifest entries: found and run, with no
    file that was there edited."""
    root = _copy(tmp_path)
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*") if p.is_file()}
    bench_dir = root / "perfbench"
    config = _config("segnet_l3_rgb")
    config.update(name="segnet_l1_gray", level_count=1, grayscale=True, class_count=2,
                  compute_dtype="float32")
    (bench_dir / "configs" / "segnet_l1_gray.json").write_text(json.dumps(config))
    mix = json.loads((bench_dir / "mixes" / "train_b128.json").read_text())
    mix.update(pool_images=2, image_side=64, batch=4, crop=32, planned_steps=5, warmup_steps=1)
    (bench_dir / "mixes" / "train_tiny.json").write_text(json.dumps(mix))
    (bench_dir / "limits" / "l1gray.train_tiny.json").write_text(
        json.dumps({"grad_gap": 0.01, "head_grad_diff": 0.01}))
    (bench_dir / "metrics" / "steps.tiny.py").write_text(
        "def read(run):\n    return float(run.window['calls'])\n")
    data = json.loads((root / "BENCHMARK.json").read_text())
    data["configs"].append({"name": "segnet_l1_gray", "source": "https://example.org/l1",
                            "file": "perfbench/configs/segnet_l1_gray.json", "reduced": [],
                            "why": "a test"})
    data["workloads"].append({"name": "l1gray.train_tiny", "config": "segnet_l1_gray",
                              "traffic": "train_tiny", "chips": 1, "why": "a test"})
    for m in data["end_to_end"]:
        if m["name"] == "train_crops_per_s":
            m["workloads"].append("l1gray.train_tiny")
    data["per_layer"].append({"name": "steps.tiny", "unit": "steps", "better": "higher",
                              "source": "host_clock", "layer": "train.trainer",
                              "moves": "train_crops_per_s", "workloads": ["l1gray.train_tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(data))

    bench = _bench(str(root))
    assert [m["name"] for m in bench.per_layer("l1gray.train_tiny")] == ["steps.tiny"]
    import torch

    from perfbench import run

    for trace in (False, True):
        r = run.run_cell(bench, "l1gray.train_tiny", 7, 0.2, trace, torch.device("cpu"))
        assert r["correct"], r["checks"]
        assert set(r["metrics"]) == ({"steps.tiny"} if trace else {"train_crops_per_s", "setup_s"})
    assert all(p.read_bytes() == b for p, b in before.items())
