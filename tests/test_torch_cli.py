"""``annonet_infer`` of the port (annonet_tpu_torch/cli/infer.py) against
the JAX package's CLI: the same flags, the same result PNGs (>= 99.9% of
pixels; identical is expected) and the same confusion matrices on a
synthetic anno dataset, the threaded pipeline (reader and writer threads,
groups in flight) against the port's sequential loop (byte-equal PNGs) and
the JAX CLI on images of mixed sizes, the in-order buffer of the readers,
the ``--profile`` trace, the int8 flags with calibration files either
package reads, an exit code of 2 for each flag whose feature is not ported
yet, no silent CPU run, and a package that imports and runs both paths
without jax.
"""

import json
import os
import queue
import random
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from annonet_tpu import serialization as jax_serialization
from annonet_tpu.classes import parse_anno_classes
from annonet_tpu.cli import infer as jax_cli
from annonet_tpu.cli.common import IndexOrderedResults as JaxIndexOrderedResults
from annonet_tpu.models.segnet import SegNetConfig as JaxSegNetConfig
from annonet_tpu_torch.cli import infer as cli
from annonet_tpu_torch.cli.common import DEVICE_ENV, IndexOrderedResults
from annonet_tpu_torch.models.segnet import SegNetConfig
from annonet_tpu_torch.utils import TRACE_FILE
from tests.test_end_to_end import write_synthetic_dataset
from tests.test_torch_model import jax_runtime_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _save_model(tmp_path, anno_json):
    """A JAX-written artifact of a small f32 net for the dataset's classes."""
    config = SegNetConfig(class_count=len(parse_anno_classes(anno_json)), level_count=1,
                          base_width=4, compute_dtype="float32")
    model = str(tmp_path / "annonet.dnn")
    jax_serialization.save_model(model, jax_runtime_tree(config, seed=8),
                                 JaxSegNetConfig(**config.to_dict()), anno_json, 1.0)
    return model


@pytest.fixture
def dataset(tmp_path):
    """Two copies of one synthetic dataset and a JAX-written artifact."""
    (tmp_path / "jax").mkdir()
    write_synthetic_dataset(tmp_path / "jax", n_images=3, size=48)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    return tmp_path, _save_model(tmp_path, (tmp_path / "jax" / "anno_classes.json").read_text())


# the sizes of the mixed dataset's images, in file order: with --image-batch
# 2 the groups are [48, 48], [64] (the next 48 pushed back), [48], [64, 64]
_MIXED = ((48, 0), (48, 1), (64, 0), (48, 2), (64, 1), (64, 2))


@pytest.fixture
def mixed_dataset(tmp_path):
    """Three copies (jax, pipelined, sequential) of six images of two
    sizes in the order of _MIXED, and a JAX-written artifact."""
    for size, seed in ((48, 0), (64, 1)):
        (tmp_path / "src" / str(size)).mkdir(parents=True)
        write_synthetic_dataset(tmp_path / "src" / str(size), n_images=3, size=size, seed=seed)
    for copy in ("jax", "pipelined", "sequential"):
        (tmp_path / copy).mkdir()
        shutil.copy(tmp_path / "src" / "48" / "anno_classes.json", tmp_path / copy)
        for k, (size, i) in enumerate(_MIXED):
            for suffix in ("", "_mask.png"):
                shutil.copy(tmp_path / "src" / str(size) / f"img{i}.png{suffix}",
                            tmp_path / copy / f"a{k}.png{suffix}")
    return tmp_path, _save_model(tmp_path, (tmp_path / "jax" / "anno_classes.json").read_text())


def _confusion_blocks(text):
    lines = text[text.index("Confusion matrix per pixel:"):].splitlines()
    ends = [i for i, line in enumerate(lines) if "accuracy" in line]
    return "\n".join(lines[: ends[1] + 1])


def test_results_and_confusion_match_the_jax_cli(dataset, capsys, monkeypatch):
    root, model = dataset
    flags = ["--model", model, "-g", "1:0.2", "-d", "1:0.1"]
    assert jax_cli.main([str(root / "jax"), *flags]) == 0
    jax_out = capsys.readouterr().out
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    assert cli.main([str(root / "port"), *flags]) == 0
    out = capsys.readouterr().out
    for needle in ("Using gains: 0:0 1:0.2", "Using detection levels: 0:0 1:0.1",
                   "All 3 images processed", "All result images written!"):
        assert needle in out
    assert _confusion_blocks(out) == _confusion_blocks(jax_out)
    for i in range(3):
        ours = np.asarray(Image.open(root / "port" / f"img{i}.png_result.png"))
        theirs = np.asarray(Image.open(root / "jax" / f"img{i}.png_result.png"))
        assert ours.shape == theirs.shape == (48, 48, 4)
        assert (ours == theirs).all(axis=-1).mean() >= 0.999


def test_image_batch_and_report_json(dataset, capsys, monkeypatch):
    root, model = dataset
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    report = root / "report.json"
    assert cli.main([str(root / "port"), "--model", model, "--image-batch", "2",
                     "--report-json", str(report)]) == 0
    capsys.readouterr()
    doc = json.loads(report.read_text())
    assert doc["images"] == 3 and doc["device"] == "cpu"
    assert [r["first_group"] for r in doc["per_image"]] == [True, True, False]
    assert doc["confusion_per_pixel"]["total"] == 3 * 48 * 48


def test_pipelined_cli_equals_the_sequential_loop_and_the_jax_cli(mixed_dataset, capsys,
                                                                  monkeypatch):
    """3 groups in flight, 3 readers and 2 writers against depth 1 with
    one reader and one writer, and against the JAX CLI, on images of two
    sizes with --image-batch 2 (full groups, a group closed by a size
    change, the odd image pushed back): byte-equal result PNGs, the same
    confusion blocks, the report's pipeline depth, and the first-group
    flags as JAX sets them."""
    root, model = mixed_dataset
    flags = ["--model", model, "-g", "1:0.2", "-d", "1:0.1", "--image-batch", "2"]
    runs = {
        "pipelined": ["--pipeline-depth", "3", "--full-image-reader-thread-count", "3",
                      "--result-image-writer-thread-count", "2"],
        "sequential": ["--pipeline-depth", "1", "--full-image-reader-thread-count", "1",
                       "--result-image-writer-thread-count", "1"],
    }
    assert jax_cli.main([str(root / "jax"), *flags, "--report-json",
                         str(root / "jax.json")]) == 0
    outs = {"jax": capsys.readouterr().out}
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    for name, extra in runs.items():
        assert cli.main([str(root / name), *flags, *extra, "--report-json",
                         str(root / f"{name}.json")]) == 0
        outs[name] = capsys.readouterr().out
        assert "All 6 images processed" in outs[name]
        assert outs[name].index("All 6 images processed") < outs[name].index(
            "All result images written!")
    assert _confusion_blocks(outs["pipelined"]) == _confusion_blocks(outs["sequential"]) \
        == _confusion_blocks(outs["jax"])
    for k, (size, _i) in enumerate(_MIXED):
        name = f"a{k}.png_result.png"
        assert (root / "pipelined" / name).read_bytes() == (root / "sequential" / name).read_bytes()
        ours = np.asarray(Image.open(root / "pipelined" / name))
        theirs = np.asarray(Image.open(root / "jax" / name))
        assert ours.shape == theirs.shape == (size, size, 4)
        assert (ours == theirs).all(axis=-1).mean() >= 0.999
    reports = {name: json.loads((root / f"{name}.json").read_text())
               for name in ("jax", "pipelined", "sequential")}
    assert reports["pipelined"]["pipeline_depth"] == 3
    assert reports["sequential"]["pipeline_depth"] == 1
    flags_of = {name: [(os.path.basename(r["image"]), r["first_group"]) for r in doc["per_image"]]
                for name, doc in reports.items()}
    assert flags_of["pipelined"] == flags_of["sequential"] == flags_of["jax"]
    assert [first for _name, first in flags_of["jax"]] == [True, True] + [False] * 4


def test_pipeline_under_thread_stress(mixed_dataset, capsys, monkeypatch):
    """More reader and writer threads than cores, 4 groups in flight and a
    short switch interval: the run ends within its time bound and writes
    the sequential loop's PNGs byte for byte."""
    root, model = mixed_dataset
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    flags = ["--model", model, "-d", "1:0.1", "--image-batch", "2"]
    assert cli.main([str(root / "sequential"), *flags, "--pipeline-depth", "1",
                     "--full-image-reader-thread-count", "1",
                     "--result-image-writer-thread-count", "1"]) == 0
    threads = str(2 * (os.cpu_count() or 1) + 1)
    codes = []
    run = threading.Thread(target=lambda: codes.append(cli.main([
        str(root / "pipelined"), *flags, "--pipeline-depth", "4",
        "--full-image-reader-thread-count", threads,
        "--result-image-writer-thread-count", threads])))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        run.start()
        run.join(timeout=240)
    finally:
        sys.setswitchinterval(interval)
    assert not run.is_alive() and codes == [0]
    capsys.readouterr()
    for k in range(len(_MIXED)):
        name = f"a{k}.png_result.png"
        assert (root / "pipelined" / name).read_bytes() == (root / "sequential" / name).read_bytes()


def test_index_ordered_results_behaves_as_the_jax_class():
    """Items put out of order come out 0, 1, 2, ...; the port's class and
    the JAX class give the same sequence for the same queue contents."""
    order = list(range(40))
    random.Random(3).shuffle(order)
    got = []
    for cls in (IndexOrderedResults, JaxIndexOrderedResults):
        q = queue.Queue()
        for index in order:
            q.put((index, f"item{index}"))
        results = cls(q)
        got.append([results.next() for _ in order])
        assert q.empty()
    assert got[0] == got[1] == [f"item{i}" for i in range(40)]


def test_profile_writes_a_trace(dataset, capsys, monkeypatch):
    """--profile DIR on the CPU: exit 0 and a Chrome trace that parses, with
    the loop's torch operations in it."""
    root, model = dataset
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    trace_dir = root / "trace"
    assert cli.main([str(root / "port"), "--model", model, "--profile", str(trace_dir)]) == 0
    assert "All result images written!" in capsys.readouterr().out
    events = json.loads((trace_dir / TRACE_FILE).read_text())["traceEvents"]
    assert any(e.get("ph") == "X" and str(e.get("name", "")).startswith("aten::")
               for e in events)


def test_parser_has_the_jax_flags():
    def table(parser):
        return {
            tuple(a.option_strings) or (a.dest,): (a.dest, a.default, a.choices, a.type,
                                                   a.nargs, type(a).__name__)
            for a in parser._actions
        }

    assert table(cli.build_parser()) == table(jax_cli.build_parser())


# the int8 flags, --profile and --plan-autotune are ported; they stay in the
# list to show they are no longer refused (no model in the directory: the run
# fails with 1, not 2)
_PORTED = ("--quantize", "--blend-dtype", "--calibration", "--save-calibration",
           "--calibration-images", "--profile", "--plan-autotune")


@pytest.mark.parametrize(
    "flag",
    [["--quantize", "int8"], ["--blend-dtype", "bfloat16"], ["--calibration", "c.npz"],
     ["--save-calibration", "c.npz"], ["--calibration-images", "2"], ["--mesh", "2"],
     ["--coordinator", "localhost:1234"], ["--num-processes", "2"], ["--process-id", "0"],
     ["--plan-autotune"], ["--profile", "trace"]],
)
def test_unported_flags_exit_2(tmp_path, capsys, flag, monkeypatch):
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    code = cli.main([str(tmp_path), *flag])
    err = capsys.readouterr().err
    if flag[0] in _PORTED:
        assert code == 1 and "not ported" not in err
    else:
        assert code == 2 and flag[0] in err and "ROADMAP.md queue 1 item 3" in err


def test_int8_flags_and_calibration_files(dataset, capsys, monkeypatch):
    root, model = dataset
    runtime, config, _anno, _ds = jax_serialization.load_model(model)
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    calib = str(root / "calib.npz")
    port = str(root / "port")
    assert cli.main([port, "--model", model, "--quantize", "int8", "-d", "1:0.1",
                     "--calibration-images", "2", "--save-calibration", calib]) == 0
    out = capsys.readouterr().out
    assert "int8 calibration: 2 image(s); activation range overshoot" in out
    assert f"Saved int8 calibration to {calib}" in out
    # the JAX loader reads the port's file, fingerprint checked
    assert len(jax_serialization.load_calibration(calib, config, runtime)) == 9
    assert cli.main([port, "--model", model, "--quantize", "int8", "--calibration", calib,
                     "--blend-dtype", "float32"]) == 0
    assert f"Loaded int8 calibration from {calib}" in capsys.readouterr().out
    assert cli.main([port, "--model", model, "--calibration", calib]) == 1
    assert "require --quantize int8" in capsys.readouterr().out
    assert cli.main([port, "--model", model, "--quantize", "int8",
                     "--calibration-images", "0"]) == 1
    assert "--calibration-images must be >= 1" in capsys.readouterr().out


def test_usage_and_parse_errors(capsys):
    assert cli.main([]) == 1
    assert "./annonet_infer /path/to/image/data" in capsys.readouterr().out
    assert cli.main(["--tile-max-width", "x", "dir"]) == 2


def test_no_silent_cpu_run(dataset, capsys, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLI rightly runs on it")
    root, model = dataset
    monkeypatch.delenv(DEVICE_ENV, raising=False)
    assert cli.main([str(root / "port"), "--model", model]) == 1
    assert "no CUDA device" in capsys.readouterr().out
    assert not (root / "port" / "img0.png_result.png").exists()


_NO_JAX = """
import sys
sys.modules["jax"] = None  # any import of jax, or of the JAX package, now raises
sys.modules["annonet_tpu"] = None
import importlib, pkgutil
import numpy as np
import annonet_tpu_torch
names = [m.name for m in pkgutil.walk_packages(annonet_tpu_torch.__path__, "annonet_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from annonet_tpu_torch.infer.core import TiledInferer, annonet_infer
from annonet_tpu_torch.models.segnet import SegNetConfig, init_runtime_params
config = SegNetConfig(class_count=3, level_count=2, base_width=4)
image = np.random.default_rng(0).integers(0, 256, (70, 90, 3), dtype=np.uint8)
params = init_runtime_params(config, 0)
for kwargs in ({}, {"quantize": "int8"}, {"use_pallas_conv": True}):
    inferer = TiledInferer(params, config, device="cpu", **kwargs)
    out = annonet_infer(inferer, image)
    assert out.shape == (70, 90) and out.dtype == np.uint16
    if kwargs.get("quantize"):
        assert inferer._quantized and inferer.float_fallbacks == 0  # the int8 net ran
assert list(inferer._folded) == [8]  # the folded net (G1's plain version) ran
from annonet_tpu_torch.cli import infer as cli
data, model = sys.argv[1:3]
for flags in ([], ["--quantize", "int8"]):  # the CLI: classes, decode, encode, blobs
    assert cli.main([data, "--model", model, "-d", "1:0.1", *flags]) == 0
loaded = [m for m in sys.modules if sys.modules[m] is not None]
assert not any(m.split(".")[0] in ("jax", "annonet_tpu") for m in loaded)
print("imported", len(names), "modules without jax and annonet_tpu")
"""


def test_the_port_imports_and_runs_without_jax(dataset):
    root, model = dataset
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [REPO, env.get("PYTHONPATH")]))
    env[DEVICE_ENV] = "cpu"
    proc = subprocess.run([sys.executable, "-c", _NO_JAX, str(root / "port"), model], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "without jax and annonet_tpu" in proc.stdout
    assert (root / "port" / "img0.png_result.png").exists()
