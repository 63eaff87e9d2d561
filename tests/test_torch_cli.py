"""``annonet_infer`` of the port (annonet_tpu_torch/cli/infer.py) against
the JAX package's CLI: the same flags, the same result PNGs (>= 99.9% of
pixels; identical is expected) and the same confusion matrices on a
synthetic anno dataset, the int8 flags with calibration files either
package reads, an exit code of 2 for each flag whose feature is not ported
yet, no silent CPU run, and a package that imports and runs both paths
without jax.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from annonet_tpu import serialization as jax_serialization
from annonet_tpu.classes import parse_anno_classes
from annonet_tpu.cli import infer as jax_cli
from annonet_tpu.models.segnet import SegNetConfig as JaxSegNetConfig
from annonet_tpu_torch.cli import infer as cli
from annonet_tpu_torch.cli.common import DEVICE_ENV
from annonet_tpu_torch.models.segnet import SegNetConfig
from tests.test_end_to_end import write_synthetic_dataset
from tests.test_torch_model import jax_runtime_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def dataset(tmp_path):
    """Two copies of one synthetic dataset and a JAX-written artifact."""
    (tmp_path / "jax").mkdir()
    write_synthetic_dataset(tmp_path / "jax", n_images=3, size=48)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    anno_json = (tmp_path / "jax" / "anno_classes.json").read_text()
    config = SegNetConfig(class_count=len(parse_anno_classes(anno_json)), level_count=1,
                          base_width=4, compute_dtype="float32")
    model = str(tmp_path / "annonet.dnn")
    jax_serialization.save_model(model, jax_runtime_tree(config, seed=8),
                                 JaxSegNetConfig(**config.to_dict()), anno_json, 1.0)
    return tmp_path, model


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
    import json

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


def test_parser_has_the_jax_flags():
    def table(parser):
        return {
            tuple(a.option_strings) or (a.dest,): (a.dest, a.default, a.choices, a.type,
                                                   a.nargs, type(a).__name__)
            for a in parser._actions
        }

    assert table(cli.build_parser()) == table(jax_cli.build_parser())


# the int8 flags are ported; they stay in the list to show they are no
# longer refused (no model in the directory: the run fails with 1, not 2)
_PORTED = ("--quantize", "--blend-dtype", "--calibration", "--save-calibration",
           "--calibration-images")


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
        assert code == 2 and flag[0] in err and "ROADMAP.md" in err


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
