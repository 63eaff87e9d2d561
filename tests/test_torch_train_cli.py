"""``annonet_train`` of the port (annonet_tpu_torch/cli/train.py) against
the JAX package's CLI, on the CPU: the same parser; a --mesh 2 run on
virtual shards and an --int8-training run; the exit codes (1 with no
arguments, for setup errors and without a CUDA device; 2 for a bad parse
or downscaling factor and for an error in the training loop); a package
that trains, validates and resumes without jax; and the parity run: JAX's
CLI writes a sync file at step 0, and both CLIs resume from copies of it
for 5 steps on the same deterministic crops (no augmentation), in bf16 and
(a copy of the file that declares it) in f32. In f32 their loss events
agree within 2e-3 relative, their artifacts within 5e-3 of each tensor's
scale and their label maps of a validation image on >= 99.5% of its
pixels (measured 5.8e-4, 9.8e-4 and 99.93%: the summation order's
rounding grows over the steps). In bf16 the losses agree within 5e-2, the
folded conv weights within 5e-2 and the label maps on >= 97% (measured
97.9%: after five steps the defects' edges are near ties); the folded
biases are held against the port's own f32 run instead, with every leaf
within 5e-2 (measured 1.2e-2) and label maps >= 99% equal (measured
99.3%), because JAX's bf16 training on the CPU moves some of them far
from its own f32 run within five steps (its label maps 98.2% equal to
it).
"""

import functools
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from annonet_tpu import serialization as jax_serialization
from annonet_tpu.cli import train as jax_cli
from annonet_tpu_torch import serialization
from annonet_tpu_torch.cli import train as cli
from annonet_tpu_torch.cli.common import DEVICE_ENV
from annonet_tpu_torch.data import default_anno_classes
from annonet_tpu_torch.infer.core import TiledInferer
from annonet_tpu_torch.models.segnet import tree_items
from tests.test_end_to_end import write_synthetic_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--level-count", "1", "--net-width-scaler", "0.5", "-b", "4",
         "--data-loader-thread-count", "2", "--deterministic-data"]


@pytest.fixture
def dataset(tmp_path):
    (tmp_path / "train").mkdir()
    (tmp_path / "val").mkdir()
    write_synthetic_dataset(tmp_path / "train", n_images=3, size=48)
    write_synthetic_dataset(tmp_path / "val", n_images=1, size=64, seed=7)
    return tmp_path


def test_parser_has_the_jax_flags():
    """Every flag of the JAX CLI, as it is there; the port adds one of its
    own, --topology (the U-Net), whose default is annonet's net."""
    def table(parser):
        return {
            tuple(a.option_strings) or (a.dest,): (a.dest, a.default, a.choices, a.type,
                                                   a.nargs, type(a).__name__)
            for a in parser._actions
        }

    port = table(cli.build_parser())
    assert port.pop(("--topology",)) == ("topology", "segnet", ["segnet", "unet"], None,
                                         None, "_StoreAction")
    assert port == table(jax_cli.build_parser())


def _train(dataset, name, *extra):
    """annonet_train in-process on the small set: (exit code, its metrics
    events, the artifact's path)."""
    model, metrics = dataset / f"{name}.dnn", dataset / f"{name}.jsonl"
    rc = cli.main([str(dataset / "train"), *SMALL, "--max-total-steps", "3",
                   "--save-interval", "1000", "--output", str(model),
                   "--sync-file", str(dataset / f"{name}.dat"), "--metrics-jsonl",
                   str(metrics), "--metrics-interval", "1", *extra])
    with open(metrics) as f:
        return rc, [json.loads(line) for line in f], model


def test_mesh_run_on_virtual_shards(dataset, capsys, monkeypatch):
    """--mesh 2 under ANNONET_TPU_VIRTUAL_MESH=1: the minibatch of 4 stays,
    one of 3 is rounded up with JAX's message; the run trains data-parallel
    and its artifact loads into TiledInferer."""
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    monkeypatch.setenv("ANNONET_TPU_VIRTUAL_MESH", "1")
    rc, events, model = _train(dataset, "mesh", "--mesh", "2")
    assert rc == 0
    assert events[0]["event"] == "start" and events[0]["mesh"] == 2
    losses = [e["loss"] for e in events if e["event"] == "loss"]
    assert len(losses) == 3 and all(np.isfinite(losses))
    params, config, _classes, _factor = serialization.load_model(str(model))
    TiledInferer(params, config, device="cpu")
    rc, _events, _model = _train(dataset, "mesh3", "--mesh", "2", "-b", "3")
    assert rc == 0
    assert "Minibatch size rounded up to 4 (multiple of the 2-device mesh)" in \
        capsys.readouterr().out


def test_int8_training_run(dataset, monkeypatch):
    """--int8-training trains through the int8 straight-through convs (on
    the CPU their plain versions): exit 0, finite losses that differ from
    the float run's, an artifact the int8 inferer serves."""
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    calls = []
    from annonet_tpu_torch.ops import int8_train

    real = int8_train.Int8ConvSTE.apply
    monkeypatch.setattr(int8_train.Int8ConvSTE, "apply",
                        lambda *a: calls.append(a[-1]) or real(*a))
    rc, events, model = _train(dataset, "int8", "--int8-training")
    assert rc == 0
    losses = [e["loss"] for e in events if e["event"] == "loss"]
    assert len(losses) == 3 and all(np.isfinite(losses))
    # level 1: the stem's 2, enc1's 2 and dec1's 1 conv a step; one of stride 2
    assert len(calls) == 3 * 5 and calls.count(2) == 3
    _rc, float_events, _m = _train(dataset, "float")
    assert [e["loss"] for e in float_events if e["event"] == "loss"] != losses
    params, config, _classes, _factor = serialization.load_model(str(model))
    TiledInferer(params, config, device="cpu", quantize="int8")


@pytest.mark.parametrize("flag", [["--steps-per-dispatch", "4"], ["--no-compilation-cache"]])
def test_accepted_no_op_flags(tmp_path, capsys, monkeypatch, flag):
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    # an empty directory: the run gets past the flags and finds no dataset
    assert cli.main([str(tmp_path), *flag]) == 1
    captured = capsys.readouterr()
    assert "not ported" not in captured.err
    assert "Didn't find an anno dataset" in captured.out


def test_exit_codes(dataset, capsys, monkeypatch):
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    assert cli.main([]) == 1
    assert "./annonet_train /path/to/anno/data" in capsys.readouterr().out
    assert cli.main(["-b", "x", str(dataset)]) == 2
    assert cli.main([str(dataset / "train"), "-d", "0"]) == 2
    captured = capsys.readouterr()
    assert "Input directory" in captured.out  # the echo comes before the check
    assert "strictly positive" in captured.err
    assert cli.main([str(dataset / "train"), "--validation-quantize", "int8"]) == 1
    assert "requires --validation-directory" in capsys.readouterr().out
    # a diverging run fails inside the loop: exit 2, no artifact written
    model = dataset / "diverged.dnn"
    assert cli.main([str(dataset / "train"), *SMALL, "--initial-learning-rate", "1e30",
                     "--max-total-steps", "20", "--save-interval", "1000",
                     "--output", str(model), "--sync-file", str(dataset / "s.dat")]) == 2
    assert "diverged" in capsys.readouterr().out


def test_no_silent_cpu_run(dataset, capsys, monkeypatch):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLI rightly runs on it")
    monkeypatch.delenv(DEVICE_ENV, raising=False)
    assert cli.main([str(dataset / "train"), "--output", str(dataset / "a.dnn")]) == 1
    assert "no CUDA device" in capsys.readouterr().out
    assert not (dataset / "a.dnn").exists()


_NO_JAX = """
import sys
sys.modules["jax"] = None  # any import of jax, or of the JAX package, now raises
sys.modules["annonet_tpu"] = None
from annonet_tpu_torch.cli import train
data, val, out = sys.argv[1:4]
common = [data, "--level-count", "1", "--net-width-scaler", "0.5", "-b", "4",
          "--data-loader-thread-count", "2", "--deterministic-data", "-l", "-u", "-n", "2",
          "-o", "--multiplicative-brightness-change-probability", "0.5",
          "--validation-directory", val, "--output", out + "/a.dnn",
          "--sync-file", out + "/s.dat", "--save-interval", "2"]
assert train.main(common + ["--max-total-steps", "3"]) == 0
assert train.main(common + ["--max-total-steps", "2", "--validation-quantize", "int8",
                            "--device-image-cache", "off", "--remat"]) == 0
loaded = [m for m in sys.modules if sys.modules[m] is not None]
assert not any(m.split(".")[0] in ("jax", "annonet_tpu") for m in loaded)
print("trained without jax and annonet_tpu")
"""


def test_trains_validates_and_resumes_without_jax(dataset):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [REPO, env.get("PYTHONPATH")]))
    env[DEVICE_ENV] = "cpu"
    proc = subprocess.run([sys.executable, "-c", _NO_JAX, str(dataset / "train"),
                           str(dataset / "val"), str(dataset)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "trained without jax and annonet_tpu" in proc.stdout
    assert "resumed from" in proc.stdout and "at step 3" in proc.stdout
    assert proc.stdout.count("validation (step") == 5  # steps 0, 2, 3; then 0, 2 of the resumed run


def _losses(path):
    with open(path, encoding="utf-8") as f:
        return [e for e in map(json.loads, f) if e["event"] == "loss"]


def _train_f32(monkeypatch, path_in, path_out):
    """Both packages' SegNetConfig defaulting to f32 compute (the CLIs have
    no dtype flag), and a copy of the sync file ``path_in`` that declares
    f32 compute, so that either CLI resumes from it in f32."""
    import annonet_tpu.models.segnet as jax_segnet
    import annonet_tpu_torch.models.segnet as segnet

    for module in (jax_segnet, segnet):
        monkeypatch.setattr(module, "SegNetConfig", functools.partial(
            module.SegNetConfig, compute_dtype="float32"))
    trees, meta = serialization.load_trainer_state(path_in)
    meta["model_config"] = {**meta["model_config"], "compute_dtype": "float32"}
    serialization.save_trainer_state(path_out, trees, meta)


def _scaled_gaps(mine, theirs):
    """{leaf: max |mine - theirs| / max |theirs|} of two runtime nets."""
    theirs = dict(tree_items(theirs))
    return {k: float(np.abs(v - theirs[k]).max() / max(np.abs(theirs[k]).max(), 1e-12))
            for k, v in tree_items(mine)}


def test_cli_parity_run(dataset, monkeypatch):
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    data, val = str(dataset / "train"), str(dataset / "val")
    sync0 = str(dataset / "sync0.dat")
    assert jax_cli.main([data, *SMALL, "--max-total-steps", "0", "--output",
                         str(dataset / "step0.dnn"), "--sync-file", sync0]) == 0
    assert serialization.load_trainer_meta(sync0)["step_count"] == 0

    def resume(name, main, start):
        shutil.copy(start, dataset / f"{name}.dat")
        argv = [data, *SMALL, "--max-total-steps", "5", "--save-interval", "1000",
                "--output", str(dataset / f"{name}.dnn"), "--sync-file",
                str(dataset / f"{name}.dat"), "--metrics-jsonl",
                str(dataset / f"{name}.jsonl"), "--metrics-interval", "1"]
        assert main(argv) == 0
        assert serialization.load_trainer_meta(str(dataset / f"{name}.dat"))["step_count"] == 5
        load = (jax_serialization if main is jax_cli.main else serialization).load_model
        params, config, _c, _d = load(str(dataset / f"{name}.dnn"))
        return _losses(dataset / f"{name}.jsonl"), params, config.to_dict()

    runs = {name: resume(name, main, sync0)
            for name, main in (("jax", jax_cli.main), ("port", cli.main))}
    _train_f32(monkeypatch, sync0, str(dataset / "sync0_f32.dat"))
    runs.update({name: resume(name, main, str(dataset / "sync0_f32.dat"))
                 for name, main in (("jax32", jax_cli.main), ("port32", cli.main))})
    for mine, theirs in (("port", "jax"), ("port32", "jax32")):
        assert runs[mine][2] == runs[theirs][2]
        assert [e["step"] for e in runs[mine][0]] == [e["step"] for e in runs[theirs][0]]
        assert [e["learning_rate"] for e in runs[mine][0]] == [
            e["learning_rate"] for e in runs[theirs][0]]
    assert [e["step"] for e in runs["port"][0]] == [1, 2, 3, 4, 5]
    assert runs["port32"][2]["compute_dtype"] == "float32"
    # f32: the two CLIs train the same net, up to the summation order's
    # rounding, which grows from step to step (BN betas of ~1e-3 after one
    # step differ by ~1e-6 between the packages)
    for mine, theirs in zip(runs["port32"][0], runs["jax32"][0]):
        assert abs(mine["loss"] - theirs["loss"]) <= 2e-3 * abs(theirs["loss"])
    f32_gaps = _scaled_gaps(runs["port32"][1], runs["jax32"][1])
    assert max(f32_gaps.values()) <= 5e-3, f32_gaps
    # bf16 against JAX's bf16: the losses and the folded conv weights
    for mine, theirs in zip(runs["port"][0], runs["jax"][0]):
        assert abs(mine["loss"] - theirs["loss"]) <= 5e-2 * abs(theirs["loss"])
    bf16_gaps = _scaled_gaps(runs["port"][1], runs["jax"][1])
    assert max(v for k, v in bf16_gaps.items() if k.endswith("/w")) <= 5e-2, bf16_gaps
    # bf16 against the port's own f32 run: every leaf, the folded biases too
    drift = _scaled_gaps(runs["port"][1], runs["port32"][1])
    assert max(drift.values()) <= 5e-2, drift
    from annonet_tpu_torch.data.dataset import find_image_files
    from annonet_tpu_torch.data.sample import read_sample
    from annonet_tpu_torch.models.segnet import SegNetConfig

    files = find_image_files(val, require_ground_truth=True, verbose=False)
    image = read_sample(files[0], default_anno_classes()[:2], True, 1.0).input_image
    labels = {name: TiledInferer(params, SegNetConfig(**config), device="cpu")
              .infer_arrays(image)[0] for name, (_l, params, config) in runs.items()}
    assert (labels["port32"] == labels["jax32"]).mean() >= 0.995
    assert (labels["port"] == labels["port32"]).mean() >= 0.99
    assert (labels["port"] == labels["jax"]).mean() >= 0.97
