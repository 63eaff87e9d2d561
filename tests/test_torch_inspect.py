"""``annonet_inspect`` of the port (annonet_tpu_torch/cli/inspect.py)
against the JAX package's: the same JSON for the same artifact, with and
without --weights-fingerprint and --calibration (a matching and a stale
file), and exit 1 with a one-line JSON diagnosis on a corrupt model. The
port's device probe (cli/common.py::device_probe): its success, timeout,
error and off paths, and the entry points that call it. And the serving
slice without jax: the port's server, client and inspect in a process
that cannot import jax or the JAX package.
"""

import json
import os
import subprocess
import sys
import time

import pytest

from annonet_tpu.cli import inspect as jax_inspect
from annonet_tpu_torch import serialization
from annonet_tpu_torch.cli import common
from annonet_tpu_torch.cli import inspect
from annonet_tpu_torch.cli.common import DEVICE_ENV
from annonet_tpu_torch.infer.core import TiledInferer
from tests.test_artifact_fuzz import _write_corpus
from tests.test_torch_serve import images, save_artifact

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A model, a calibration file of it and one of another model's weights."""
    root = tmp_path_factory.mktemp("inspect")
    model = save_artifact(root / "annonet.dnn", seed=1)
    other = save_artifact(root / "other.dnn", seed=2)
    calibs = []
    for name, path in (("calib.npz", model), ("stale.npz", other)):
        params, config, _c, _d = serialization.load_model(path)
        inferer = TiledInferer(params, config, device="cpu", quantize="int8")
        inferer.infer_arrays(images(3, (64, 64)))
        calibs.append(str(root / name))
        serialization.save_calibration(calibs[-1], inferer.export_calibration(), config, params)
    return model, calibs


def run(main, argv, capsys):
    code = main(argv)
    return code, json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("extra", [[], ["--weights-fingerprint"], ["--calibration", 0],
                                   ["--calibration", 1]])
def test_json_equals_the_jax_tool(files, extra, capsys):
    model, calibs = files
    extra = [calibs[e] if isinstance(e, int) else e for e in extra]
    ours = run(inspect.main, [model, *extra], capsys)
    theirs = run(jax_inspect.main, [model, *extra], capsys)
    assert ours == theirs
    code, doc = ours
    assert code == 0 and doc["model_config"]["base_width"] == 8
    if "--calibration" in extra:
        assert doc["calibration"]["matches_model"] is (extra[1] == calibs[0])


def test_corrupt_model_exits_1_with_a_json_diagnosis(tmp_path, capsys):
    from pathlib import Path

    for p in _write_corpus(tmp_path, Path(save_artifact(tmp_path / "annonet.dnn", seed=1))):
        code = inspect.main([str(p)])
        out, err = capsys.readouterr()
        assert code == 1, (p.name, out, err)
        assert "Traceback" not in out + err
        doc = json.loads(out)
        assert set(doc) == {"error", "model"} and doc["model"] == str(p)
        assert jax_inspect.main([str(p)]) == 1
        capsys.readouterr()


def test_device_probe_passes_on_the_cpu():
    import torch

    t0 = time.monotonic()
    common.device_probe(torch.device("cpu"), timeout_s=30)
    assert time.monotonic() - t0 < 30


def test_device_probe_timeout_raises_with_the_triage_text():
    with pytest.raises(RuntimeError, match="did not complete within 0.2 s"):
        common.device_probe("cpu", timeout_s=0.2, on_timeout="raise",
                            _op=lambda: time.sleep(5))


def test_device_probe_timeout_exits_1_by_default():
    code = ("import time\n"
            "from annonet_tpu_torch.cli.common import device_probe\n"
            "device_probe('cpu', timeout_s=0.2, _op=lambda: time.sleep(30))\n"
            "print('not reached')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("ANNONET_TPU_DEVICE_PROBE_ON_TIMEOUT", None)
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 1, proc.stderr
    assert "did not complete within 0.2 s" in proc.stdout and "not reached" not in proc.stdout


def test_device_probe_errors_propagate_and_zero_disables(monkeypatch):
    def boom():
        raise ValueError("no context")

    with pytest.raises(RuntimeError, match="device probe failed: no context"):
        common.device_probe("cpu", timeout_s=5, _op=boom)
    monkeypatch.setenv("ANNONET_TPU_DEVICE_PROBE_TIMEOUT", "0")
    common.device_probe("cpu", _op=boom)  # disabled: the op never runs


def test_every_device_entry_point_probes():
    import inspect as source

    from annonet_tpu_torch.cli import infer, serve, train

    for fn in (infer._run, train._run_impl, serve.main):
        src = source.getsource(fn)
        assert "device_probe(device)" in src, fn.__qualname__
        assert src.index("resolve_device(") < src.index("device_probe(device)")


_NO_JAX = """
import sys
sys.modules["jax"] = None  # any import of jax, or of the JAX package, now raises
sys.modules["annonet_tpu"] = None
import contextlib, io, json, threading
import numpy as np
from annonet_tpu_torch.cli import inspect, serve
from annonet_tpu_torch.client import ServeClient
model = sys.argv[1]
args = serve.build_parser().parse_args(["--model", model, "--port", "0", "--quantize", "int8",
                                        "--tile-max-width", "64", "--tile-max-height", "64"])
server, service = serve.make_server(args)
threading.Thread(target=server.serve_forever, daemon=True).start()
client = ServeClient(*server.server_address[:2], timeout=60)
image = np.random.default_rng(0).integers(0, 256, (70, 90, 3), dtype=np.uint8)
labels = client.infer(image, detection_levels={1: 0.5})
assert labels.shape == (70, 90) and service.inferer._quantized
assert len(client.calibration()) > 0
server.shutdown()
out = io.StringIO()
with contextlib.redirect_stdout(out):
    assert inspect.main([model, "--weights-fingerprint"]) == 0
assert json.loads(out.getvalue())["weights_fingerprint"]
loaded = [m for m in sys.modules if sys.modules[m] is not None]
assert not any(m.split(".")[0] in ("jax", "annonet_tpu") for m in loaded)
print("served and inspected without jax and annonet_tpu")
"""


def test_serve_client_and_inspect_run_without_jax(files):
    model, _calibs = files
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [REPO, os.environ.get(
        "PYTHONPATH")])))
    env[DEVICE_ENV] = "cpu"
    proc = subprocess.run([sys.executable, "-c", _NO_JAX, model], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "without jax and annonet_tpu" in proc.stdout
