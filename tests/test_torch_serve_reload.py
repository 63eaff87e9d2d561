"""The port's ``annonet_serve``: hot reload, the int8 server and its
calibration endpoint, the warm-up rule, and the process's signals.

Reload: a retrained artifact of the same config takes the fast swap and
then serves labels equal to a fresh inferer's on the new weights; a
corrupt artifact keeps the old model (409); a stale --calibration file is
409 until ?recalibrate=1; a config change takes the full rebuild;
--watch-model reloads on an mtime change. int8: the port's server and the
JAX server on one --calibration file agree on >= 99% of labels (the bf16
``up`` drift, ROADMAP section 3); /calibration is 409 until a real image
froze one, then its bytes load in both packages and equal
``export_calibration``; a gray warm-up image freezes nothing. SIGTERM
ends a server process with exit code 0.
"""

import io
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from annonet_tpu import serialization as jax_serialization
from annonet_tpu.cli import serve as jax_serve
from annonet_tpu_torch import serialization
from annonet_tpu_torch.cli import serve
from annonet_tpu_torch.cli.common import DEVICE_ENV
from annonet_tpu_torch.infer.core import TiledInferer, annonet_infer
from annonet_tpu_torch.infer.tiling import TilingParameters
from tests.test_torch_serve import (
    TILES,
    get_json,
    images,
    raw_labels,
    request,
    save_artifact,
    start,
    stop,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    monkeypatch.setenv(DEVICE_ENV, "cpu")


def get_json_post(url):
    status, body, _ = request(url, b"", "POST")
    return status, json.loads(body)


def fresh_labels(model, image):
    """The labels of a new inferer on ``model``'s weights (the server's tiling)."""
    params, config, _classes, _ds = serialization.load_model(model)
    inferer = TiledInferer(params, config, TilingParameters(64, 64, 14, 14), device="cpu")
    return annonet_infer(inferer, image)


def test_reload_fast_swap_serves_the_new_weights(tmp_path):
    model = save_artifact(tmp_path / "annonet.dnn", seed=0)
    url, server, service = start(serve, model)
    try:
        image = images(20)
        before = raw_labels(url, image)
        np.testing.assert_array_equal(before, fresh_labels(model, image))
        inferer, constants = service.inferer, service.inferer.compiled_programs
        save_artifact(model, seed=1)
        status, info = get_json_post(url + "/reload")
        assert status == 200
        assert info["fast_swap"] is True and info["reload_count"] == 1
        assert info["warmed"] == [] and info["quantize"] == "none"
        assert service.inferer is inferer and inferer.compiled_programs == constants
        after = raw_labels(url, image)
        np.testing.assert_array_equal(after, fresh_labels(model, image))
        assert (after != before).any()
        assert get_json(url + "/model")[1]["reload_count"] == 1
    finally:
        stop(server)


def test_failed_reload_keeps_the_old_model(tmp_path):
    model = save_artifact(tmp_path / "annonet.dnn", seed=0)
    url, server, service = start(serve, model)
    try:
        image = images(21)
        before = raw_labels(url, image)
        with open(model, "wb") as f:
            f.write(b"not an npz archive")
        status, info = get_json_post(url + "/reload")
        assert status == 409 and "error" in info
        assert service.state.reload_count == 0
        np.testing.assert_array_equal(raw_labels(url, image), before)
    finally:
        stop(server)


def test_config_change_takes_the_full_rebuild(tmp_path, capsys):
    model = save_artifact(tmp_path / "annonet.dnn", seed=0)
    url, server, service = start(serve, model, "--warmup", "64x64")
    try:
        old = service.inferer
        save_artifact(model, seed=2, base_width=4)
        status, info = get_json_post(url + "/reload")
        assert status == 200 and info["fast_swap"] is False
        assert info["warmed"] == ["64x64"]
        assert "Warming up 64x64" in capsys.readouterr().out
        assert service.inferer is not old and service.config.base_width == 4
        image = images(22)
        np.testing.assert_array_equal(raw_labels(url, image), fresh_labels(model, image))
    finally:
        stop(server)


def test_watch_model_reloads_on_an_mtime_change(tmp_path):
    model = save_artifact(tmp_path / "annonet.dnn", seed=0)
    service = serve._ModelService(serve.build_parser().parse_args(["--model", model, *TILES]))
    stop_watch = service.start_model_watch(0.05)
    try:
        inferer = service.inferer
        save_artifact(model, seed=9)
        os.utime(model, (os.path.getmtime(model) + 2,) * 2)
        deadline = time.monotonic() + 15.0
        while service.state.reload_count == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert service.state.reload_count == 1
        assert service.inferer is inferer  # the fast swap
    finally:
        stop_watch.set()


@pytest.fixture(scope="module")
def int8_files(tmp_path_factory):
    """A model and a calibration file of it (the port's int8 inferer on
    one image, saved by the port; both packages load it)."""
    root = tmp_path_factory.mktemp("int8")
    model = save_artifact(root / "annonet.dnn", seed=5)
    params, config, _classes, _ds = serialization.load_model(model)
    inferer = TiledInferer(params, config, TilingParameters(64, 64, 14, 14), device="cpu",
                           quantize="int8")
    inferer.infer_arrays(images(30, (96, 112)))
    calib = str(root / "calib.npz")
    serialization.save_calibration(calib, inferer.export_calibration(), config, params)
    return model, calib


def test_int8_server_agrees_with_the_jax_int8_server(int8_files):
    model, calib = int8_files
    started = [start(mod, model, "--quantize", "int8", "--calibration", calib, "-d", "1:0.5")
               for mod in (jax_serve, serve)]
    try:
        (jax_url, _s, _v), (url, _server, service) = started
        for seed, shape in ((31, (80, 96)), (32, (150, 130))):
            image = images(seed, shape)
            ours, theirs = raw_labels(url, image), raw_labels(jax_url, image)
            assert (ours == theirs).mean() >= 0.99
        assert service.inferer._quantized and service.inferer.float_fallbacks == 0
        status, body, _ = request(url + "/calibration")
        assert status == 200 and body == open(calib, "rb").read()
    finally:
        for _url, server, _svc in started:
            stop(server)


def test_stale_calibration_is_409_until_recalibrate(int8_files, tmp_path):
    model, calib = int8_files
    model = save_artifact(tmp_path / "annonet.dnn", seed=5)  # the calibrated weights
    url, server, service = start(serve, model, "--quantize", "int8", "--calibration", calib)
    try:
        save_artifact(model, seed=6)  # retrained: the calibration is stale
        status, info = get_json_post(url + "/reload")
        assert status == 409 and "different trained weights" in info["error"]
        assert service.state.reload_count == 0
        status, info = get_json_post(url + "/reload?recalibrate=1")
        assert status == 200 and info["recalibrate"] is True and info["fast_swap"] is True
        status, _body, _ = request(url + "/calibration")
        assert status == 409  # the new weights calibrate on the next real image
        raw_labels(url, images(33))
        assert request(url + "/calibration")[0] == 200
    finally:
        stop(server)


def test_calibration_endpoint_and_the_warmup_rule(tmp_path, capsys):
    model = save_artifact(tmp_path / "annonet.dnn", seed=7)
    url, server, service = start(serve, model, "--quantize", "int8")
    try:
        serve._warmup(service, ["64x64"])
        assert "no --calibration given" in capsys.readouterr().out
        assert not service.inferer._calib_frozen and not service.inferer._calib_seen
        status, body, _ = request(url + "/calibration")
        assert status == 409 and b"no int8 calibration frozen yet" in body
        raw_labels(url, images(34))
        status, body, headers = request(url + "/calibration")
        assert status == 200 and headers["Content-Type"] == "application/octet-stream"
        assert "annonet_calibration.npz" in headers["Content-Disposition"]
        exported = service.inferer.export_calibration()
        assert body == serialization.calibration_npz_bytes(exported, service.config,
                                                           service.params)
        for load in (serialization.load_calibration, jax_serialization.load_calibration):
            params, config, _c, _d = jax_serialization.load_model(model)
            loaded = load(io.BytesIO(body), config, params)
            assert len(loaded) == len(exported)
            for a, b in zip(loaded, exported):
                np.testing.assert_array_equal(a, b)
    finally:
        stop(server)


def test_sigterm_ends_the_server_with_exit_0(tmp_path):
    model = save_artifact(tmp_path / "annonet.dnn", seed=0)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [REPO, os.environ.get(
        "PYTHONPATH")])))
    env[DEVICE_ENV] = "cpu"
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "annonet_tpu_torch.cli.serve", "--model", model,
         "--port", "0", *TILES],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        lines = []
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if "listening on" in line:
                break
        assert any("listening on" in ln for ln in lines), "".join(lines)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
        assert "SIGTERM" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
