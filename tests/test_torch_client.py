"""The clients against both servers: ``annonet_tpu_torch/client.py`` (the
port's copy of the Python client) and ``annonet_tpu/client.py`` each
against the port's ``annonet_serve`` and the JAX package's, with the same
labels, counts, PNGs and errors from both clients on one server; and the
C++ client (``native/annonet_client.cpp``) against the port's server,
skipped without g++ as tests/test_client.py skips.
"""

import io

import numpy as np
import pytest
from PIL import Image

from annonet_tpu import client as jax_client
from annonet_tpu.cli import serve as jax_serve
from annonet_tpu_torch import client
from annonet_tpu_torch.cli import serve
from annonet_tpu_torch.cli.common import DEVICE_ENV
from tests.test_client import _Client, _png_bytes, _urllib_labels
from tests.test_client import client_lib  # noqa: F401 — the C client fixture
from tests.test_torch_serve import (
    images,
    raw_labels,
    save_artifact,
    start,
    stop,
    without_addresses,
)

_CLIENTS = {"port": client, "jax": jax_client}


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """{"port": (host, port, url), "jax": ...}: both servers on one artifact."""
    patch = pytest.MonkeyPatch()
    patch.setenv(DEVICE_ENV, "cpu")
    model = save_artifact(tmp_path_factory.mktemp("clients") / "annonet.dnn", seed=4)
    started = {name: start(mod, model) for name, mod in (("port", serve), ("jax", jax_serve))}
    out = {}
    for name, (url, server, _svc) in started.items():
        host, port = server.server_address[:2]
        out[name] = (host, port, url)
    yield out
    for _url, server, _svc in started.values():
        stop(server)
    patch.undo()


@pytest.mark.parametrize("server_name", ["port", "jax"])
def test_both_python_clients_get_the_same_results(servers, server_name):
    host, port, url = servers[server_name]
    image = images(40, (70, 90))
    got = {}
    for name, module in _CLIENTS.items():
        c = module.ServeClient(host, port, timeout=60)
        health = c.healthz()
        assert health["status"] == "ok" and len(health["classes"]) == 3
        assert c.model_info()["class_count"] == 3
        labels = c.infer(image)
        assert labels.dtype == np.uint16 and labels.shape == (70, 90)
        np.testing.assert_array_equal(labels, c.infer(_png_bytes(image)))
        np.testing.assert_array_equal(labels, raw_labels(url, image))
        got[name] = {
            "labels": labels,
            "gray": c.infer(image[..., 0]),
            "gains": c.infer(image, gains={1: 0.4}),
            "gains_seq": c.infer(image, gains=[0.0, 0.4, 0.0]),
            "detection": c.infer(image, detection_levels={1: 0.5, 2: 0.5}),
            "counts": c.class_counts(image, gains={2: 0.2}),
            "png": c.infer_png(image),
            "stats_keys": sorted(c.stats()),
        }
        np.testing.assert_array_equal(got[name]["gains"], got[name]["gains_seq"])
        assert sum(got[name]["counts"].values()) == 70 * 90
        with Image.open(io.BytesIO(got[name]["png"])) as im:
            assert im.mode == "RGBA" and im.size == (90, 70)
    for key, value in got["port"].items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(value, got["jax"][key])
        else:
            assert value == got["jax"][key], key


@pytest.mark.parametrize("server_name", ["port", "jax"])
def test_both_python_clients_raise_the_same_errors(servers, server_name):
    host, port, _url = servers[server_name]
    errors = {}
    for name, module in _CLIENTS.items():
        c = module.ServeClient(host, port, timeout=60)
        with pytest.raises(ValueError, match="uint8"):
            c.infer(np.zeros((4, 4, 3), np.float32))
        with pytest.raises(ValueError, match="expected"):
            c.infer(np.zeros((4, 4, 2), np.uint8))
        caught = []
        for call in (lambda: c.infer(b"not an image"),
                     lambda: c.infer(np.zeros((8, 8, 3), np.uint8), gains={7: 1.0}),
                     c.calibration):
            with pytest.raises(module.ServeError) as e:
                call()
            caught.append((e.value.status, without_addresses(str(e.value))))
        errors[name] = caught
    assert errors["port"] == errors["jax"]
    assert [status for status, _ in errors["port"]] == [400, 400, 409]


def test_connection_refused_is_a_serve_error():
    with pytest.raises(client.ServeError) as e:
        client.ServeClient("127.0.0.1", 1, timeout=5).healthz()
    assert e.value.status is None


def test_reload_through_the_ports_client(servers):
    host, port, _url = servers["port"]
    info = client.ServeClient(host, port, timeout=60).reload()
    assert info["status"] == "reloaded" and info["fast_swap"] is True


def test_c_client_against_the_ports_server(client_lib, servers):  # noqa: F811
    host, port, _url = servers["port"]
    c = _Client(client_lib, host, port)
    try:
        rc, info = c.healthz()
        assert rc == 0, c.last_error
        assert info["status"] == "ok" and [k["label"] for k in info["classes"]] == [
            "clean", "minor defect", "major defect"]
        arr = images(41, (72, 88))
        png = _png_bytes(arr)
        rc, via_png = c.infer(png)
        assert rc == 0, c.last_error
        np.testing.assert_array_equal(via_png, _urllib_labels(host, port, png))
        rc, via_raw = c.infer(arr.tobytes(), raw_shape=arr.shape)
        assert rc == 0, c.last_error
        np.testing.assert_array_equal(via_raw, via_png)
        rc, gained = c.infer(png, params="gain=1:25.0")
        assert rc == 0, c.last_error
        np.testing.assert_array_equal(gained, _urllib_labels(host, port, png, "&gain=1:25.0"))
        rc, _ = c.infer(bytes(10 * 10 * 3), raw_shape=(10, 10, 3),
                        params="format=labels&gain=bogus")
        assert rc != 0 and "HTTP 400" in c.last_error
    finally:
        c.close()
