"""``annonet_serve`` of the port (annonet_tpu_torch/cli/serve.py) beside
the JAX package's server: both start in-process on ephemeral ports on one
JAX-written artifact of a small net (level 1, width 8, f32, tiles of 64),
and the same requests go to both. The routes, status codes, JSON keys,
metric names and the wire formats agree; float labels agree on >= 99.5% of
pixels and equal the port's own ``infer_arrays`` plus ``detection_veto``
bit for bit; --max-batch groups concurrent requests and each response
equals the unbatched one; the stall, compile-grace and RSS health signals;
the parser equals the JAX parser; --mesh beyond the visible devices exits
1; no silent CPU run.
The port runs on the CPU (ANNONET_TPU_TORCH_DEVICE=cpu), through the plain
versions of its kernels.
"""

import io
import json
import re
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from annonet_tpu import serialization as jax_serialization
from annonet_tpu.cli import serve as jax_serve
from annonet_tpu.models.segnet import SegNetConfig as JaxSegNetConfig
from annonet_tpu_torch.classes import anno_classes_to_json, default_anno_classes
from annonet_tpu_torch.cli import serve
from annonet_tpu_torch.cli.common import DEVICE_ENV
from annonet_tpu_torch.infer.core import detection_veto
from annonet_tpu_torch.models.segnet import SegNetConfig
from tests.test_torch_model import jax_runtime_tree

# f32: the two packages' bf16 nets round at other points, and on a
# random-weight net the blob veto turns a few flipped pixels into whole
# flipped blobs (99.35% on one 80x96 image at -d 1:0.5 -d 2:0.5)
CONFIG = dict(class_count=3, level_count=1, base_width=8, compute_dtype="float32")
TILES = ["--tile-max-width", "64", "--tile-max-height", "64"]
LABEL_AGREEMENT = 0.995


def save_artifact(path, seed: int, **overrides) -> str:
    """A JAX-written artifact of the small net (non-trivial BN, folded)."""
    cfg = dict(CONFIG, **overrides)
    config = SegNetConfig(**cfg)
    jax_serialization.save_model(
        str(path), jax_runtime_tree(config, seed), JaxSegNetConfig(**cfg),
        anno_classes_to_json(default_anno_classes()), 1.0,
    )
    return str(path)


def start(module, model: str, *extra):
    """(url, server, service) of ``module``'s server on an ephemeral port."""
    args = module.build_parser().parse_args(["--model", model, "--port", "0", *TILES, *extra])
    server, service = module.make_server(args)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    host, port = server.server_address[:2]
    return f"http://{host}:{port}", server, service


def stop(server) -> None:
    server.shutdown()
    server.server_close()


def request(url, body=None, method=None, headers=None):
    """(status, body, headers) of one request; HTTP errors are returned."""
    req = urllib.request.Request(url, data=body, method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read(), r.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers


def raw_labels(url, image, query=""):
    """format=labels of one image over the raw path: the uint16 map."""
    h, w, c = image.shape
    status, body, headers = request(
        f"{url}/infer?format=labels{query}", image.tobytes(), "POST",
        {"X-Image-Shape": f"{h},{w},{c}"})
    assert status == 200, body
    assert headers["X-Label-Shape"] == f"{h},{w}" and len(body) == 2 * h * w
    return np.frombuffer(body, "<u2").reshape(h, w)


def without_addresses(message: str) -> str:
    """An error message without the object addresses PIL puts in it."""
    return re.sub(r" at 0x[0-9a-f]+", "", message)


def png_bytes(image) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="PNG")
    return buf.getvalue()


def images(seed: int, shape=(80, 96)):
    return np.random.default_rng(seed).integers(0, 256, (*shape, 3), dtype=np.uint8)


@pytest.fixture(scope="module", autouse=True)
def port_on_cpu():
    """The port's servers of this module run on the CPU."""
    patch = pytest.MonkeyPatch()
    patch.setenv(DEVICE_ENV, "cpu")
    yield
    patch.undo()


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return save_artifact(tmp_path_factory.mktemp("serve") / "annonet.dnn", seed=3)


@pytest.fixture(scope="module")
def servers(model):
    """{"jax": (url, service), "port": (url, service)} on one artifact."""
    started = {name: start(mod, model) for name, mod in (("jax", jax_serve), ("port", serve))}
    yield {name: (url, svc) for name, (url, _server, svc) in started.items()}
    for _url, server, _svc in started.values():
        stop(server)


def get_json(url):
    status, body, _ = request(url)
    return status, json.loads(body)


def test_healthz_and_model_match_the_jax_server(servers):
    for route in ("/healthz", "/model"):
        (jcode, jdoc), (pcode, pdoc) = (get_json(servers[n][0] + route) for n in ("jax", "port"))
        assert jcode == pcode == 200
        assert set(pdoc) == set(jdoc)
        # times, counters and what each package counts as compiled differ
        varying = {"loaded_at", "compiled_programs", "requests_served",
                   "batches_dispatched", "device_busy_seconds"}
        assert {k: v for k, v in pdoc.items() if k not in varying} == \
            {k: v for k, v in jdoc.items() if k not in varying}
    assert pdoc["classes"] == ["clean", "minor defect", "major defect"]


def test_metric_names_and_stats_keys_match(servers):
    names, stats = {}, {}
    for name, (url, _svc) in servers.items():
        raw_labels(url, images(0))  # a request, so that the latency metrics appear
        status, body, headers = request(url + "/metrics")
        assert status == 200 and headers["Content-Type"].startswith("text/plain; version=0.0.4")
        lines = body.decode().splitlines()
        names[name] = {ln.split("{")[0].split()[0] for ln in lines if not ln.startswith("#")}
        assert {ln.split()[2] for ln in lines if ln.startswith("# TYPE")} <= names[name]
        stats[name] = get_json(url + "/stats")[1]
    assert names["port"] == names["jax"]
    assert "annonet_request_latency_seconds" in names["port"]
    assert set(stats["port"]) == set(stats["jax"])
    assert set(stats["port"]["latency_ms"]) == set(stats["jax"]["latency_ms"])
    assert stats["port"]["compiled_programs"] >= 1


_BAD = [
    # (method, route, body, headers)
    ("POST", "/infer", b"this is not an image", {}),
    ("POST", "/infer", b"", {}),
    ("POST", "/infer?format=bogus", "png", {}),
    ("POST", "/infer?gain=notaclass", "png", {}),
    ("POST", "/infer?gain=7:1.0", "png", {}),
    ("POST", "/infer?detection=1:-0.5", "png", {}),
    ("POST", "/infer", bytes(300), {"X-Image-Shape": "10,10"}),
    ("POST", "/infer", bytes(300), {"X-Image-Shape": "10,10,4"}),
    ("POST", "/infer", bytes(299), {"X-Image-Shape": "10,10,3"}),
    ("GET", "/nope", None, {}),
    ("POST", "/nope", b"x", {}),
    ("GET", "/calibration", None, {}),
]


@pytest.mark.parametrize("method, route, body, headers", _BAD)
def test_bad_requests_get_the_jax_status_and_message(servers, method, route, body, headers):
    if body == "png":
        body = png_bytes(images(1))
    got = {}
    for name, (url, _svc) in servers.items():
        status, payload, _ = request(url + route, body, method, headers)
        got[name] = (status, without_addresses(json.loads(payload)["error"]))
    assert got["port"][0] == got["jax"][0] in (400, 404, 409)
    assert got["port"][1] == got["jax"][1]


@pytest.mark.parametrize("query", ["", "&gain=1:0.3", "&detection=1:0.5&detection=2:0.5"])
def test_float_labels_agree_and_equal_the_ports_own_inferer(servers, query):
    port_url, port_svc = servers["port"]
    gains = [0.0, 0.3, 0.0] if "gain" in query else None
    levels = [0.0, 0.5, 0.5] if "detection" in query else None
    for seed, shape in ((2, (80, 96)), (3, (150, 130))):
        image = images(seed, shape)
        ours = raw_labels(port_url, image, query)
        theirs = raw_labels(servers["jax"][0], image, query)
        assert (ours == theirs).mean() >= LABEL_AGREEMENT
        labels, seeds = port_svc.inferer.infer_arrays(image, gains, levels)
        np.testing.assert_array_equal(ours, detection_veto(labels, seeds))
        # the encoded path decodes to the same pixels
        status, body, headers = request(f"{port_url}/infer?format=labels{query}",
                                        png_bytes(image), "POST")
        assert status == 200 and float(headers["X-Inference-Ms"]) >= 0
        np.testing.assert_array_equal(np.frombuffer(body, "<u2").reshape(shape), ours)


def test_counts_and_png_formats(servers):
    image = images(4, (64, 72))
    port_url, port_svc = servers["port"]
    labels = raw_labels(port_url, image)
    counts = {}
    for name, (url, _svc) in servers.items():
        status, body, _ = request(url + "/infer?format=counts", png_bytes(image), "POST")
        assert status == 200
        counts[name] = json.loads(body)
    assert set(counts["port"]) == set(counts["jax"]) == {"counts", "inference_ms"}
    assert list(counts["port"]["counts"]) == ["clean", "minor defect", "major defect"]
    assert sum(counts["port"]["counts"].values()) == 64 * 72
    assert list(counts["port"]["counts"].values()) == np.bincount(labels.ravel(),
                                                                 minlength=3).tolist()
    status, body, headers = request(port_url + "/infer", png_bytes(image), "POST")
    assert status == 200 and headers["Content-Type"] == "image/png"
    with Image.open(io.BytesIO(body)) as im:
        assert im.mode == "RGBA" and im.size == (72, 64)
        rgba = np.asarray(im)
    palette = np.array([c.rgba_label for c in default_anno_classes()], np.uint8)
    np.testing.assert_array_equal(rgba, palette[labels])
    # the same labels encode to the JAX server's bytes
    assert body == servers["jax"][1].encode_png(labels) == port_svc.encode_png(labels)


def test_gain_and_detection_overrides_move_both_servers(servers):
    image = images(5)
    for name, (url, _svc) in servers.items():
        assert (raw_labels(url, image, "&gain=2:1000") == 2).all(), name
    plain = {name: raw_labels(url, image) for name, (url, _svc) in servers.items()}
    vetoed = {name: raw_labels(url, image, "&detection=1:3&detection=2:3")
              for name, (url, _svc) in servers.items()}
    for name in servers:
        # a high level leaves fewer seeds: blobs go back to class 0, never away from it
        assert ((vetoed[name] == plain[name]) | (vetoed[name] == 0)).all()
        assert (vetoed[name] != plain[name]).any()
    assert (vetoed["port"] == vetoed["jax"]).mean() >= LABEL_AGREEMENT


@pytest.mark.parametrize("grayscale", [False, True])
@pytest.mark.parametrize("channels", [1, 3])
def test_decode_raw_and_decode_convert_as_the_jax_server(grayscale, channels):
    class Cfg:
        pass

    class Svc:
        config = Cfg()

    Svc.config.grayscale = grayscale
    image = np.random.default_rng(6).integers(0, 256, (17, 23, channels), dtype=np.uint8)
    ours = serve._ModelService.decode_raw(Svc(), image.tobytes(), f"17,23,{channels}")
    theirs = jax_serve._ModelService.decode_raw(Svc(), image.tobytes(), f"17,23,{channels}")
    np.testing.assert_array_equal(ours, theirs)
    assert ours.shape == (17, 23, 1 if grayscale else 3)
    encoded = png_bytes(image[..., 0] if channels == 1 else image)
    np.testing.assert_array_equal(serve._ModelService.decode(Svc(), encoded),
                                  jax_serve._ModelService.decode(Svc(), encoded))


@pytest.fixture(scope="module")
def batched(model):
    url, server, service = start(serve, model, "--max-batch", "4", "--batch-window-ms", "500",
                                 "-d", "1:0.5")
    yield url, service
    stop(server)


def test_dynamic_batching_equals_unbatched(batched):
    """8 concurrent same-size requests with --max-batch 4: fewer device
    calls than requests, each response the unbatched result bit for bit."""
    url, service = batched
    inputs = [images(10 + i, (72, 88)) for i in range(8)]
    raw_labels(url, inputs[0])  # the plan's constants first
    before = service.batches_dispatched
    results, errors = {}, []

    def one(i):
        try:
            results[i] = raw_labels(url, inputs[i])
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and len(results) == 8
    assert not any(t.is_alive() for t in threads)
    dispatched = service.batches_dispatched - before
    assert 2 <= dispatched < 8
    for i, image in enumerate(inputs):
        labels, seeds = service.inferer.infer_arrays(image, detection_levels=[0.0, 0.5, 0.0])
        np.testing.assert_array_equal(results[i], detection_veto(labels, seeds))


STAGES = ["read body", "decode", "downscale", "device section", "detection veto", "resize",
          "encode and send"]


@pytest.mark.parametrize("with_batching", [False, True])
def test_last_request_stages_are_the_servers_own(servers, batched, with_batching):
    """A 200 /infer leaves its stages, in ms, on the service: the batched
    server splits its wait in the batch window from the device section; a
    400 leaves the last answered request's stages in place."""
    url, service = batched if with_batching else servers["port"]
    before = service.last_request_stages
    raw_labels(url, images(4))
    # the handler records a request's stages after its response is sent
    deadline = time.monotonic() + 10.0
    while service.last_request_stages is before and time.monotonic() < deadline:
        time.sleep(0.01)
    stages = service.last_request_stages
    expected = list(STAGES)
    if with_batching:
        expected.insert(3, "batch wait")
    assert list(stages) == expected
    assert all(v >= 0.0 for v in stages.values())
    assert stages["device section"] > 0.0
    assert request(f"{url}/infer", b"not an image", "POST")[0] == 400
    assert service.last_request_stages is stages


def test_device_stall_indicator(servers):
    """A device section older than --device-stall-seconds turns healthz
    503 "stalled" and raises annonet_device_stalled; released, it is ok."""
    url, service = servers["port"]
    status, health = get_json(url + "/healthz")
    assert (status, health["status"], health["device_busy_seconds"]) == (200, "ok", None)
    old = service.device_stall_seconds
    service.device_stall_seconds = 1.0
    entered, release = threading.Event(), threading.Event()

    def hold():
        with service._device_section():
            entered.set()
            release.wait(timeout=60)

    holder = threading.Thread(target=hold, daemon=True)
    holder.start()
    try:
        assert entered.wait(timeout=10)
        status, health = get_json(url + "/healthz")
        assert status == 200 and health["device_busy_seconds"] >= 0.0
        time.sleep(1.2)
        status, health = get_json(url + "/healthz")
        assert (status, health["status"]) == (503, "stalled")
        assert "annonet_device_stalled 1" in request(url + "/metrics")[1].decode()
    finally:
        release.set()
        holder.join(timeout=10)
        service.device_stall_seconds = old
    assert not holder.is_alive()
    assert get_json(url + "/healthz")[1]["status"] == "ok"
    assert "annonet_device_stalled 0" in request(url + "/metrics")[1].decode()


def test_first_shape_compile_grace(servers):
    """The first section of an input shape gets the compile grace; the
    same shape's next section only --device-stall-seconds."""
    _url, service = servers["port"]
    old = service.device_stall_seconds
    service.device_stall_seconds = 1.0
    key = ("test-grace", (32, 32, 3))
    entered, release = threading.Event(), threading.Event()

    def hold():
        with service._device_section(key=key):
            entered.set()
            release.wait(timeout=60)

    try:
        for stalled in (False, True):
            entered.clear()
            release.clear()
            holder = threading.Thread(target=hold, daemon=True)
            holder.start()
            assert entered.wait(timeout=10)
            time.sleep(1.2)
            assert service.device_busy_seconds() > 1.0
            assert service.device_stalled() is stalled
            release.set()
            holder.join(timeout=10)
            assert not holder.is_alive()
    finally:
        release.set()
        service.device_stall_seconds = old


def test_device_sections_cover_every_device_path():
    import inspect

    src = inspect.getsource(serve._ModelService)
    assert src.count("with self._device_section(") >= 3
    for fn in (serve._ModelService._device_pass, serve._ModelService._dispatch_loop):
        assert "with self.device_lock:" not in inspect.getsource(fn)


@pytest.mark.parametrize("limit, status", [(None, "ok"), ("1", "rss-exceeded"),
                                           ("1000000", "ok")])
def test_max_rss_guard(model, limit, status):
    argv = ["--model", model, *TILES] + ([] if limit is None else ["--max-rss-mb", limit])
    service = serve._ModelService(serve.build_parser().parse_args(argv))
    assert service.healthz()["status"] == status
    assert f"annonet_rss_exceeded {int(status != 'ok')}" in service.metrics_text()
    assert service.stats()["rss_mb"] > 1.0


@pytest.mark.parametrize("flag", [[], ["--reference-blend-semantics"]])
def test_reference_blend_semantics_reaches_the_inferer(model, flag):
    service = serve._ModelService(serve.build_parser().parse_args(["--model", model, *flag]))
    assert service.inferer.reference_blend_semantics is bool(flag)
    assert service.inferer.tiling.max_tile_width == 1024  # the default tile max


def test_warmup_runs_the_plan_and_rejects_bad_specs(model, capsys):
    service = serve._ModelService(serve.build_parser().parse_args(["--model", model, *TILES]))
    serve._warmup(service, ["72x80"])
    assert "Warming up 72x80" in capsys.readouterr().out
    assert service.requests_served == 0 and service.stats()["latency_window"] == 0
    assert service.inferer.compiled_programs == 1
    for spec in ("72by80", "0x80"):
        with pytest.raises(RuntimeError, match="bad --warmup size"):
            serve._warmup(service, [spec])


def test_parser_has_the_jax_flags():
    def table(parser):
        return {
            tuple(a.option_strings) or (a.dest,): (a.dest, a.default, a.choices, a.type,
                                                   a.nargs, type(a).__name__)
            for a in parser._actions
        }

    assert table(serve.build_parser()) == table(jax_serve.build_parser())
    assert serve.build_parser().prog == jax_serve.build_parser().prog == "annonet_serve"


def test_mesh_exits_2_and_no_compilation_cache_is_accepted(model, capsys, monkeypatch):
    # --mesh is ported: beyond the visible devices it is a setup error
    # (exit 1, JAX's make_mesh message), never a silent run on fewer
    monkeypatch.delenv("ANNONET_TPU_VIRTUAL_MESH", raising=False)
    assert serve.main(["--model", model, "--mesh", "2"]) == 1
    out = capsys.readouterr()
    assert "requested 2 devices but only 1 available" in out.out
    assert "not ported" not in out.err
    args = serve.build_parser().parse_args(["--model", model, "--no-compilation-cache"])
    assert args.no_compilation_cache is True


def test_no_silent_cpu_run(model, capsys, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the server rightly runs on it")
    monkeypatch.delenv(DEVICE_ENV, raising=False)
    assert serve.main(["--model", model, "--port", "0"]) == 1
    assert "no CUDA device" in capsys.readouterr().out
