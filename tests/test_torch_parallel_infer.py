"""Tile-parallel inference on the port (``TiledInferer(mesh=...)``,
``annonet_infer --mesh``, ``annonet_serve --mesh``) against the same
inferer on one device, and against the JAX package's inferer on its
virtual 8-device CPU mesh.

The port's meshes here are virtual (``parallel.mesh.ensure_virtual_devices``,
ANNONET_TPU_VIRTUAL_MESH=1): N shards on the CPU, so the split, the
per-shard forwards and the gather run as on N cards. Against one device,
logits, labels and seeds are equal bit for bit on the float, int8 and
folded paths; the deep case (level 3, width 16, f32, four 96-px tiles)
puts single tiles in shards, where the CPU's convolutions block a batch of
one otherwise than a batch of four. Against JAX's mesh the bounds are the
cross-package ones of tests/test_torch_infer.py and test_torch_quant.py:
f32 labels and seeds >= 99.9% against the unfolded JAX inferer, int8
>= 99% on the same calibration and plan.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from annonet_tpu.infer import core as jax_core
from annonet_tpu.infer.tiling import TilingParameters as JaxTilingParameters
from annonet_tpu.models.segnet import SegNetConfig as JaxSegNetConfig
from annonet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from annonet_tpu_torch import serialization
from annonet_tpu_torch.classes import anno_classes_to_json, default_anno_classes
from annonet_tpu_torch.cli import infer as cli
from annonet_tpu_torch.cli import serve
from annonet_tpu_torch.cli.common import DEVICE_ENV, make_cli_mesh
from annonet_tpu_torch.infer.core import TiledInferer
from annonet_tpu_torch.infer.tiling import TilingParameters
from annonet_tpu_torch.models.segnet import SegNetConfig, required_input_dimension
from annonet_tpu_torch.parallel import mesh as pmesh
from tests.test_torch_model import jax_runtime_tree
from tests.test_torch_serve import TILES, raw_labels, start, stop

VIRTUAL = pmesh.VIRTUAL_MESH_ENV
CPU = torch.device("cpu")
# (config, tile size, image shape): four 96-px tiles of a level-3 net, and
# the 18-tile plan of tests/test_torch_infer.py's small net
CASES = {
    "deep": (SegNetConfig(class_count=3, level_count=3, base_width=16,
                          compute_dtype="float32"), 96, (100, 108, 3)),
    "wide": (SegNetConfig(class_count=3, level_count=2, base_width=4,
                          compute_dtype="float32"), 64, (150, 200, 3)),
}
LEVELS = [0.0, 0.3, 0.1]
MODES = {"float": {}, "int8": {"quantize": "int8"}, "folded": {"use_pallas_conv": True}}


def _case(name, seed=21):
    config, t, shape = CASES[name]
    rf = required_input_dimension(config)
    rng = np.random.default_rng(5)
    coarse = rng.integers(0, 256, size=(16, 16, 3)).astype(np.float32)
    smooth = np.kron(coarse, np.ones((16, 16, 1)))[: shape[0], : shape[1]]
    image = np.clip(smooth + rng.integers(-20, 21, size=shape), 0, 255).astype(np.uint8)
    return config, jax_runtime_tree(config, seed), TilingParameters(t, t, rf, rf), image


def _logits(inferer, image):
    """The tile batch's logits as ``_infer`` computes them."""
    plan = inferer.plan(*image.shape[:2])
    with torch.inference_mode():
        qnet = inferer._int8_net(image[None], plan)
        tiles = inferer._tile_batch(image[None], plan, quantized=qnet is not None)
        return inferer._forward(tiles, plan, quantized=qnet is not None)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("shards", [2, 3, 8])
def test_virtual_mesh_equals_one_device(case, mode, shards):
    config, tree, tiling, image = _case(case)
    one = TiledInferer(tree, config, tiling, device="cpu", **MODES[mode])
    mesh = TiledInferer(tree, config, tiling, mesh=pmesh.ensure_virtual_devices(shards, "cpu"),
                        **MODES[mode])
    assert mesh.device == CPU and len(mesh.mesh) == shards
    want = one.infer_arrays(image, None, LEVELS)
    got = mesh.infer_arrays(image, None, LEVELS)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert torch.equal(_logits(mesh, image), _logits(one, image))
    # an image batch is one tile batch, split the same way
    pair = np.stack([image, image[::-1].copy()])
    for a, b in zip(mesh.infer_arrays_batch(pair, None, LEVELS),
                    one.infer_arrays_batch(pair, None, LEVELS)):
        np.testing.assert_array_equal(a, b)
    if mode == "int8":
        assert mesh._quantized and mesh.float_fallbacks == 0
        # calibration ran on mesh[0] on the same tiles
        for a, b in zip(mesh.export_calibration(), one.export_calibration()):
            np.testing.assert_array_equal(a, b)
    if mode == "folded":
        assert mesh._folded and one._folded
    assert mesh.compiled_programs == one.compiled_programs == 1


def test_mesh_update_params_and_plan_autotune():
    config, tree, tiling, image = _case("wide")
    new_tree = jax_runtime_tree(config, 22)
    mesh = TiledInferer(tree, config, tiling, mesh=pmesh.ensure_virtual_devices(3, "cpu"))
    mesh.infer_arrays(image)
    mesh.update_params(new_tree)
    fresh = TiledInferer(new_tree, config, tiling, device="cpu")
    np.testing.assert_array_equal(mesh.infer_arrays(image, None, LEVELS)[0],
                                  fresh.infer_arrays(image, None, LEVELS)[0])
    tuned = TiledInferer(tree, config, tiling, mesh=pmesh.ensure_virtual_devices(3, "cpu"),
                         plan_autotune=True)
    got = tuned.infer_arrays(image)[0]
    (report,) = tuned.autotune_reports.values()
    assert len(report) >= 2
    pinned = TiledInferer(tree, config, tiling, device="cpu")
    pinned._plan_override = report[0][0]  # the plan the mesh inferer chose
    np.testing.assert_array_equal(got, pinned.infer_arrays(image)[0])


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_mesh_agrees_with_the_jax_mesh8_inferer(quantize):
    config, tree, tiling, image = _case("wide")
    jcfg = JaxSegNetConfig(**config.to_dict())
    jtiling = JaxTilingParameters(**dataclasses.asdict(tiling))
    if quantize:
        theirs = jax_core.TiledInferer(tree, jcfg, jtiling, quantize="int8",
                                       mesh=jax_make_mesh(8))
        ours = TiledInferer(tree, config, tiling, quantize="int8",
                            mesh=pmesh.ensure_virtual_devices(8, "cpu"))
        theirs._plan_override = ours.plan(*image.shape[:2])  # JAX's int8 default differs
        want = theirs.infer_arrays(image, None, LEVELS)
        ours = TiledInferer(tree, config, tiling, quantize="int8",
                            calibration=theirs.export_calibration(),
                            mesh=pmesh.ensure_virtual_devices(8, "cpu"))
        bound = 0.99
    else:
        theirs = jax_core.TiledInferer(tree, jcfg, jtiling, use_folded_net=False,
                                       mesh=jax_make_mesh(8))
        ours = TiledInferer(tree, config, tiling, mesh=pmesh.ensure_virtual_devices(8, "cpu"))
        want = theirs.infer_arrays(image, None, LEVELS)
        bound = 0.999
    got = ours.infer_arrays(image, None, LEVELS)
    assert (got[0] == np.asarray(want[0])).mean() >= bound
    assert (got[1] == np.asarray(want[1])).mean() >= bound


def test_make_mesh_and_its_refusals(monkeypatch):
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    assert pmesh.make_mesh() == pmesh.make_mesh(1) == (CPU,)
    with pytest.raises(ValueError, match="requested 2 devices but only 1 available"):
        pmesh.make_mesh(2)
    assert pmesh.ensure_virtual_devices(3) == (CPU,) * 3
    for bad in (0, -1):
        with pytest.raises(ValueError):
            pmesh.make_mesh(bad)
        with pytest.raises(ValueError):
            pmesh.ensure_virtual_devices(bad)
    # the virtual mesh only behind the opt-in: never a silent move to fewer devices
    monkeypatch.delenv(VIRTUAL, raising=False)
    with pytest.raises(ValueError, match="only 1 available"):
        make_cli_mesh(4, CPU)
    monkeypatch.setenv(VIRTUAL, "1")
    assert make_cli_mesh(4, CPU) == (CPU,) * 4
    config, tree, tiling, _ = _case("wide")
    for kwargs, match in (({"mesh": []}, "at least one device"),
                          ({"mesh": [CPU], "device": "meta"}, "not the mesh's first device"),
                          ({}, "needs a device")):
        with pytest.raises(ValueError, match=match):
            TiledInferer(tree, config, tiling, **kwargs)


def _dataset(root, n_images=2, size=(80, 96)):
    rng = np.random.default_rng(7)
    classes = default_anno_classes()
    (root / "anno_classes.json").write_text(anno_classes_to_json(classes))
    for i in range(n_images):
        Image.fromarray(rng.integers(0, 256, (*size, 3), dtype=np.uint8)).save(root / f"img{i}.png")
        mask = np.zeros((*size, 4), np.uint8)
        mask[: size[0] // 2] = classes[1].rgba_label
        mask[size[0] // 2 :] = classes[2].rgba_label
        Image.fromarray(mask, mode="RGBA").save(root / f"img{i}.png_mask.png")
    config = SegNetConfig(class_count=3, level_count=1, base_width=8, compute_dtype="float32")
    model = root.parent / f"{root.name}.dnn"
    serialization.save_model(str(model), jax_runtime_tree(config, 4), config,
                             anno_classes_to_json(classes), 1.0)
    return str(model)


def test_cli_mesh8_int8_equals_one_device(tmp_path, capsys, monkeypatch):
    """JAX tests/test_cli.py's --mesh 8 --quantize int8 run: the result PNGs
    and both confusion matrices equal the run without --mesh."""
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    out = {}
    for arm, extra in (("one", []), ("mesh", ["--mesh", "8"])):
        root = tmp_path / arm
        root.mkdir()
        model = _dataset(root)
        monkeypatch.setenv(VIRTUAL, "1")
        assert cli.main([str(root), "--model", model, "--quantize", "int8",
                         "-w", "64", "-h", "64", *extra]) == 0
        out[arm] = capsys.readouterr().out
        assert "All result images written!" in out[arm]
    for i in range(2):
        a = (tmp_path / "one" / f"img{i}.png_result.png").read_bytes()
        assert a == (tmp_path / "mesh" / f"img{i}.png_result.png").read_bytes()
    matrices = [o[o.index("Confusion matrix per pixel"):] for o in out.values()]
    assert matrices[0] == matrices[1]
    # without the opt-in a mesh wider than the machine is a setup error
    monkeypatch.delenv(VIRTUAL)
    assert cli.main([str(tmp_path / "one"), "--model", str(tmp_path / "one.dnn"),
                     "--mesh", "2"]) == 1
    assert "requested 2 devices but only 1 available" in capsys.readouterr().out


def test_serve_mesh8_equals_the_single_device_service(tmp_path, monkeypatch):
    """JAX tests/test_serve.py::test_serve_with_mesh: a --mesh 8 server's
    labels equal the single-device service's, also after /reload."""
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    monkeypatch.setenv(VIRTUAL, "1")
    (tmp_path / "data").mkdir()
    model = _dataset(tmp_path / "data")
    url, server, service = start(serve, model, "--mesh", "8", "-d", "1:0.3")
    try:
        assert service.mesh == (CPU,) * 8 and service.inferer.mesh == service.mesh
        single = serve._ModelService(serve.build_parser().parse_args(
            ["--model", model, *TILES, "-d", "1:0.3"]))
        assert single.mesh is None
        for seed in (0, 1):
            image = np.random.default_rng(seed).integers(0, 256, (80, 96, 3), dtype=np.uint8)
            expected = single.infer(image, single.state.default_gains, single.state.default_detection)
            np.testing.assert_array_equal(raw_labels(url, image), expected)
        service.reload()  # the rebuilt inferer keeps the mesh
        assert service.inferer.mesh == (CPU,) * 8
        np.testing.assert_array_equal(raw_labels(url, image), expected)
    finally:
        stop(server)


def test_serve_mesh_requests_from_threads(tmp_path, monkeypatch):
    """Concurrent requests to a mesh server each get their own labels."""
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    monkeypatch.setenv(VIRTUAL, "1")
    (tmp_path / "data").mkdir()
    model = _dataset(tmp_path / "data")
    url, server, service = start(serve, model, "--mesh", "3", "--max-batch", "2")
    try:
        images = [np.random.default_rng(s).integers(0, 256, (64, 80, 3), dtype=np.uint8)
                  for s in range(4)]
        want = [service.infer(im, service.state.default_gains, service.state.default_detection)
                for im in images]
        got = [None] * 4

        def run(i):
            got[i] = raw_labels(url, images[i])

        threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    finally:
        stop(server)
