"""The port's own host modules (annonet_tpu_torch/classes.py and native.py)
against the JAX package's ``annonet_tpu.classes`` and the numpy fallbacks.

The class codec must give the same classes, JSON and error messages. The
native loader builds the repository's ``native/*.cpp`` itself; where it
builds, its blob labelling must give the same partition as the scipy
fallback, its decode the same pixels as PIL (JPEG within one level: two
decoders may round differently), its encode a PNG that reads back
exactly, and its bilinear resize the numpy fallback's values within one
level (the .5 boundary may round either way).
"""

import json

import numpy as np
import pytest
from PIL import Image

from annonet_tpu import classes as jax_classes
from annonet_tpu_torch import classes, native
from annonet_tpu_torch.data import sample
from annonet_tpu_torch.ops import blobs

ANNO_JSON = json.dumps({"anno_classes": [
    {"name": "bg", "color": {"red": 0, "green": 0, "blue": 0, "alpha": 255}},
    {"name": "scratch", "color": {"red": 255, "green": 0, "blue": 0, "alpha": 128}},
    {"name": "dent", "color": {"red": 0, "green": 0, "blue": 255, "alpha": 64}},
    {"name": "rust", "color": {"red": 12, "green": 34, "blue": 56, "alpha": 78}},
]})


def _as_tuples(anno_classes):
    return [(c.index, tuple(c.rgba_label), c.classlabel) for c in anno_classes]


@pytest.mark.parametrize("text", ["", ANNO_JSON], ids=["default", "parsed"])
def test_classes_equal_the_jax_package(text):
    ours, theirs = classes.parse_anno_classes(text), jax_classes.parse_anno_classes(text)
    assert _as_tuples(ours) == _as_tuples(theirs)
    assert classes.anno_classes_to_json(ours) == jax_classes.anno_classes_to_json(theirs)
    assert (classes.IGNORE_LABEL, classes.RGBA_IGNORE) == \
        (jax_classes.IGNORE_LABEL, jax_classes.RGBA_IGNORE)
    assert _as_tuples(classes.default_anno_classes()) == \
        _as_tuples(jax_classes.default_anno_classes())


@pytest.mark.parametrize("text", [
    "not json", "[]", '{"anno_classes": 3}', '{"anno_classes": [{"color": {}}]}',
    '{"anno_classes": [{"name": "a"}]}', '{"anno_classes": [{"name": "a", "color": {"red": 1}}]}',
    '{"anno_classes": [{"name": "a", "color": {"red": 0, "green": 0, "blue": 0, "alpha": 0}}]}',
])
def test_class_errors_equal_the_jax_package(text):
    with pytest.raises(RuntimeError) as ours:
        classes.parse_anno_classes(text)
    with pytest.raises(RuntimeError) as theirs:
        jax_classes.parse_anno_classes(text)
    assert str(ours.value) == str(theirs.value)


@pytest.fixture
def lib():
    loaded = native.get_lib()
    if loaded is None:
        pytest.skip("the native module does not build here (no g++)")
    return loaded


def _fallback(monkeypatch, fn, *args):
    monkeypatch.setenv("ANNONET_TPU_NO_NATIVE", "1")
    try:
        assert native.get_lib() is None
        return fn(*args)
    finally:
        monkeypatch.delenv("ANNONET_TPU_NO_NATIVE")


def test_native_blobs_equal_the_fallback(lib, monkeypatch):
    rng = np.random.default_rng(0)
    for zero_bg, ignore_bg in ((True, False), (True, True), (False, False)):
        labels = np.kron(rng.integers(0, 4, size=(12, 15)), np.ones((3, 3), np.int64))
        labels = labels.astype(np.uint16)
        labels[rng.random(labels.shape) < 0.05] = classes.IGNORE_LABEL
        got, n_got = blobs.label_connected_blobs(labels, zero_bg, ignore_bg)
        want, n_want = _fallback(monkeypatch, blobs.label_connected_blobs, labels, zero_bg,
                                 ignore_bg)
        assert n_got == n_want > 2
        assert ((got == 0) == (want == 0)).all()
        pairs = set(zip(got.ravel().tolist(), want.ravel().tolist()))
        assert len({a for a, _ in pairs}) == len({b for _, b in pairs}) == len(pairs)


def test_native_resize_equals_the_fallback(lib, monkeypatch):
    rng = np.random.default_rng(2)
    for shape, (th, tw) in (((31, 45, 3), (17, 23)), ((20, 20, 1), (30, 40)), ((10, 10), (7, 5))):
        image = rng.integers(0, 256, size=shape, dtype=np.uint8)
        got = sample.resize_image_bilinear(image, tw, th)
        want = _fallback(monkeypatch, sample.resize_image_bilinear, image, tw, th)
        assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_native_decode_and_encode(lib, tmp_path, monkeypatch):
    if not hasattr(lib, "annonet_decode_image"):
        pytest.skip("the native module built without libpng/libjpeg")
    rng = np.random.default_rng(1)
    rgba = rng.integers(0, 256, size=(21, 17, 4), dtype=np.uint8)
    png = str(tmp_path / "x.png")
    Image.fromarray(rgba, mode="RGBA").save(png)
    np.testing.assert_array_equal(sample.load_rgba(png), rgba)
    np.testing.assert_array_equal(
        sample.load_rgba(png), _fallback(monkeypatch, sample.load_rgba, png))
    np.testing.assert_array_equal(native.decode_image_native(png, 3), rgba[..., :3])
    rgb = rng.integers(0, 256, size=(32, 48, 3), dtype=np.uint8)
    jpg = str(tmp_path / "y.jpg")
    Image.fromarray(rgb, mode="RGB").save(jpg, quality=90)
    got = native.decode_image_native(jpg, 3).astype(int)
    assert np.abs(got - np.asarray(Image.open(jpg).convert("RGB"), int)).max() <= 1
    out = str(tmp_path / "out.png")
    sample.save_png_rgba(out, rgba)
    np.testing.assert_array_equal(np.asarray(Image.open(out)), rgba)
    with pytest.raises(FileNotFoundError):
        native.decode_image_native(str(tmp_path / "missing.png"), 3)
