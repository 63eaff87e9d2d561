"""The port's training data layer (annonet_tpu_torch/data: crop, filters,
cache, pipeline, synthetic; native.py's crop extractors) against the JAX
package's, on the CPU: the same crops from the same random stream, the
deterministic crop-decision stream equal to JAX's for the same seed, the
detection dataset byte-equal, the filters and the LRU cache as
tests/test_pipeline.py checks them. Everything here is integer: equal,
bit for bit."""

import threading
import time

import numpy as np
import pytest
from PIL import Image

from annonet_tpu.data import crop as jax_crop
from annonet_tpu.data import filters as jax_filters
from annonet_tpu.data import synthetic as jax_synthetic
from annonet_tpu.data.pipeline import CropPipeline as JaxCropPipeline
from annonet_tpu.data.pipeline import RegionFilterOptions as JaxRegionFilterOptions
from annonet_tpu_torch import native
from annonet_tpu_torch.classes import IGNORE_LABEL, default_anno_classes
from annonet_tpu_torch.data import crop, filters, synthetic
from annonet_tpu_torch.data.cache import SharedLruCache
from annonet_tpu_torch.data.codec import labeled_points_by_class
from annonet_tpu_torch.data.dataset import ImageFilenames, find_image_files
from annonet_tpu_torch.data.pipeline import CropPipeline, RegionFilterOptions
from annonet_tpu_torch.data.sample import Sample


def make_sample(label_image, image=None, seed=0):
    label_image = np.asarray(label_image, dtype=np.uint16)
    h, w = label_image.shape
    if image is None:
        image = np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    return Sample(
        image_filenames=ImageFilenames("img.png", "img.png_mask.png"),
        original_width=w, original_height=h, input_image=image,
        label_image=label_image, labeled_points_by_class=labeled_points_by_class(label_image),
    )


@pytest.fixture
def detection_dirs(tmp_path):
    """The detection set written by both packages from one seed."""
    for name, module in (("jax", jax_synthetic), ("port", synthetic)):
        module.write_detection_dataset(tmp_path / name, n_images=2, size=256, seed=4,
                                       defect_count=3, oversize_images=1)
    return tmp_path / "jax", tmp_path / "port"


def test_write_detection_dataset_is_byte_equal(detection_dirs):
    jax_dir, port_dir = detection_dirs
    names = sorted(p.name for p in jax_dir.iterdir())
    assert names == sorted(p.name for p in port_dir.iterdir()) and len(names) == 5
    for name in names:
        assert (jax_dir / name).read_bytes() == (port_dir / name).read_bytes(), name
    image, labels = synthetic.generate_detection_image(np.random.default_rng(1), size=64)
    want = jax_synthetic.generate_detection_image(np.random.default_rng(1), size=64)
    assert np.array_equal(image, want[0]) and np.array_equal(labels, want[1])


def test_crop_geometry_and_random_rects_match_jax():
    assert crop.centered_rect(5, 7, 4, 3) == jax_crop.centered_rect(5, 7, 4, 3)
    rng_a, rng_b = np.random.default_rng(3), np.random.default_rng(3)
    for point in [(0, 0), (10, 3), (99, 50)]:
        for size in [(1, 1), (16, 9), (33, 64)]:
            got = crop.random_rect_containing_point(rng_a, point, *size)
            assert got == jax_crop.random_rect_containing_point(rng_b, point, *size)


@pytest.mark.parametrize("use_native", [True, False])
def test_extract_crop_matches_jax(use_native, monkeypatch):
    if not use_native:
        monkeypatch.setenv("ANNONET_TPU_NO_NATIVE", "1")
    rng = np.random.default_rng(0)
    image = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    labels = rng.integers(0, 4, (20, 30)).astype(np.uint16)
    for rect in [(2, 3, 17, 12), (-5, -4, 10, 8), (20, 10, 40, 30), (-3, -3, 33, 22)]:
        got = crop.extract_crop(image, labels, rect)
        want = jax_crop.extract_crop(image, labels, rect)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        assert got[1].dtype == np.uint16
    inside = crop.extract_crop(image, labels, (-2, 0, 5, 3))
    assert (inside[1][:, :2] == IGNORE_LABEL).all()
    assert (inside[0][:, 0] == image[0:4, 0]).all()  # replicated edge


def test_native_crop_extractors():
    if native.get_lib() is None:
        pytest.skip("the native module does not build here")
    rng = np.random.default_rng(1)
    sources = [(rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                rng.integers(0, 5, (h, w)).astype(np.uint16)) for h, w in [(30, 20), (12, 40)]]
    rects = [(-4, -6), (25, 10), (3, 35), (-10, -10)]
    which = [0, 0, 1, 1]
    images = np.empty((4, 16, 16, 3), np.uint8)
    labels = np.empty((4, 16, 16), np.uint16)
    assert native.extract_crops_batch_native(
        [sources[i] for i in which], rects, 16, 16, list(images), list(labels), thread_count=2)
    for k, (i, (top, left)) in enumerate(zip(which, rects)):
        one = native.extract_crop_native(*sources[i], top, left, 16, 16)
        want = jax_crop.extract_crop(*sources[i], (left, top, left + 15, top + 15))
        assert np.array_equal(one[0], want[0]) and np.array_equal(one[1], want[1])
        assert np.array_equal(images[k], want[0]) and np.array_equal(labels[k], want[1])


@pytest.mark.parametrize("fdf", [1.0, 0.5, 2.0])
def test_randomly_crop_sample_matches_jax(fdf):
    labels = np.zeros((40, 50), np.uint16)
    labels[5:12, 30:41] = 1
    labels[30:, :] = 2
    labels[0, 0] = IGNORE_LABEL
    sample = make_sample(labels)
    rng_a, rng_b = np.random.default_rng(7), np.random.default_rng(7)
    options = crop.CropOptions(dim=16, further_downscaling_factor=fdf)
    jax_options = jax_crop.CropOptions(dim=16, further_downscaling_factor=fdf)
    for _ in range(6):
        got = crop.randomly_crop_sample(sample, options, rng_a)
        want = jax_crop.randomly_crop_sample(sample, jax_options, rng_b)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_filters_match_jax():
    labels = np.zeros((30, 30), np.uint16)
    labels[0:12, 0:12] = 1  # a large blob
    labels[20, 20] = 2  # a small one
    labels[25:27, 3:5] = 3
    for kwargs in (dict(by_area=1.0), dict(by_width=2.0), dict(by_height=0.5)):
        mine, theirs = make_sample(labels.copy()), make_sample(labels.copy())
        filters.ignore_large_nonzero_regions(mine, 3, **kwargs)
        jax_filters.ignore_large_nonzero_regions(theirs, 3, **kwargs)
        assert np.array_equal(mine.label_image, theirs.label_image)
        assert sorted(mine.labeled_points_by_class) == sorted(theirs.labeled_points_by_class)
    mine, theirs = make_sample(labels.copy()), make_sample(labels.copy())
    filters.ignore_classes(mine, [1, 3])
    jax_filters.ignore_classes(theirs, [1, 3])
    assert np.array_equal(mine.label_image, theirs.label_image)
    assert sorted(mine.labeled_points_by_class) == [0, 2]
    background = make_sample(np.zeros((8, 8), np.uint16))
    filters.ignore_large_nonzero_regions(background, 1, by_area=0.1)
    assert 0 in background.labeled_points_by_class  # blob 0 always stays


def test_lru_cache_eviction_reload_and_single_load():
    loads = []
    cache = SharedLruCache(lambda k: loads.append(k) or k * 10, capacity=2)
    assert (cache(1), cache(2), cache(1)) == (10, 20, 10)
    cache(3)  # evicts 2, the least recently used
    assert cache(2) == 20 and loads == [1, 2, 3, 2] and len(cache) == 2
    with pytest.raises(ValueError):
        SharedLruCache(lambda k: k, capacity=0)

    slow_loads = []

    def slow(k):
        slow_loads.append(k)
        time.sleep(0.05)
        return k

    shared = SharedLruCache(slow, capacity=4)
    threads = [threading.Thread(target=shared, args=(7,)) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads) and slow_loads == [7]


def _dataset(tmp_path):
    classes = default_anno_classes()
    rng = np.random.default_rng(0)
    for i in range(4):
        img = rng.integers(0, 256, (40, 52, 3), dtype=np.uint8)
        mask = np.zeros((40, 52, 4), np.uint8)
        mask[:, :30] = classes[0].rgba_label
        mask[4 + i:12 + i, 34:44] = classes[1].rgba_label
        mask[30:, 40:] = classes[2].rgba_label
        Image.fromarray(img).save(tmp_path / f"im{i}.png")
        Image.fromarray(mask, mode="RGBA").save(tmp_path / f"im{i}.png_mask.png")
    return find_image_files(str(tmp_path), require_ground_truth=True, verbose=False), classes


@pytest.mark.parametrize("threads", [1, 3])
def test_deterministic_stream_equals_jax(tmp_path, threads):
    files, classes = _dataset(tmp_path)
    region = dict(receptive_field_side=4, by_area=2.0)
    kwargs = dict(thread_count=threads, seed=11, cached_image_count=2, queue_depth=8,
                  deterministic=True)
    options = crop.CropOptions(dim=16)
    with CropPipeline(files, classes, options, region_filter=RegionFilterOptions(**region),
                      **kwargs) as mine, \
            JaxCropPipeline(files, classes, jax_crop.CropOptions(dim=16),
                            region_filter=JaxRegionFilterOptions(**region), **kwargs) as theirs:
        for _ in range(3):
            kind, samples, rects = mine.next_decisions(6, warn=None)
            jkind, jsamples, jrects = theirs.next_decisions(6, warn=None)
            assert kind == jkind == "decisions" and rects == jrects
            assert ([s.image_filenames.image_filename for s in samples]
                    == [s.image_filenames.image_filename for s in jsamples])
            for s, js in zip(samples, jsamples):
                assert np.array_equal(s.label_image, js.label_image)
        for _ in range(2):
            images, labels = mine.next_minibatch(5, warn=None)
            jimages, jlabels = theirs.next_minibatch(5, warn=None)
            assert images.dtype == np.uint8 and labels.dtype == np.uint16
            assert np.array_equal(images, jimages) and np.array_equal(labels, jlabels)


def test_pipeline_warnings_and_errors(tmp_path):
    classes = default_anno_classes()
    img = np.zeros((20, 20, 3), np.uint8)
    Image.fromarray(img).save(tmp_path / "a.png")
    Image.fromarray(np.zeros((20, 20, 4), np.uint8), mode="RGBA").save(
        tmp_path / "a.png_mask.png")  # every pixel ignored: no labeled point
    mask = np.zeros((20, 20, 4), np.uint8)
    mask[:] = classes[0].rgba_label
    Image.fromarray(img).save(tmp_path / "b.png")
    Image.fromarray(mask, mode="RGBA").save(tmp_path / "b.png_mask.png")
    files = find_image_files(str(tmp_path), require_ground_truth=True, verbose=False)
    seen, printed = set(), []
    with CropPipeline(files, classes, crop.CropOptions(dim=8), thread_count=2, seed=0) as pipe:
        images, labels = pipe.next_minibatch(6, warn=printed.append,
                                             warnings_already_printed=seen)
    assert images.shape == (6, 8, 8, 3) and set(np.unique(labels)) <= {0, IGNORE_LABEL}
    assert len(printed) == 1 and "no labeled points" in printed[0]
    bad = [ImageFilenames(str(tmp_path / "missing.png"), str(tmp_path / "missing.png_mask.png"))]
    with CropPipeline(bad, classes, crop.CropOptions(dim=8), thread_count=1) as pipe:
        with pytest.raises(RuntimeError):
            pipe.next_minibatch(1, warn=None)


def test_detection_recipe_equals_the_jax_script():
    """tools/measure_detection.py runs scripts/measure_detection.py's
    recipe and reads PARITY_TARGETS.json's pinned floors."""
    import importlib.util
    import json
    import pathlib

    from annonet_tpu_torch.tools import measure_detection

    repo = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "jax_measure_detection", repo / "scripts" / "measure_detection.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    assert measure_detection.BENCH == script.BENCH
    bench = json.loads((repo / "PARITY_TARGETS.json").read_text())["detection_benchmark"]
    assert measure_detection.pinned_floors() == (
        bench["pinned_region_recall_floor"], bench["pinned_pixel_accuracy_floor"])


def test_detection_run_draws_from_the_stream_of_seed_0(monkeypatch):
    """A short run of the detection tool on the CPU: every seed's run
    draws its augmentations from seed 0's stream, as the JAX script's
    trainer does (it passes no seed), and the record has the JAX script's
    fields."""
    from annonet_tpu_torch.tools import measure_detection
    from annonet_tpu_torch.train.trainer import Trainer

    seeds = []
    original = Trainer.augmentation_generator

    def spy(self, seed=0):
        seeds.append(seed)
        return original(self, seed)

    monkeypatch.setattr(Trainer, "augmentation_generator", spy)
    run = measure_detection.run_benchmark(5, device="cpu", steps=2, verbose=False)
    assert seeds == [0, 0]
    assert (run["seed"], run["steps"], run["stopped_at_min_lr"]) == (5, 2, False)
    assert np.asarray(run["region_cm"]).shape == (3, 3)
    assert 0.0 <= run["pixel_accuracy"] <= 1.0
