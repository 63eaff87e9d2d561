"""Threaded training-data pipeline: loader threads -> bounded queue -> batches.

Replaces the reference's crop-producer machinery
(annonet_train_main.cpp:517-553,583-607): N loader threads each loop picking
a random image, fetching the decoded sample through the shared LRU cache,
cutting a random crop, and enqueueing it into a bounded queue of depth
2 * minibatch_size; the consumer dequeues until it has a full minibatch of
good crops, raising on errors and deduping warnings. The port's copy of
``annonet_tpu/data/pipeline.py`` (numpy and threads, no framework).

Differences by design:
  * crops carry raw uint8 pixels and uint16 labels only — weighting and all
    augmentations run batched on device inside the train step
    (annonet_tpu_torch.ops.augment / ops.weighting), not per-crop on the host
  * ``next_minibatch`` returns C-contiguous stacked arrays ready for a
    single 1-byte/pixel host->device transfer
  * the region-size filter (--ignore-large-nonzero-regions-*) is applied in
    the cache factory; the reference defines it but never calls it
    (annonet_train_main.cpp:434 has no call site) — here the flags work
  * ``deterministic=True`` makes the crop-decision stream a pure function
    of (seed, dataset) while KEEPING parallel decode: one decision thread
    draws image indices and rects from two spawned generator streams, and
    the other thread_count - 1 loaders prefetch decodes for the pre-drawn
    indices (--deterministic-data); with the same seed the stream equals
    the JAX package's. The reference has no deterministic mode at all
    (its N loader threads race on the shared pipe).
"""

from __future__ import annotations

import dataclasses
import math
import queue
import threading
from typing import Callable, List, Optional, Sequence, Set, Tuple

import numpy as np

from annonet_tpu_torch.classes import AnnoClass
from annonet_tpu_torch.data.cache import SharedLruCache
from annonet_tpu_torch.data.crop import (
    CropOptions,
    extract_crop,
    randomly_crop_sample,
    sample_crop_rect,
)
from annonet_tpu_torch.data.dataset import ImageFilenames
from annonet_tpu_torch.data.filters import ignore_classes, ignore_large_nonzero_regions
from annonet_tpu_torch.data.sample import Sample, read_sample


@dataclasses.dataclass
class Crop:
    """One produced crop; mirrors the reference's crop struct
    (annonet_train_main.cpp:61-71) with errors/warnings as data.

    Two payload shapes: materialized pixels (image/labels — the further-
    downscaling path) or a DECISION (sample + rect — the fast path, where
    the consumer extracts the whole minibatch in one native call)."""

    image: Optional[np.ndarray] = None  # (dim, dim, C) uint8
    labels: Optional[np.ndarray] = None  # (dim, dim) uint16
    sample: Optional[Sample] = None  # decision mode: source sample...
    rect: Optional[Tuple[int, int, int, int]] = None  # ...and ltrb rect
    warning: str = ""
    error: str = ""


@dataclasses.dataclass
class RegionFilterOptions:
    """--ignore-large-nonzero-regions-{area,width,height} thresholds."""

    receptive_field_side: int = 1
    by_area: float = math.inf
    by_width: float = math.inf
    by_height: float = math.inf

    @property
    def active(self) -> bool:
        return (
            math.isfinite(self.by_area)
            or math.isfinite(self.by_width)
            or math.isfinite(self.by_height)
        )


class CropPipeline:
    """Loader threads + bounded queue feeding fixed-size training minibatches."""

    def __init__(
        self,
        image_files: Sequence[ImageFilenames],
        anno_classes: Sequence[AnnoClass],
        crop_options: CropOptions,
        *,
        initial_downscaling_factor: float = 1.0,
        grayscale: bool = False,
        classes_to_ignore: Sequence[int] = (),
        region_filter: Optional[RegionFilterOptions] = None,
        cached_image_count: int = 8,
        thread_count: int = 4,
        queue_depth: int = 200,
        seed: int = 0,
        force_per_crop_extraction: bool = False,
        pinned_bytes_budget: int = 512 << 20,
        deterministic: bool = False,
    ):
        if not image_files:
            raise ValueError("no image files to train on")
        self._image_files = list(image_files)
        self._queue: "queue.Queue[Crop]" = queue.Queue(maxsize=queue_depth)
        self._stop = threading.Event()
        self._options = crop_options
        self._grayscale = grayscale
        # The crop side actually produced: for factors <= 1 the reference
        # extracts round(dim * fdf) chips WITHOUT resizing
        # (annonet_train_main.cpp:174-180, the else branch), so that is the
        # minibatch side; only factors > 1 resize back down to dim.
        fdf = crop_options.further_downscaling_factor
        self._crop_dim = (
            int(round(crop_options.dim * fdf)) if fdf <= 1.0
            else crop_options.dim
        )
        # Fast path: producers ship crop DECISIONS and the consumer extracts
        # the whole minibatch in one GIL-free native call (C++ thread pool,
        # see native/annonet_native.cpp annonet_extract_crops_batch). Only
        # the downscaling (fdf > 1) path needs per-crop extraction (it
        # bilinear-resizes each crop after extraction).
        self._decision_mode = fdf <= 1.0 and not force_per_crop_extraction
        self._extract_threads = max(1, thread_count)
        # Queued decisions pin their whole decoded source Sample in memory
        # (full images can be 50+ MB each). A byte budget bounds the worst
        # case — e.g. the device stalling in its first compile while
        # producers fill the queue with crops of distinct evicted images;
        # when exceeded, producers fall back to extracting the crop's
        # pixels themselves, using the already-drawn rect so the random
        # stream is unchanged either way.
        self._pinned_bytes = 0
        self._pinned_budget = max(0, pinned_bytes_budget)
        self._pinned_lock = threading.Lock()
        # refcounted per-SAMPLE accounting: many queued decisions usually
        # share a few cached samples, and only DISTINCT pinned samples
        # consume budget (the table holds a reference, so id() stays valid)
        self._pin_table: dict = {}  # id(sample) -> [refcount, nbytes, sample]

        def load_full_sample(filenames: ImageFilenames) -> Sample:
            sample = read_sample(
                filenames,
                anno_classes,
                require_ground_truth=True,
                downscaling_factor=initial_downscaling_factor,
                grayscale=grayscale,
            )
            if not sample.error:
                ignore_classes(sample, classes_to_ignore)
                if region_filter is not None and region_filter.active:
                    ignore_large_nonzero_regions(
                        sample,
                        region_filter.receptive_field_side,
                        by_area=region_filter.by_area,
                        by_width=region_filter.by_width,
                        by_height=region_filter.by_height,
                    )
            return sample

        self._cache: SharedLruCache[ImageFilenames, Sample] = SharedLruCache(
            load_full_sample, cached_image_count
        )
        self._threads: List[threading.Thread] = []
        if deterministic:
            # Deterministic mode: the crop-decision stream is a pure
            # function of (seed, dataset) — independent of thread count and
            # scheduling — because ONE decision thread draws everything,
            # from two spawned generator streams (image indices / rects).
            # The remaining thread_count - 1 loaders become decode
            # PREFETCHERS: they warm the LRU for upcoming pre-drawn image
            # indices, so decode still runs in parallel but can never
            # reorder decisions. This is what --coordinator multi-host
            # training runs on (every process must compute the identical
            # replicated pool + decision uploads, docs/DESIGN.md par.29);
            # single-host users get it via --deterministic-data.
            n_prefetch = max(0, thread_count - 1)
            # lookahead deeper than the LRU would evict entries before the
            # decision thread consumes them (prefetch thrash)
            self._lookahead = (
                min(2 * n_prefetch, max(1, cached_image_count - 1))
                if n_prefetch
                else 0
            )
            self._prefetch_q: "queue.Queue[ImageFilenames]" = queue.Queue(
                maxsize=max(1, self._lookahead)
            )
            for _ in range(n_prefetch):
                t = threading.Thread(target=self._prefetch_worker, daemon=True)
                t.start()
                self._threads.append(t)
            t = threading.Thread(
                target=self._decision_worker, args=(seed,), daemon=True
            )
            t.start()
            self._threads.append(t)
        else:
            for i in range(max(1, thread_count)):
                t = threading.Thread(
                    target=self._worker, args=(seed + i,), daemon=True
                )
                t.start()
                self._threads.append(t)

    # ------------------------------------------------------------ producer

    def _worker(self, seed: int) -> None:
        rng = np.random.default_rng(seed)
        while not self._stop.is_set():
            crop = self._make_crop(rng)
            self._put_crop(crop)

    def _decision_worker(self, seed: int) -> None:
        """Deterministic mode's single decision thread.

        Image indices come from one spawned stream, rect draws from the
        other — so indices can be pre-drawn ``self._lookahead`` deep and
        handed to the prefetchers without perturbing the rect stream, and
        the decision sequence depends only on (seed, dataset content).
        """
        from collections import deque

        idx_ss, rect_ss = np.random.SeedSequence(seed).spawn(2)
        idx_rng = np.random.default_rng(idx_ss)
        rect_rng = np.random.default_rng(rect_ss)
        pending: "deque[int]" = deque()
        while not self._stop.is_set():
            while len(pending) <= self._lookahead:
                index = int(idx_rng.integers(0, len(self._image_files)))
                pending.append(index)
                if self._lookahead:
                    try:  # best-effort: a full queue only costs cache warmth
                        self._prefetch_q.put_nowait(self._image_files[index])
                    except queue.Full:
                        pass
            crop = self._make_crop(rect_rng, index=pending.popleft())
            self._put_crop(crop)

    def _prefetch_worker(self) -> None:
        while not self._stop.is_set():
            try:
                filenames = self._prefetch_q.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                self._cache(filenames)
            except Exception:  # noqa: BLE001 — the decision thread will hit
                pass  # the same (deterministic) error and report it as data

    def _put_crop(self, crop: Crop) -> None:
        # bounded put with timeout so shutdown never deadlocks on a full
        # queue (the dlib::pipe analog of disable(), :623)
        while not self._stop.is_set():
            try:
                self._queue.put(crop, timeout=0.1)
                break
            except queue.Full:
                continue

    def _make_crop(
        self, rng: np.random.Generator, index: Optional[int] = None
    ) -> Crop:
        crop = Crop()
        if index is None:
            index = int(rng.integers(0, len(self._image_files)))
        filenames = self._image_files[index]
        try:
            sample = self._cache(filenames)
        except Exception as e:  # noqa: BLE001 — errors travel as data
            crop.error = str(e)
            return crop
        if sample.error:
            crop.error = sample.error
        elif not sample.labeled_points_by_class:
            crop.warning = (
                "Warning: no labeled points in "
                + sample.image_filenames.label_filename
            )
        else:
            try:
                if self._decision_mode:
                    rect = sample_crop_rect(sample, self._options, rng)
                    if self._try_pin(sample):
                        crop.sample = sample
                        crop.rect = rect
                    else:
                        # budget exhausted: extract here (same rect, so the
                        # random stream is identical; fdf == 1 -> no resize)
                        crop.image, crop.labels = extract_crop(
                            sample.input_image, sample.label_image, rect
                        )
                else:
                    crop.image, crop.labels = randomly_crop_sample(
                        sample, self._options, rng
                    )
            except Exception as e:  # noqa: BLE001
                crop.error = str(e)
        return crop

    def _try_pin(self, sample: Sample) -> bool:
        with self._pinned_lock:
            entry = self._pin_table.get(id(sample))
            if entry is not None:  # already pinned: sharing is free
                entry[0] += 1
                return True
            nbytes = sample.input_image.nbytes + sample.label_image.nbytes
            if self._pinned_bytes + nbytes > self._pinned_budget:
                return False
            self._pinned_bytes += nbytes
            self._pin_table[id(sample)] = [1, nbytes, sample]
            return True

    def _unpin_many(self, samples) -> None:
        with self._pinned_lock:
            for sample in samples:
                entry = self._pin_table.get(id(sample))
                if entry is None:
                    continue
                entry[0] -= 1
                if entry[0] == 0:
                    self._pinned_bytes -= entry[1]
                    del self._pin_table[id(sample)]

    # ------------------------------------------------------------ consumer

    def next_minibatch(
        self,
        minibatch_size: int,
        warn: Optional[Callable[[str], None]] = print,
        warnings_already_printed: Optional[Set[str]] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Collect ``minibatch_size`` good crops.

        Errors raise (annonet_train_main.cpp:594-596); warnings are passed to
        ``warn`` once each (dedup via ``warnings_already_printed``,
        :597-602). Returns (images [N,dim,dim,C] uint8, labels [N,dim,dim]
        uint16), C-contiguous.
        """
        crops = self._collect_crops(
            minibatch_size, warn, warnings_already_printed
        )
        return self._assemble(crops)

    def next_decisions(
        self,
        minibatch_size: int,
        warn: Optional[Callable[[str], None]] = print,
        warnings_already_printed: Optional[Set[str]] = None,
    ):
        """Collect ``minibatch_size`` good crops WITHOUT extracting pixels.

        The device-image-pool path (train.device_cache): when every crop
        arrived as a decision, returns ``("decisions", samples, rects)`` —
        one (Sample, ltrb rect) per crop, pixels never touched on the
        host. If any crop was materialized (pin-budget fallback, or the
        further-downscaling per-crop path), the whole batch is assembled
        as pixels instead and ``("pixels", images, labels)`` is returned —
        the caller feeds that through the classic upload path. Either way
        the crops and the random stream are identical to next_minibatch.
        """
        crops = self._collect_crops(
            minibatch_size, warn, warnings_already_printed
        )
        if all(c.sample is not None for c in crops):
            samples = [c.sample for c in crops]
            rects = [c.rect for c in crops]
            # dequeued decisions are no longer queued: release their pins
            # (consumers of the samples hold their own references)
            self._unpin_many(samples)
            return "decisions", samples, rects
        images, labels = self._assemble(crops)
        return "pixels", images, labels

    def _collect_crops(
        self,
        minibatch_size: int,
        warn,
        warnings_already_printed,
    ) -> List[Crop]:
        crops: List[Crop] = []
        while len(crops) < minibatch_size:
            crop = self._queue.get()
            if crop.error:
                raise RuntimeError(crop.error)
            if crop.warning:
                if warn is not None and (
                    warnings_already_printed is None
                    or crop.warning not in warnings_already_printed
                ):
                    warn(crop.warning)
                    if warnings_already_printed is not None:
                        warnings_already_printed.add(crop.warning)
                continue
            crops.append(crop)
        return crops

    def _assemble(self, crops: List[Crop]) -> Tuple[np.ndarray, np.ndarray]:
        # Assemble the batch arrays. Crops arrive in two shapes (possibly
        # mixed when the pin budget kicked in): materialized pixels are
        # copied into their slots; decisions are extracted straight into
        # their slots by one native batch call (Python fallback per crop).
        dim = self._crop_dim
        channels = 1 if self._grayscale else 3
        images = np.empty(
            (len(crops), dim, dim, channels), dtype=np.uint8
        )
        labels = np.empty((len(crops), dim, dim), dtype=np.uint16)

        decision_slots = []
        for i, c in enumerate(crops):
            if c.sample is None:
                images[i] = c.image
                labels[i] = c.labels
            else:
                decision_slots.append(i)

        if decision_slots:
            from annonet_tpu_torch.native import extract_crops_batch_native

            selected = [crops[i] for i in decision_slots]
            done = extract_crops_batch_native(
                [
                    (c.sample.input_image, c.sample.label_image)
                    for c in selected
                ],
                [(c.rect[1], c.rect[0]) for c in selected],  # -> (top, left)
                dim,
                dim,
                [images[i] for i in decision_slots],
                [labels[i] for i in decision_slots],
                thread_count=self._extract_threads,
            )
            if not done:  # pure-Python fallback, per crop
                for i in decision_slots:
                    c = crops[i]
                    images[i], labels[i] = extract_crop(
                        c.sample.input_image, c.sample.label_image, c.rect
                    )
            self._unpin_many(c.sample for c in selected)
        return images, labels

    # ------------------------------------------------------------ shutdown

    def close(self) -> None:
        self._stop.set()
        # drain so producers blocked on put() can observe the stop flag
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        for t in self._threads:
            t.join(timeout=5.0)

    def __enter__(self) -> "CropPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
