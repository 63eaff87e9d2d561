"""Device-resident decoded-image pool for training (the port of
``annonet_tpu/train/device_cache.py``, one device).

The host LRU (data/cache.py) owns the decoded Samples; this pool mirrors
the samples a minibatch references into two device tensors — images
[S, Hp, Wp, C] uint8 and labels [S, Hp, Wp] int32 — so each train step
ships ~20 bytes of crop decisions per crop (ops/crop_gather.py) instead
of the crop pixels.

Residency is keyed by Sample object identity: a re-decoded image (a new
Sample) uploads again, as the host cache's semantics say. The geometry
grows monotonically (slot count in powers of two, spatial sizes in
256-pixel buckets) and every growth uploads the residents again; eviction
is least-recently-used among the slots the batch does not reference.
Labels cross to the device as uint16 (2 bytes a pixel) and widen to int32
there, so IGNORE_LABEL (0xFFFF) stays 65535: torch's uint16 has few ops,
and a signed int16 would turn it into -1.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


def _bucket(v: int, b: int = 256) -> int:
    return ((v + b - 1) // b) * b


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """A tensor over ``a`` (a copy when ``a`` is read-only, as a cached
    sample's arrays may be: torch wants writable memory)."""
    return torch.from_numpy(a if a.flags.writeable else a.copy())


class DeviceImagePool:
    """Device-side LRU of decoded samples, managed by the host."""

    def __init__(self, slots: int = 8, *, device):
        if slots < 1:
            raise ValueError("slots must be >= 1")
        self.device = torch.device(device)
        # LRU capacity (--cached-image-count); slots are allocated lazily,
        # in powers of two, as distinct residents arrive
        self._capacity = 1 << (slots - 1).bit_length()
        self._slots = 0
        self._height = 0
        self._width = 0
        self._channels = 0
        self.images: Optional[torch.Tensor] = None  # [S, Hp, Wp, C] uint8
        self.labels: Optional[torch.Tensor] = None  # [S, Hp, Wp] int32
        # slot -> (sample_id, sample, h, w); LRU order by _tick
        self._resident: Dict[int, Tuple[int, object, int, int]] = {}
        self._by_id: Dict[int, int] = {}  # sample_id -> slot
        self._last_used: Dict[int, int] = {}  # slot -> tick
        self._tick = 0
        self.uploads = 0  # telemetry: number of image uploads
        self.upload_bytes = 0

    @property
    def shape(self) -> Tuple[int, int, int, int]:
        return (self._slots, self._height, self._width, self._channels)

    def _ensure_geometry(self, h: int, w: int, c: int, needed_slots: int):
        """Grow the pool (slots and/or spatial size) to fit; upload the
        residents again after a growth."""
        new_slots = max(self._slots, 1)
        while new_slots < needed_slots:
            new_slots *= 2
        new_h = max(self._height, _bucket(h))
        new_w = max(self._width, _bucket(w))
        new_c = max(self._channels, c)
        if self.images is not None and (new_slots, new_h, new_w, new_c) == self.shape:
            return
        residents = list(self._resident.items())
        self._slots, self._height, self._width, self._channels = (
            new_slots, new_h, new_w, new_c,
        )
        self.images = torch.zeros((new_slots, new_h, new_w, new_c), dtype=torch.uint8,
                                  device=self.device)
        self.labels = torch.zeros((new_slots, new_h, new_w), dtype=torch.int32,
                                  device=self.device)
        for slot, (_sid, sample, _h, _w) in residents:
            self._upload(slot, sample)

    def _upload(self, slot: int, sample) -> None:
        img = np.ascontiguousarray(sample.input_image)
        lab = np.ascontiguousarray(sample.label_image, dtype=np.uint16)
        h, w = img.shape[:2]
        self.images[slot, :h, :w] = _host_tensor(img).to(self.device)
        self.labels[slot, :h, :w] = _host_tensor(lab).to(self.device).to(torch.int32)
        self._resident[slot] = (id(sample), sample, h, w)
        self._by_id[id(sample)] = slot
        self.uploads += 1
        self.upload_bytes += img.nbytes + lab.nbytes

    def ensure(self, samples: List[object]) -> np.ndarray:
        """Make every sample resident; returns the per-sample slot indices
        (int32 [len(samples)]). Grows the pool when the batch references
        more distinct samples than are allocated, or a bigger image (the
        gather clamps into each image's valid area, so a slot need not be
        crop-sized, unlike the JAX pool's)."""
        distinct: Dict[int, object] = {}
        for s in samples:
            distinct.setdefault(id(s), s)
        max_h = max(s.input_image.shape[0] for s in distinct.values())
        max_w = max(s.input_image.shape[1] for s in distinct.values())
        channels = next(iter(distinct.values())).input_image.shape[2]
        missing = [s for sid, s in distinct.items() if sid not in self._by_id]
        target_slots = max(
            len(distinct),
            min(len(self._resident) + len(missing), self._capacity),
        )
        self._ensure_geometry(max_h, max_w, channels, target_slots)
        if missing:
            # evict least-recently-used slots NOT referenced by this batch
            batch_ids = set(distinct.keys())
            free = [s for s in range(self._slots) if s not in self._resident]
            evictable = sorted(
                (s for s, (sid, *_rest) in self._resident.items() if sid not in batch_ids),
                key=lambda s: self._last_used.get(s, 0),
            )
            for sample in missing:
                slot = free.pop(0) if free else evictable.pop(0)
                old = self._resident.pop(slot, None)
                if old is not None:
                    self._by_id.pop(old[0], None)
                self._upload(slot, sample)

        self._tick += 1
        out = np.empty(len(samples), np.int32)
        for i, s in enumerate(samples):
            slot = self._by_id[id(s)]
            self._last_used[slot] = self._tick
            out[i] = slot
        return out

    def valid_dims(self, slot_idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Per-crop (valid_h, valid_w) int32 arrays for gather_crops."""
        hs = np.empty(len(slot_idx), np.int32)
        ws = np.empty(len(slot_idx), np.int32)
        for i, s in enumerate(slot_idx):
            _sid, _sample, h, w = self._resident[int(s)]
            hs[i] = h
            ws[i] = w
        return hs, ws
