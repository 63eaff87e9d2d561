"""Thread-shared bounded LRU cache for decoded full images (the port's
copy of ``annonet_tpu/data/cache.py``).

Replaces the lru-timday shared_lru_cache_using_std used at
annonet_train_main.cpp:504-510: capacity-bounded, keyed by the image/mask
filename pair, factory-populated, shared by all loader threads. Lookup is a
call, like the reference's functor interface.

A per-key in-flight lock ensures a sample is decoded once even when several
loader threads miss on the same key simultaneously (the reference's version
holds a global lock around the factory; here only same-key loads serialize,
so different images decode in parallel).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Dict, Generic, Hashable, TypeVar

K = TypeVar("K", bound=Hashable)
V = TypeVar("V")


class SharedLruCache(Generic[K, V]):
    def __init__(self, factory: Callable[[K], V], capacity: int):
        if capacity < 1:
            raise ValueError("cache capacity must be >= 1")
        self._factory = factory
        self._capacity = capacity
        self._lock = threading.Lock()
        self._items: "OrderedDict[K, V]" = OrderedDict()
        self._inflight: Dict[K, threading.Event] = {}

    def __call__(self, key: K) -> V:
        while True:
            with self._lock:
                if key in self._items:
                    self._items.move_to_end(key)
                    return self._items[key]
                event = self._inflight.get(key)
                if event is None:
                    event = threading.Event()
                    self._inflight[key] = event
                    break  # we are the loader for this key
            event.wait()  # someone else is loading it

        try:
            value = self._factory(key)
        except BaseException:
            with self._lock:
                del self._inflight[key]
            event.set()
            raise

        with self._lock:
            self._items[key] = value
            self._items.move_to_end(key)
            while len(self._items) > self._capacity:
                self._items.popitem(last=False)
            del self._inflight[key]
        event.set()
        return value

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)
