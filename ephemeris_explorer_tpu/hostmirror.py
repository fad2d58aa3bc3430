"""Bounded device->host mirror caches.

Host-side engines (the numpy event scanner in `events`) need a numpy
mirror of a device-resident packed ephemeris.  Fetching it costs one device->host
transfer per pack snapshot, so mirrors are cached keyed on the identity of the
device coefficient buffer; the cache PINS that device array so its id()
cannot be recycled while the entry lives, and is bounded (LRU-evicted) so
retired snapshots do not accumulate.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, TypeVar

T = TypeVar("T")


def make_host_mirror(build: Callable[[object], T], capacity: int = 4):
    """Return ``mirror(dev_key, src) -> T`` caching ``build(src)`` by
    ``id(dev_key)``; ``dev_key`` is held in the entry to keep the id live."""
    cache: "OrderedDict[int, tuple[object, T]]" = OrderedDict()

    def mirror(dev_key: object, src: object) -> T:
        key = id(dev_key)
        hit = cache.get(key)
        if hit is not None:
            # LRU, not FIFO: a hot mirror must outlive cold ones, so a hit
            # refreshes recency (otherwise >capacity live snapshots cycling
            # would evict the hottest entry and re-fetch it every call)
            cache.move_to_end(key)
            return hit[1]
        val = build(src)
        cache[key] = (dev_key, val)
        while len(cache) > capacity:
            cache.popitem(last=False)
        return val

    mirror.cache = cache  # exposed for tests (eviction/pinning gates)
    return mirror
