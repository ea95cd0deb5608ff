"""One LRU helper for the port's program caches, as ``repro/tig/cache.py``.

``engine.make_eval_epoch`` keeps its eval programs in a small dict cache
keyed by config, and each program keeps its captured CUDA graphs keyed by
stream and shape. Python dicts iterate in insertion order, so
move-to-end-on-hit + evict-front gives LRU semantics on a plain dict, and
the caches stay plain dicts that tests can read.
"""

from __future__ import annotations

from typing import Callable, Hashable, MutableMapping, TypeVar

__all__ = ["lru_get"]

T = TypeVar("T")

_MISS = object()


def lru_get(
    cache: MutableMapping[Hashable, T],
    key: Hashable,
    max_size: int,
    build: Callable[[], T],
) -> T:
    """Fetch ``key`` from ``cache`` with LRU eviction, building on miss.

    A hit re-inserts the entry at the back of the iteration order (most
    recent); a miss evicts from the front until the cache is below
    ``max_size``, then stores ``build()``.  ``build`` is only called on a
    miss.
    """
    hit = cache.pop(key, _MISS)
    if hit is _MISS:
        while len(cache) >= max_size:
            cache.pop(next(iter(cache)))
        hit = build()
    cache[key] = hit
    return hit
