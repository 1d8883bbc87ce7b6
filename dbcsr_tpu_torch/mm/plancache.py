"""Plan cache for repeated one-shot multiplies.

Copy of ``dbcsr_tpu/mm/plancache.py`` (the distribution key names the
grid's rank devices where the JAX one names its mesh devices): iterative
callers that do not use ``build_multiply_executor`` still repeat products
over identical sparsity patterns (SCF steps), so a small
content-keyed LRU reuses the symbolic product, the C index and the local
plan across calls. Keys are fingerprints of the index CONTENT (pattern +
block sizes), so the cache is safe across object lifetimes and data
changes.

Entries that hold maps on a device (TAS extraction and merge, whose maps
are element-level, and the tensor refold's block plan) state their size:
those are also held to a byte
budget, ``max_bytes`` (least recently used first; an entry larger than the
budget is rebuilt on every call), and ``nbytes`` says what they hold now.
The JAX package's cache holds only the refold maps and has no budget.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np

from ..block.index import BCSRIndex

__all__ = ["index_fingerprint", "array_fingerprint", "dist_fingerprint",
           "PlanCache", "get_plan_cache"]

_CAPACITY = 64
_MAX_BYTES = 8 << 30  # 10% of an 80 GB card


def index_fingerprint(index: BCSRIndex) -> bytes:
    """Stable content hash of an index (cached on the index object)."""
    def mk():
        h = hashlib.blake2b(digest_size=16)
        h.update(index.row_block_sizes.tobytes())
        h.update(index.col_block_sizes.tobytes())
        h.update(index.row_ptr.tobytes())
        h.update(index.col_idx.tobytes())
        return h.digest()

    return index._cached("fingerprint", mk)


def array_fingerprint(*arrays) -> bytes:
    """Stable content hash over numpy arrays."""
    h = hashlib.blake2b(digest_size=16)
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.digest()


def dist_fingerprint(dist) -> bytes:
    """Content hash of a Distribution (grid shape, rank devices and owner
    processes, row/col maps), cached on the object: two grids of one shape
    over other devices or processes must not share a cached executor (it
    holds tensors on those devices, for those ranks)."""
    if getattr(dist, "_fingerprint", None) is None:
        g = dist.grid
        h = hashlib.blake2b(digest_size=16)
        h.update(bytes([g.nprow, g.npcol, g.nlayer]))
        h.update(repr([str(d) for d in g.devices.flat]).encode())
        h.update(np.ascontiguousarray(g.owners, dtype=np.int64).tobytes())
        h.update(array_fingerprint(dist.row_dist, dist.col_dist))
        object.__setattr__(dist, "_fingerprint", h.digest())
    return dist._fingerprint


class PlanCache:
    def __init__(self, capacity: int = _CAPACITY, max_bytes: int = _MAX_BYTES):
        self._cap = capacity
        self.max_bytes = max_bytes
        self._store: OrderedDict = OrderedDict()
        self._sizes: dict = {}  # key -> bytes, for entries that state them
        self.nbytes = 0
        self.hits = 0
        self.misses = 0

    def key(
        self, a_index: BCSRIndex, ta: bool, b_index: BCSRIndex, tb: bool,
        extra: Tuple = (),
    ) -> Tuple:
        return (
            index_fingerprint(a_index), ta, index_fingerprint(b_index), tb,
        ) + extra

    def get(self, key) -> Optional[object]:
        if key in self._store:
            self._store.move_to_end(key)
            self.hits += 1
            return self._store[key]
        self.misses += 1
        return None

    def put(self, key, value, nbytes: int = 0) -> None:
        """Keep ``value`` under ``key``; ``nbytes`` is the device memory it
        holds. An entry over the byte budget is not kept."""
        if nbytes > self.max_bytes:
            return
        self._drop(key)
        self._store[key] = value
        if nbytes:
            self._sizes[key] = nbytes
            self.nbytes += nbytes
        while len(self._store) > self._cap:
            self._drop(next(iter(self._store)))
        while self.nbytes > self.max_bytes:  # the least recently used sized entry
            self._drop(next(k for k in self._store if k in self._sizes))

    def _drop(self, key) -> None:
        if self._store.pop(key, None) is not None:
            self.nbytes -= self._sizes.pop(key, 0)

    def clear(self) -> None:
        self._store.clear()
        self._sizes.clear()
        self.nbytes = 0
        self.hits = self.misses = 0


_cache = PlanCache()


def get_plan_cache() -> PlanCache:
    return _cache
