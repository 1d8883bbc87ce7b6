"""Plan cache for repeated one-shot multiplies.

Copy of ``dbcsr_tpu/mm/plancache.py`` without the distribution key:
iterative callers that do not use ``build_multiply_executor`` still repeat
products over identical sparsity patterns (SCF steps), so a small
content-keyed LRU reuses the symbolic product, the C index and the local
plan across calls. Keys are fingerprints of the index CONTENT (pattern +
block sizes), so the cache is safe across object lifetimes and data
changes.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np

from ..block.index import BCSRIndex

__all__ = ["index_fingerprint", "array_fingerprint", "PlanCache", "get_plan_cache"]

_CAPACITY = 64


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


class PlanCache:
    def __init__(self, capacity: int = _CAPACITY):
        self._cap = capacity
        self._store: OrderedDict = OrderedDict()
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

    def put(self, key, value) -> None:
        self._store[key] = value
        self._store.move_to_end(key)
        while len(self._store) > self._cap:
            self._store.popitem(last=False)

    def clear(self) -> None:
        self._store.clear()
        self.hits = self.misses = 0


_cache = PlanCache()


def get_plan_cache() -> PlanCache:
    return _cache
