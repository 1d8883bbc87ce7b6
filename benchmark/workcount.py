"""The work a product's inputs need, for the roofline: counted from the
block pattern alone, never from the program's plan, tile edge or route, so
it reads the same whatever implements the product.

* operations: 2·Σ m·k·n real operations over the block triples (i, k, j)
  of A·B (the superset product: every superset block is computed before a
  filter), four times that for complex elements;
* bytes: A's and B's stored block elements read once, C's superset block
  elements written once, at the element size.

The least time is the larger of operations over the card's peak rate and
bytes over its memory rate (``peaks.json``).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import scipy.sparse as sp

import torch

from .operands import dtype_of
from .reference.layout import Blocks

PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")


@dataclass(frozen=True)
class Work:
    flops: float
    bytes: float


def product_work(p: Blocks, dtype: str) -> Work:
    """The work of ``A·B`` where A and B share the pattern ``p``."""
    a = b = p
    nk = len(a.col_sizes)
    # Σ_j n_j over B's blocks in block row k
    n_of_row = np.bincount(b.rows, weights=b.k.astype(np.float64), minlength=nk)
    flops = 2.0 * float(np.sum(a.m.astype(np.float64) * a.k * n_of_row[a.cols]))
    pa = sp.csr_matrix((np.ones(a.n), (a.rows, a.cols)),
                       shape=(len(a.row_sizes), nk))
    pb = sp.csr_matrix((np.ones(b.n), (b.rows, b.cols)),
                       shape=(nk, len(b.col_sizes)))
    pc = (pa @ pb).tocoo()
    c_elems = float(np.sum(a.row_sizes[pc.row].astype(np.float64) * b.col_sizes[pc.col]))
    elems = float(np.sum(a.m * a.k)) + float(np.sum(b.m * b.k)) + c_elems
    x = torch.empty(0, dtype=dtype_of(dtype))
    return Work(flops=flops * (4 if x.is_complex() else 1), bytes=elems * x.element_size())


def peak(card: str) -> Optional[dict]:
    """The card's row of ``peaks.json``, or None for a card it lacks."""
    with open(PEAKS) as f:
        return json.load(f)["cards"].get(card)


def bound_s(work: Work, card: str, dtype: str) -> Optional[float]:
    """The least seconds the card could take for ``work``."""
    row = peak(card)
    if row is None:
        return None
    rate = row["flops"].get(dtype)
    if rate is None:
        return None
    return max(work.flops / rate, work.bytes / row["bytes_per_s"])
