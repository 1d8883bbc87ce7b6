"""The work of one RI-HFX exchange step (``calls/rihfx_step.py``), for its
rooflines: counted from the configuration alone (B's pattern rules, D's
pattern), never from the program's plan, tile edge or batches.

* operations: 2·Σ m·k·n over the block triples of both contractions,
  X = B·D (μ, λ, P with λ, σ) and K = X·B (μ, σ, P with ν, σ, P), X taken
  over its superset (every block computed before the filter);
* bytes: B's and D's stored elements read, X's superset written, at the
  element size;
* refold bytes: X's superset elements read once and written once.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import scipy.sparse as sp
import torch

from . import spec
from .operands import dtype_of
from .reference import ri_hfx as ri
from .workcount import Work


@dataclass(frozen=True)
class RIWork:
    step: Work  # both contractions
    refold_bytes: float


@lru_cache(maxsize=4)
def _work(cfg_json: str) -> RIWork:
    cfg = json.loads(cfg_json)
    pattern = spec.module("patterns", cfg["pattern"])
    pos, box, oxygen = pattern.geometry(cfg)
    d = pattern.make(cfg).blocks
    pat = ri.pattern(cfg, pos, box, oxygen)
    na = pat.atoms
    ao = pat.ao.astype(np.float64)
    b_el = ao[pat.mu] * ao[pat.lam] * pat.ri[pat.p]
    # X = B·D: Σ over B's blocks of m·p·n_λ times Σ_σ n_σ over D's row λ
    d_row = np.bincount(d.rows, weights=ao[d.cols], minlength=na)
    flops = 2.0 * float(np.sum(b_el * d_row[pat.lam]))
    # X's superset: (μ, P) rows of B times D
    bm = sp.csr_matrix((np.ones(pat.n), (pat.mu * na + pat.p, pat.lam)), shape=(na * na, na))
    dm = sp.csr_matrix((np.ones(d.n), (d.rows, d.cols)), shape=(na, na))
    x = (bm @ dm).tocoo()
    x_mu, x_p, x_sig = x.row // na, x.row % na, x.col
    x_el = ao[x_mu] * pat.ri[x_p] * ao[x_sig]
    # K = X·B: Σ over X's blocks (μ, σ, P) of m·n_σ·p times Σ_ν n_ν over B(ν, σ, P)
    b_nu = np.bincount(pat.lam * na + pat.p, weights=ao[pat.mu], minlength=na * na)
    flops += 2.0 * float(np.sum(x_el * b_nu[x_sig * na + x_p]))
    size = torch.empty(0, dtype=dtype_of(cfg["dtype"])).element_size()
    d_el = float(np.sum(ao[d.rows] * ao[d.cols]))
    elems = float(b_el.sum()) + d_el + float(x_el.sum())
    return RIWork(step=Work(flops=flops, bytes=elems * size),
                  refold_bytes=2.0 * float(x_el.sum()) * size)


def ri_work(cfg: dict) -> RIWork:
    return _work(json.dumps(cfg, sort_keys=True))
