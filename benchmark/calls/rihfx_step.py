"""One SCF step's RI-HFX exchange build through ``BatchedContract``: for
each batch of RI atoms P (``n_batches`` contiguous ranges),

    X(μ,σ,P) = Σ_λ B(μ,λ,P)·D(λ,σ)        bounds on P, eps-filtered at once
    X refolded from ((μ,P) | σ) to (μ | (σ,P))
    K(μ,ν)  += Σ_{σ,P} X(μ,σ,P)·B(ν,σ,P)  bounds on the contracted P

then K filtered once. B, the fitted 3-center tensor, is made once at
set-up from the geometry (``reference/ri_hfx.py``: its pattern and its
data, from a ``torch.Generator`` seeded with the first 64-bit word of the
harness's B store, so it follows ``--seed``), and it is symmetric in its
AO pair, so the second contraction reads it relabelled (``copy_tensor``
with ``order``, which moves nothing). Each call takes a new D (the
harness's A store over the density pattern) and returns K in mask form:
its blocks and its tile store, the dropped blocks zero."""
from __future__ import annotations

import numpy as np
import torch

from benchmark import products, spec
from benchmark.operands import dtype_of
from benchmark.reference import ri_hfx as ri
from benchmark.reference.layout import Blocks, dense_rows, positions, tile_keys, write_rows

COMPARED = "block_err"
#: elements a chunk of B's store writes at once
_CHUNK = 1 << 26


def ri_pattern(cfg: dict) -> ri.RIPattern:
    pos, box, oxygen = spec.module("patterns", cfg["pattern"]).geometry(cfg)
    return ri.pattern(cfg, pos, box, oxygen)


def b_data(cfg: dict, ops, dtype=None):
    """(pattern, values by class) of B, from the seed in ``ops.b``."""
    pat = ri_pattern(cfg)
    dt = dtype or dtype_of(cfg["dtype"])
    return pat, ri.values(pat, ri.seed_word(ops.b), ops.b.device, dt)


def b_store(pat: ri.RIPattern, vals, tile: int, device):
    """B's fold ((μ, P) | λ) as a block list and a tile store
    (``reference/layout.py``)."""
    rows, cols, rs, cs = ri.fold_blocks(pat)
    blocks = Blocks(rows=rows, cols=cols, row_sizes=rs, col_sizes=cs)
    keys = tile_keys(blocks, tile)
    dtype = next(iter(vals.values())).dtype
    store = torch.zeros((len(keys), tile, tile), dtype=dtype, device=device)
    flat = store.view(-1)
    for (m, n, p), ids in pat.classes().items():
        step = max(1, _CHUNK // (m * n * p))
        for s in range(0, len(ids), step):
            pos = positions(blocks, ids[s:s + step], (m * p, n), keys, tile, device)
            # natural (μ, λ, P) -> the fold's (μ, P) rows and λ columns
            flat[pos.reshape(-1)] = vals[(m, n, p)][s:s + step].permute(0, 1, 3, 2).reshape(-1)
            del pos
    return blocks, keys, store


def element_ranges(pat: ri.RIPattern, n_batches: int):
    off = ri.offsets(pat.ri)
    return [(int(off[a0]), int(off[a1])) for a0, a1 in ri.batches(pat, n_batches)]


class Program:
    def __init__(self, cfg, ops, grid=None):
        import dbcsr_tpu_torch as dt
        from dbcsr_tpu_torch.tensors import BatchedContract, NDMapping, Tensor, copy_tensor

        tile = int(cfg["tile"])
        pat, vals = b_data(cfg, ops)
        blocks, keys, store = b_store(pat, vals, tile, ops.b.device)
        del vals
        idx, order = dt.build_index(blocks.rows, blocks.cols, blocks.row_sizes.astype(np.int32),
                                    blocks.col_sizes.astype(np.int32))
        if not np.array_equal(order, np.arange(blocks.n)):
            raise RuntimeError("B's blocks are not in the program's canonical order")
        from dbcsr_tpu_torch.block.store import store_layout

        if not np.array_equal(store_layout(idx, tile).tile_keys(), keys):
            raise RuntimeError("the program's store layout differs from the benchmark's")
        ao, rib = pat.ao.astype(np.int32), pat.ri.astype(np.int32)
        self.b = Tensor(name="B", block_sizes=(ao, ao, rib), mapping=NDMapping(3, (0, 2), (1,)),
                        matrix=dt.BCSRMatrix(name="B", index=idx, data=store))
        # B(ν, σ, P) = B(σ, ν, P): the at-rest copy with its AO dims relabelled
        self.bt = copy_tensor(self.b, order=(1, 0, 2), name="Bt")
        self.d_index = products.matrices(cfg, ops)[0].index
        self.ao = ao
        self.NDMapping, self.Tensor, self.BCSRMatrix = NDMapping, Tensor, dt.BCSRMatrix
        self.ranges = element_ranges(pat, int(cfg["n_batches"]))
        self.eps = float(cfg["filter_eps"])
        self.bc = BatchedContract()
        self.like = Blocks(rows=np.zeros(0, np.int64), cols=np.zeros(0, np.int64),
                           row_sizes=pat.ao, col_sizes=pat.ao)

    def __call__(self, d_data):
        NDMapping = self.NDMapping
        d = self.Tensor(name="D", block_sizes=(self.ao, self.ao), mapping=NDMapping(2, (0,), (1,)),
                        matrix=self.BCSRMatrix(name="D", index=self.d_index, data=d_data))
        k = None
        for lo, hi in self.ranges:
            x = self.bc.contract(self.b, d, contract_1=(1,), notcontract_1=(0, 2),
                                 contract_2=(0,), notcontract_2=(1,), map_1=(0, 2), map_2=(1,),
                                 bounds={"nc1": {2: (lo, hi)}}, filter_eps=self.eps)
            x = x.with_layout(NDMapping(3, (0,), (1, 2)))
            k = self.bc.contract(x, self.bt, contract_1=(1, 2), notcontract_1=(0,),
                                 contract_2=(1, 2), notcontract_2=(0,),
                                 bounds={"contract": {2: (lo, hi)}}, filter_eps=self.eps,
                                 beta=0.0 if k is None else 1.0, c=k)
            del x
        return self.bc.filter(k, self.eps)

    def output(self, out):
        return products.blocks_of(out.matrix.index, self.like), out.matrix.data

    def release(self) -> None:
        self.bc.finalize()
        self.b = self.bt = None


def _dense_d(ops, a_store: torch.Tensor, n: int, dtype) -> torch.Tensor:
    ntc = -(-n // int(a_store.shape[-1]))
    return dense_rows(a_store, ops.keys, ntc, 0, ntc, dtype)[:n, :n]


def judge(cfg, ops):
    """``block_err`` of K against the plain reference in the
    configuration's type (``reference/ri_hfx.py``)."""
    pat, vals = b_data(cfg, ops)
    eps, tie = float(cfg["filter_eps"]), float(cfg["norm_tie_rel"])
    ranges = ri.batches(pat, int(cfg["n_batches"]))
    n = int(pat.ao.sum())
    tile = int(cfg["tile"])
    ntc = -(-n // tile)

    def err(a_store: torch.Tensor, out: Blocks, store: torch.Tensor) -> float:
        keys = tile_keys(out, tile)
        if tuple(store.shape) != (len(keys), tile, tile) or (
                out.n and (out.rows.max() >= pat.atoms or out.cols.max() >= pat.atoms)):
            return float("inf")
        ref = ri.step(pat, vals, _dense_d(ops, a_store, n, vals_dtype(vals)), eps, tie,
                      ranges=ranges)
        listed = torch.zeros((pat.atoms, pat.atoms), dtype=torch.bool, device=store.device)
        listed[torch.as_tensor(out.rows, device=store.device),
               torch.as_tensor(out.cols, device=store.device)] = True
        k = dense_rows(store, keys, ntc, 0, ntc, torch.float64)[:n, :n]
        return ri.k_err(ref, pat, k, listed, eps, tie)

    return err


def vals_dtype(vals) -> torch.dtype:
    return next(iter(vals.values())).dtype


class Control:
    """The reference in ``cfg["control_dtype"]`` in the program's place: the
    step, X's and K's filters in that type; K over every (μ, ν) block, in
    mask form."""

    def __init__(self, cfg, ops):
        self.ops = ops
        self.pat, self.vals = b_data(cfg, ops, dtype_of(cfg["control_dtype"]))
        self.eps, self.tie = float(cfg["filter_eps"]), float(cfg["norm_tie_rel"])
        self.ranges = ri.batches(self.pat, int(cfg["n_batches"]))
        self.tile = int(cfg["tile"])
        na = self.pat.atoms
        self.blocks = Blocks(rows=np.repeat(np.arange(na), na), cols=np.tile(np.arange(na), na),
                             row_sizes=self.pat.ao, col_sizes=self.pat.ao)
        self.out_dtype = ops.b.dtype

    def __call__(self, a_store: torch.Tensor):
        n = int(self.pat.ao.sum())
        st = ri.step(self.pat, self.vals, _dense_d(self.ops, a_store, n, vals_dtype(self.vals)),
                     self.eps, self.tie, dtype=vals_dtype(self.vals), ranges=self.ranges)
        k, _ = ri.dense_k_mask(st.k, self.pat, self.eps)
        t = self.tile
        nt = -(-n // t)
        keys = tile_keys(self.blocks, t)
        store = torch.zeros((len(keys), t, t), dtype=self.out_dtype, device=a_store.device)
        rows = torch.zeros((nt * t, nt * t), dtype=self.out_dtype, device=a_store.device)
        rows[:n, :n] = k
        write_rows(store, keys, nt, 0, rows)
        return self.blocks, store

    @staticmethod
    def output(out):
        return out

    def release(self) -> None:
        self.vals = None
