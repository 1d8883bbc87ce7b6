"""The central matrix type: host block index + device TILE STORE.

Port of ``dbcsr_tpu/block/bcsr.py`` (reference ``dbcsr_type``,
``src/core/dbcsr_types.F:362-461``):

- the CSR-of-blocks index lives on the host (numpy, ``index.py``);
- the device data is the matrix's own tile store, a torch tensor
  ``[n_tiles, T, T]`` holding the dense content of every T×T tile that
  overlaps a stored block and exactly 0 everywhere no block covers (the
  padding-zero invariant, ``store.py``);
- the reference's element-contiguous ``data_area`` layout survives on the
  host only, as the interchange format for assembly and block access
  (``flat_host``/``with_flat``).

Stores are float32, bfloat16, float64, complex64 or complex128 tensors on
any device (complex interleaved, as torch keeps it; the JAX package splits
complex into two real planes only where its device cannot hold complex).
Symmetry (``N``/``S``/``A``/``H``) stores only the upper block triangle
(i <= j); ``to_dense`` and ``ops.desymmetrize`` expand it, ``H`` as the
conjugate transpose.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..core.errors import dbcsr_assert
from .index import BCSRIndex, build_index
from .store import StoreLayout, store_layout

__all__ = [
    "BCSRMatrix", "BCSRBuilder", "SYM_NONE", "SYM_SYMMETRIC",
    "SYM_ANTISYMMETRIC", "SYM_HERMITIAN", "default_tile", "torch_dtype",
]

SYM_NONE = "N"
SYM_SYMMETRIC = "S"
SYM_ANTISYMMETRIC = "A"
SYM_HERMITIAN = "H"
_SYMS = (SYM_NONE, SYM_SYMMETRIC, SYM_ANTISYMMETRIC, SYM_HERMITIAN)

_TORCH_OF_NP = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
}
_NP_OF_TORCH = {v: k for k, v in _TORCH_OF_NP.items()}


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy or torch dtype (float32, float64,
    bfloat16, complex64, complex128); integer dtypes raise."""
    if isinstance(dtype, torch.dtype):
        if dtype in _NP_OF_TORCH or dtype == torch.bfloat16:
            return dtype
    else:
        dt = np.dtype(dtype)
        if dt in _TORCH_OF_NP:
            return _TORCH_OF_NP[dt]
    raise TypeError(f"unsupported matrix dtype {dtype!r}")


def _host_dtype(tdt: torch.dtype) -> np.dtype:
    """numpy dtype the host assembles a ``tdt`` store in (bfloat16 stores
    are assembled in float32 and rounded once on the device)."""
    return _NP_OF_TORCH.get(tdt, np.dtype(np.float32))


def default_tile() -> int:
    from ..core.config import get_config

    return get_config().tile_size


@dataclass(frozen=True)
class BCSRMatrix:
    name: str
    index: BCSRIndex
    data: torch.Tensor  # tile store [n_tiles, T, T]; padding positions == 0
    sym: str = SYM_NONE
    dist: Optional[object] = None  # dist.Distribution, None = local/replicated

    def __post_init__(self):
        dbcsr_assert(self.sym in _SYMS, f"bad symmetry {self.sym!r}")
        dbcsr_assert(
            self.data.dim() == 3 and self.data.shape[1] == self.data.shape[2],
            f"data must be a [n_tiles, T, T] tile store, got {tuple(self.data.shape)}",
        )

    # -- layout -------------------------------------------------------------
    @property
    def tile(self) -> int:
        return int(self.data.shape[1])

    @property
    def layout(self) -> StoreLayout:
        return store_layout(self.index, self.tile)

    # -- shape / structure ------------------------------------------------
    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def nblkrows(self) -> int:
        return self.index.nblkrows

    @property
    def nblkcols(self) -> int:
        return self.index.nblkcols

    @property
    def nblks(self) -> int:
        return self.index.nblks

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.index.nfullrows, self.index.nfullcols)

    @property
    def row_block_sizes(self) -> np.ndarray:
        return self.index.row_block_sizes

    @property
    def col_block_sizes(self) -> np.ndarray:
        return self.index.col_block_sizes

    def occupation(self) -> float:
        """Fraction of nonzero elements (``dbcsr_get_occupation``)."""
        full = self.index.nfullrows * self.index.nfullcols
        if full == 0:
            return 0.0
        if self.sym == SYM_NONE:
            stored = self.index.nelems
        else:
            bm, bn = self.index.blk_shapes
            diag = self.index.blk_rows == self.index.col_idx
            sizes = bm.astype(np.int64) * bn
            stored = int(2 * sizes.sum() - sizes[diag].sum())
        return stored / full

    def with_data(self, data: torch.Tensor) -> "BCSRMatrix":
        dbcsr_assert(data.shape == self.data.shape, "store shape mismatch")
        return replace(self, data=data)

    def with_flat(self, flat) -> "BCSRMatrix":
        """Replace data from host-side flat block data (reference layout)."""
        flat = np.asarray(flat).reshape(-1)
        dbcsr_assert(len(flat) == self.index.nelems, "flat size mismatch")
        torch_dtype(flat.dtype)  # rejects integer data
        store = torch.from_numpy(self.layout.store_from_flat(flat))
        return replace(self, data=store.to(self.device))

    def astype(self, dtype) -> "BCSRMatrix":
        return replace(self, data=self.data.to(torch_dtype(dtype)))

    # -- host access (block granularity) ------------------------------------
    def flat_host(self) -> np.ndarray:
        """Flat block data on the host (block b occupies
        ``flat[blk_offset[b]:blk_offset[b+1]]`` row-major). bfloat16 stores
        come back as float32."""
        host = self.data.detach().cpu()
        if host.dtype == torch.bfloat16:
            host = host.float()
        return self.layout.flat_from_store(host.numpy())

    def get_block(self, row: int, col: int) -> Optional[np.ndarray]:
        """Fetch one block to the host; handles symmetric reflection; None
        if absent (``dbcsr_get_block_p`` analog)."""
        tr = False
        if self.sym != SYM_NONE and row > col:
            row, col, tr = col, row, True
        b = self.index.block_id(row, col)
        if b < 0:
            return None
        o0, o1 = int(self.index.blk_offset[b]), int(self.index.blk_offset[b + 1])
        bm = int(self.index.row_block_sizes[row])
        bn = int(self.index.col_block_sizes[col])
        dest = torch.as_tensor(self.layout.elem_dest[o0:o1], device=self.device)
        blk = self.data.reshape(-1)[dest].cpu()
        if blk.dtype == torch.bfloat16:
            blk = blk.float()
        blk = blk.numpy().reshape(bm, bn)
        if tr:
            blk = blk.T
            if self.sym == SYM_ANTISYMMETRIC:
                blk = -blk
            elif self.sym == SYM_HERMITIAN:
                blk = np.conj(blk)
        return blk

    def iter_blocks(self) -> Iterator[Tuple[int, int, np.ndarray]]:
        """Yield (row, col, block) over stored blocks (one host transfer)."""
        host = self.flat_host()
        bm_all, bn_all = self.index.blk_shapes
        rows = self.index.blk_rows
        for b in range(self.nblks):
            o0, o1 = int(self.index.blk_offset[b]), int(self.index.blk_offset[b + 1])
            yield int(rows[b]), int(self.index.col_idx[b]), host[o0:o1].reshape(
                int(bm_all[b]), int(bn_all[b])
            )

    # -- conversions ------------------------------------------------------
    def to_dense(self) -> torch.Tensor:
        """Full dense matrix (symmetry expanded) on the store's device: a
        tile-level copy into the padded grid, then one reshape."""
        lay = self.layout
        t = self.tile
        grid = self.data.new_zeros((lay.ntr * lay.ntc, t, t))
        if lay.n_tiles:
            keys = torch.as_tensor(lay.tile_keys(), device=self.device)
            grid[keys] = self.data
        dense = (
            grid.reshape(lay.ntr, lay.ntc, t, t)
            .permute(0, 2, 1, 3)
            .reshape(lay.ntr * t, lay.ntc * t)
        )
        out = dense[: self.index.nfullrows, : self.index.nfullcols]
        if self.sym != SYM_NONE:
            lower = torch.ones(out.shape, dtype=torch.bool, device=self.device).tril(-1)
            refl = out.T
            if self.sym == SYM_ANTISYMMETRIC:
                refl = -refl
            elif self.sym == SYM_HERMITIAN:
                refl = refl.conj()
            out = torch.where(lower, refl, out)
        return out

    @staticmethod
    def from_dense(
        dense,
        row_block_sizes,
        col_block_sizes,
        *,
        device,
        name: str = "from_dense",
        keep_zero_blocks: bool = False,
        tol: float = 0.0,
        tile: Optional[int] = None,
        dist=None,
    ) -> "BCSRMatrix":
        """Blocked sparsification of a dense matrix (host-side setup
        utility, analog of ``src/ops/dbcsr_test_methods.F``)."""
        if isinstance(dense, torch.Tensor):
            dense_np = dense.detach().cpu().numpy()
        else:
            dense_np = np.asarray(dense)
        rbs = np.asarray(row_block_sizes, dtype=np.int32)
        cbs = np.asarray(col_block_sizes, dtype=np.int32)
        ro = np.concatenate([[0], np.cumsum(rbs)])
        co = np.concatenate([[0], np.cumsum(cbs)])
        dbcsr_assert(dense_np.shape == (ro[-1], co[-1]), "shape mismatch")
        rows: List[int] = []
        cols: List[int] = []
        blocks: List[np.ndarray] = []
        for i in range(len(rbs)):
            for j in range(len(cbs)):
                blk = dense_np[ro[i]:ro[i + 1], co[j]:co[j + 1]]
                if keep_zero_blocks or np.linalg.norm(blk) > tol:
                    rows.append(i)
                    cols.append(j)
                    blocks.append(blk)
        return BCSRMatrix.from_blocks(
            rows, cols, blocks, rbs, cbs, name=name, dtype=dense_np.dtype,
            device=device, tile=tile, dist=dist,
        )

    @staticmethod
    def from_flat(
        index: BCSRIndex,
        flat: np.ndarray,
        *,
        device,
        name: str = "matrix",
        sym: str = SYM_NONE,
        tile: Optional[int] = None,
        dtype=None,
        dist=None,
    ) -> "BCSRMatrix":
        """Construct from a canonical index + host flat block data; the
        store is built on the host and moved to ``device`` once (and
        rounded there when ``dtype`` is bfloat16)."""
        t = tile or default_tile()
        lay = store_layout(index, t)
        flat = np.asarray(flat).reshape(-1)
        tdt = torch_dtype(dtype if dtype is not None else flat.dtype)
        store = torch.from_numpy(lay.store_from_flat(flat))
        return BCSRMatrix(
            name=name, index=index, data=store.to(device=device, dtype=tdt),
            sym=sym, dist=dist,
        )

    @staticmethod
    def from_blocks(
        rows,
        cols,
        blocks,
        row_block_sizes,
        col_block_sizes,
        *,
        device,
        name: str = "matrix",
        sym: str = SYM_NONE,
        dtype=None,
        tile: Optional[int] = None,
        dist=None,
    ) -> "BCSRMatrix":
        """Construct from COO block lists (fast path around the builder)."""
        rbs = np.asarray(row_block_sizes, dtype=np.int32)
        cbs = np.asarray(col_block_sizes, dtype=np.int32)
        idx, order = build_index(np.asarray(rows), np.asarray(cols), rbs, cbs)
        if dtype is None:
            dtype = blocks[0].dtype if blocks else np.float32
        tdt = torch_dtype(dtype)
        hdt = _host_dtype(tdt)
        if idx.nblks:
            from ..native import flatten_blocks

            flat = flatten_blocks(blocks, order, hdt)
            if flat is None:
                flat = np.concatenate(
                    [np.asarray(blocks[int(o)], dtype=hdt).ravel() for o in order]
                )
        else:
            flat = np.zeros((0,), dtype=hdt)
        return BCSRMatrix.from_flat(
            idx, flat, name=name, sym=sym, tile=tile, device=device, dtype=tdt,
            dist=dist,
        )

    @staticmethod
    def empty(
        row_block_sizes,
        col_block_sizes,
        *,
        device,
        name: str = "empty",
        dtype=torch.float32,
        sym: str = SYM_NONE,
        tile: Optional[int] = None,
        dist=None,
    ) -> "BCSRMatrix":
        return BCSRMatrix.from_blocks(
            [], [], [], row_block_sizes, col_block_sizes,
            name=name, sym=sym, dtype=dtype, tile=tile, device=device,
            dist=dist,
        )


class BCSRBuilder:
    """Mutable assembly buffer → immutable matrix at ``finalize``.

    Analog of the reference's work matrices + ``dbcsr_finalize``
    (``src/work/dbcsr_work_operations.F``): ``put_block`` appends or
    accumulates (``sum=True`` adds into an existing staged block);
    ``finalize`` sorts, merges and builds the canonical index and the tile
    store on ``device``.
    """

    def __init__(
        self,
        row_block_sizes,
        col_block_sizes,
        *,
        device,
        name: str = "matrix",
        dtype=np.float32,
        sym: str = SYM_NONE,
        tile: Optional[int] = None,
        dist=None,
    ):
        self.row_block_sizes = np.asarray(row_block_sizes, dtype=np.int32)
        self.col_block_sizes = np.asarray(col_block_sizes, dtype=np.int32)
        self.name = name
        self.dtype = torch_dtype(dtype)
        self.sym = sym
        self.tile = tile
        self.dist = dist
        self.device = device
        self._blocks: Dict[Tuple[int, int], np.ndarray] = {}

    def put_block(self, row: int, col: int, block, *, sum: bool = False) -> None:
        if self.sym != SYM_NONE and row > col:
            raise ValueError(
                "symmetric builders store the upper block triangle (i <= j)"
            )
        bm = int(self.row_block_sizes[row])
        bn = int(self.col_block_sizes[col])
        blk = np.asarray(block, dtype=_host_dtype(self.dtype)).reshape(bm, bn)
        key = (row, col)
        if sum and key in self._blocks:
            self._blocks[key] = self._blocks[key] + blk
        else:
            self._blocks[key] = blk

    def reserve_block(self, row: int, col: int) -> None:
        """Reserve a zero block (``dbcsr_reserve_block2d`` analog); a later
        ``put_block`` overwrites it, and a staged block stays as it is."""
        if (row, col) not in self._blocks:
            self.put_block(
                row,
                col,
                np.zeros(
                    (self.row_block_sizes[row], self.col_block_sizes[col]),
                    dtype=_host_dtype(self.dtype),
                ),
            )

    def reserve_blocks(self, rows, cols) -> None:
        """Reserve many zero blocks (``dbcsr_reserve_blocks``)."""
        for r, c in zip(rows, cols):
            self.reserve_block(int(r), int(c))

    def reserve_all_blocks(self) -> None:
        """Reserve the full block grid (``dbcsr_reserve_all_blocks``); its
        upper triangle only under symmetry (``sym`` other than N)."""
        for r in range(len(self.row_block_sizes)):
            lo = r if self.sym != SYM_NONE else 0
            for c in range(lo, len(self.col_block_sizes)):
                self.reserve_block(r, c)

    def reserve_diag_blocks(self) -> None:
        """Reserve the diagonal blocks (``dbcsr_reserve_diag_blocks``)."""
        n = min(len(self.row_block_sizes), len(self.col_block_sizes))
        for r in range(n):
            self.reserve_block(r, r)

    def finalize(self) -> BCSRMatrix:
        keys = list(self._blocks.keys())
        return BCSRMatrix.from_blocks(
            [k[0] for k in keys], [k[1] for k in keys],
            [self._blocks[k] for k in keys],
            self.row_block_sizes, self.col_block_sizes,
            name=self.name, sym=self.sym, dtype=self.dtype, tile=self.tile,
            device=self.device, dist=self.dist,
        )
