"""Block-sparse tensor type (rank 2..4+).

Port of ``dbcsr_tpu/tensors/tensor.py`` (reference ``dbcsr_t_type``,
``src/tensors/dbcsr_tensor_types.F:127-154``): a tensor is a 2-D
block-sparse matrix (a :class:`BCSRMatrix` whose tile store lives on the
tensor's device; the TAS wrapping happens inside contraction) plus an
nd→2d mapping and per-dim block sizes. Elements inside a stored 2-D block
are row-major over the mapping's storage dim order (map1 dims then map2
dims).

Block access (``dbcsr_t_get_block/put_block/reserve_blocks``,
``src/tensors/dbcsr_tensor_block.F:64-76``) works in natural dim order —
get/put transpose between natural order and storage order, on the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..block.bcsr import BCSRMatrix, _host_dtype, torch_dtype
from ..block.index import build_index
from ..core.errors import dbcsr_assert
from .index import NDMapping, grouped_block_sizes

__all__ = [
    "Tensor", "TensorBuilder", "split_blocks", "tensor_from_matrix",
    "matrix_from_tensor",
]


@dataclass(frozen=True)
class Tensor:
    name: str
    block_sizes: Tuple[np.ndarray, ...]  # per-dim int32 block-size vectors
    mapping: NDMapping
    matrix: BCSRMatrix  # folded 2-D representation

    def __post_init__(self):
        dbcsr_assert(
            self.mapping.ndim == len(self.block_sizes), "mapping/dims mismatch"
        )

    # -- structure ---------------------------------------------------------
    @property
    def ndim(self) -> int:
        return len(self.block_sizes)

    @property
    def nblk_per_dim(self) -> Tuple[int, ...]:
        return tuple(len(b) for b in self.block_sizes)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(int(b.sum()) for b in self.block_sizes)

    @property
    def nblks(self) -> int:
        return self.matrix.nblks

    @property
    def dtype(self) -> torch.dtype:
        return self.matrix.dtype

    @property
    def device(self) -> torch.device:
        return self.matrix.device

    def occupation(self) -> float:
        full = float(np.prod([s for s in self.shape], dtype=np.float64))
        return self.matrix.index.nelems / full if full else 0.0

    # -- block access --------------------------------------------------------
    def block_indices(self) -> np.ndarray:
        """nd multi-indices [nblks, ndim] of stored blocks, natural order."""
        idx = self.matrix.index
        return self.mapping.unfold(
            idx.blk_rows.astype(np.int64),
            idx.col_idx.astype(np.int64),
            self.nblk_per_dim,
        )

    def get_block(self, bi: Sequence[int]) -> Optional[np.ndarray]:
        """Block at nd index ``bi`` in NATURAL dim order, on the host; None
        if absent (``dbcsr_t_get_block``)."""
        rows, cols = self.mapping.fold(np.asarray([bi]), self.nblk_per_dim)
        blk2d = self.matrix.get_block(int(rows[0]), int(cols[0]))
        if blk2d is None:
            return None
        order = self.mapping.dim_order
        shape_storage = tuple(
            int(self.block_sizes[d][bi[d]]) for d in order
        )
        nd = blk2d.reshape(shape_storage)
        # storage order -> natural order
        inv = np.argsort(order)
        return np.transpose(nd, axes=inv)

    def iter_blocks(self) -> Iterator[Tuple[Tuple[int, ...], np.ndarray]]:
        """(nd index, block in natural order) over stored blocks, on the
        host after one transfer (``dbcsr_t_iterator`` analog)."""
        indices = self.block_indices()
        order = self.mapping.dim_order
        inv = np.argsort(order)
        host = self.matrix.flat_host()
        off = self.matrix.index.blk_offset
        for b in range(self.nblks):
            bi = tuple(int(x) for x in indices[b])
            shp = tuple(int(self.block_sizes[d][bi[d]]) for d in order)
            blk = host[int(off[b]):int(off[b + 1])].reshape(shp)
            yield bi, np.transpose(blk, axes=inv)

    # -- conversions ---------------------------------------------------------
    def to_dense(self) -> torch.Tensor:
        """Full dense nd tensor on the tensor's device, assembled on the host
        (a test oracle utility, analog of the reference test helpers in
        ``dbcsr_tensor_test.F``)."""
        out = np.zeros(self.shape, dtype=_host_dtype(self.dtype))
        offs = [
            np.concatenate([[0], np.cumsum(b)]).astype(np.int64)
            for b in self.block_sizes
        ]
        for bi, blk in self.iter_blocks():
            sl = tuple(
                slice(int(offs[d][bi[d]]), int(offs[d][bi[d]] + blk.shape[d]))
                for d in range(self.ndim)
            )
            out[sl] = blk
        return torch.from_numpy(out).to(device=self.device, dtype=self.dtype)

    def with_layout(self, mapping: NDMapping) -> "Tensor":
        """Re-fold to a different (map1, map2) partition — the reference's
        tensor reshape (``dbcsr_t_reshape``, ``dbcsr_tensor_reshape.F``).
        One host index rebuild + one device element gather."""
        if (mapping.map1, mapping.map2) == (self.mapping.map1, self.mapping.map2):
            return self
        # the refold's host work (index rebuild + per-block transpose
        # map + store-map composition) is pure content; iterative
        # contractions refold the same operands every call, so cache it
        # (keyed on matrix index content + nd block sizes + both mappings,
        # and the device the prepared map lives on) and leave only one
        # device gather per call
        from ..block.gather import apply_prepared_gather, prepare_flat_gather
        from ..mm.plancache import (
            array_fingerprint, get_plan_cache, index_fingerprint,
        )

        _pc = get_plan_cache()
        _key = (
            "with_layout", index_fingerprint(self.matrix.index),
            array_fingerprint(*self.block_sizes), self.matrix.tile,
            self.mapping.map1, self.mapping.map2,
            mapping.map1, mapping.map2, str(self.device),
        )
        _hit = _pc.get(_key)
        if _hit is not None:
            new_index, gather = _hit
        else:
            nbpd = self.nblk_per_dim
            bis = self.block_indices()  # [nblks, ndim]
            new_rows, new_cols = mapping.fold(bis, nbpd)
            rbs = grouped_block_sizes(list(self.block_sizes), list(mapping.map1))
            cbs = grouped_block_sizes(list(self.block_sizes), list(mapping.map2))
            new_index, order = build_index(
                new_rows.astype(np.int64), new_cols.astype(np.int64), rbs, cbs
            )
            gmap = refold_flat_map(
                self.block_sizes, self.mapping, mapping, bis,
                self.matrix.index.blk_offset, order, new_index.nelems,
            )
            # the map is kept DEVICE-resident (int32 where positions fit):
            # uploading an nelems-sized map every call costs more than the
            # gather itself
            gather = prepare_flat_gather(new_index, self.matrix.tile, self.matrix, gmap)
            _pc.put(_key, (new_index, gather), nbytes=gather.nbytes)
        data = apply_prepared_gather(self.matrix.data, gather)
        return Tensor(
            name=self.name,
            block_sizes=self.block_sizes,
            mapping=mapping,
            matrix=BCSRMatrix(
                name=self.name, index=new_index, data=data
            ),
        )


def refold_flat_map(block_sizes, old: NDMapping, new: NDMapping, bis: np.ndarray,
                    old_offsets: np.ndarray, order: np.ndarray,
                    nelems: int) -> np.ndarray:
    """The refold's flat element map (int64 [nelems]): per block of the new
    index (``order[nb]`` is its source block), the source block's elements
    transposed from the old storage order to the new one — the JAX
    package's per-block loop, as it is."""
    old_order = old.dim_order
    new_order = new.dim_order
    # axes to pass to transpose: position of each new-order dim in old order
    axes = tuple(old_order.index(d) for d in new_order)
    gmap = np.empty(nelems, dtype=np.int64)
    pos = 0
    perm_cache: Dict[Tuple[int, ...], np.ndarray] = {}
    for nb in range(len(order)):
        ob = int(order[nb])  # source block id (build_index perm)
        bi = bis[ob]
        shp_old = tuple(int(block_sizes[d][bi[d]]) for d in old_order)
        if shp_old not in perm_cache:
            perm_cache[shp_old] = np.transpose(
                np.arange(int(np.prod(shp_old)), dtype=np.int64).reshape(shp_old),
                axes=axes,
            ).reshape(-1)
        n = perm_cache[shp_old].size
        gmap[pos:pos + n] = int(old_offsets[ob]) + perm_cache[shp_old]
        pos += n
    return gmap


class TensorBuilder:
    """Mutable tensor assembly (``dbcsr_t_put_block``/``reserve_blocks`` →
    immutable tensor). Blocks are supplied in natural dim order and staged
    on the host; ``finalize`` builds the folded matrix's tile store on
    ``device``."""

    def __init__(
        self,
        block_sizes: Sequence[np.ndarray],
        mapping: Optional[NDMapping] = None,
        *,
        device,
        name: str = "tensor",
        dtype=np.float32,
        tile: Optional[int] = None,
    ):
        self.block_sizes = tuple(
            np.asarray(b, dtype=np.int32) for b in block_sizes
        )
        ndim = len(self.block_sizes)
        if mapping is None:
            # default split: first half of dims -> rows (reference default
            # pgrid mapping)
            h = max(1, ndim // 2)
            mapping = NDMapping(ndim, tuple(range(h)), tuple(range(h, ndim)))
        self.mapping = mapping
        self.name = name
        self.dtype = torch_dtype(dtype)
        self.device = device
        self.tile = tile
        self._host_dtype = _host_dtype(self.dtype)
        self._blocks: Dict[Tuple[int, ...], np.ndarray] = {}

    def _shape(self, bi: Tuple[int, ...]) -> Tuple[int, ...]:
        return tuple(int(self.block_sizes[d][bi[d]]) for d in range(len(bi)))

    def put_block(self, bi: Sequence[int], block, *, sum: bool = False) -> None:
        bi = tuple(int(x) for x in bi)
        blk = np.asarray(block, dtype=self._host_dtype).reshape(self._shape(bi))
        if sum and bi in self._blocks:
            self._blocks[bi] = self._blocks[bi] + blk
        else:
            self._blocks[bi] = blk

    def reserve_block(self, bi: Sequence[int]) -> None:
        bi = tuple(int(x) for x in bi)
        if bi not in self._blocks:
            self._blocks[bi] = np.zeros(self._shape(bi), dtype=self._host_dtype)

    def finalize(self) -> Tensor:
        order = self.mapping.dim_order
        nbpd = tuple(len(b) for b in self.block_sizes)
        keys = list(self._blocks.keys())
        rbs = grouped_block_sizes(list(self.block_sizes), list(self.mapping.map1))
        cbs = grouped_block_sizes(list(self.block_sizes), list(self.mapping.map2))
        if keys:
            bis = np.asarray(keys, dtype=np.int64)
            rows, cols = self.mapping.fold(bis, nbpd)
            blocks = [
                np.ascontiguousarray(np.transpose(self._blocks[k], axes=order)).reshape(
                    rbs[int(r)], cbs[int(c)]
                )
                for k, r, c in zip(keys, rows, cols)
            ]
        else:
            rows = cols = np.zeros(0, dtype=np.int64)
            blocks = []
        mat = BCSRMatrix.from_blocks(
            rows, cols, blocks, rbs, cbs, name=self.name, dtype=self.dtype,
            device=self.device, tile=self.tile,
        )
        return Tensor(
            name=self.name,
            block_sizes=self.block_sizes,
            mapping=self.mapping,
            matrix=mat,
        )


def split_blocks(t: Tensor, new_block_sizes: Sequence[np.ndarray]) -> Tensor:
    """Refine the block grid (``dbcsr_t_split_blocks``): each dim's new
    block-size vector must partition the old blocks (every old block is a
    consecutive run of new blocks). Used to make tensors block-compatible
    before contraction (``dbcsr_tensor_split.F``)."""
    new_bs = [np.asarray(b, dtype=np.int32) for b in new_block_sizes]
    dbcsr_assert(len(new_bs) == t.ndim, "dimension count mismatch")
    # per dim: map old block -> (first new block, count)
    first = []
    counts = []
    for d in range(t.ndim):
        old_off = np.concatenate([[0], np.cumsum(t.block_sizes[d])])
        new_off = np.concatenate([[0], np.cumsum(new_bs[d])])
        dbcsr_assert(old_off[-1] == new_off[-1], f"dim {d} total size differs")
        pos = np.searchsorted(new_off, old_off)
        dbcsr_assert(
            np.array_equal(new_off[pos], old_off),
            f"dim {d}: new blocks do not refine the old ones",
        )
        first.append(pos[:-1])
        counts.append(np.diff(pos))
    builder = TensorBuilder(
        new_bs, t.mapping, name=t.name, dtype=t.dtype, device=t.device,
        tile=t.matrix.tile,
    )
    for bi, blk in t.iter_blocks():
        # split this block along every dim
        def rec(d, sub, idx):
            if d == t.ndim:
                builder.put_block(idx, sub)
                return
            start = 0
            for j in range(int(counts[d][bi[d]])):
                nb = int(first[d][bi[d]]) + j
                size = int(new_bs[d][nb])
                rec(
                    d + 1,
                    np.take(sub, range(start, start + size), axis=d),
                    idx + (nb,),
                )
                start += size

        rec(0, blk, ())
    return builder.finalize()


def tensor_from_matrix(m: BCSRMatrix, *, name: Optional[str] = None) -> Tensor:
    """Rank-2 tensor view of a matrix (``dbcsr_t_copy_matrix_to_tensor``)."""
    return Tensor(
        name=name or m.name,
        block_sizes=(m.index.row_block_sizes, m.index.col_block_sizes),
        mapping=NDMapping(2, (0,), (1,)),
        matrix=m,
    )


def matrix_from_tensor(t: Tensor) -> BCSRMatrix:
    """Rank-2 tensor → matrix (``dbcsr_t_copy_tensor_to_matrix``)."""
    dbcsr_assert(t.ndim == 2, "matrix view requires a rank-2 tensor")
    t2 = t.with_layout(NDMapping(2, (0,), (1,)))
    return t2.matrix
