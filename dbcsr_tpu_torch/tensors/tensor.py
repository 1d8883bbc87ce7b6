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
from ..block.refold import apply_refold, refold_plan
from ..core.timing import timed
from ..core.errors import dbcsr_assert
from .index import NDMapping, grouped_block_sizes

__all__ = [
    "Tensor", "TensorBuilder", "split_blocks", "tensor_from_matrix",
    "matrix_from_tensor", "refold_layout",
]


@dataclass(frozen=True)
class Tensor:
    name: str
    block_sizes: Tuple[np.ndarray, ...]  # per-dim int32 block-size vectors
    mapping: NDMapping
    matrix: BCSRMatrix  # folded 2-D representation
    # where each dim starts, in elements, in the index that contraction
    # bounds name: a window result of ``BatchedContract`` holds its window
    # alone (None: every dim starts at 0)
    offsets: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        dbcsr_assert(
            self.mapping.ndim == len(self.block_sizes), "mapping/dims mismatch"
        )
        dbcsr_assert(self.offsets is None or len(self.offsets) == len(self.block_sizes),
                     "offsets/dims mismatch")

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
    def starts(self) -> Tuple[int, ...]:
        """The element where each dim starts (``offsets``, 0 where None)."""
        return tuple(int(x) for x in self.offsets) if self.offsets else (0,) * self.ndim

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
        A host index rebuild and a block-granular plan
        (``block/refold.py``), kept in the plan cache under the index's
        content, the nd block sizes, both mappings and the device; a call
        is one device pass (span ``tensor/refold``), which moves each block
        whole and equals the JAX package's element map bit for bit."""
        if (mapping.map1, mapping.map2) == (self.mapping.map1, self.mapping.map2):
            return self
        new_index, plan = refold_layout(self, mapping)
        with timed("tensor/refold"):
            data = apply_refold(self.matrix.data.contiguous(), plan)
        return Tensor(
            name=self.name,
            block_sizes=self.block_sizes,
            mapping=mapping,
            matrix=BCSRMatrix(
                name=self.name, index=new_index, data=data
            ),
            offsets=self.offsets,
        )


def refold_layout(t: "Tensor", mapping: NDMapping):
    """(new index, ``RefoldPlan``) of refolding ``t`` to ``mapping``, from
    the plan cache (its host work is pure content: iterative contractions
    refold the same patterns every call)."""
    from ..mm.plancache import array_fingerprint, get_plan_cache, index_fingerprint

    pc = get_plan_cache()
    key = (
        "with_layout", index_fingerprint(t.matrix.index),
        array_fingerprint(*t.block_sizes), t.matrix.tile,
        t.mapping.map1, t.mapping.map2, mapping.map1, mapping.map2, str(t.device),
    )
    hit = pc.get(key)
    if hit is not None:
        return hit
    bis = t.block_indices()  # [nblks, ndim]
    new_rows, new_cols = mapping.fold(bis, t.nblk_per_dim)
    rbs = grouped_block_sizes(list(t.block_sizes), list(mapping.map1))
    cbs = grouped_block_sizes(list(t.block_sizes), list(mapping.map2))
    new_index, order = build_index(
        new_rows.astype(np.int64), new_cols.astype(np.int64), rbs, cbs
    )
    src = bis[order]
    sizes = np.stack([np.asarray(t.block_sizes[d], dtype=np.int64)[src[:, d]]
                      for d in range(t.ndim)], axis=1) if len(src) else \
        np.zeros((0, t.ndim), dtype=np.int64)
    plan = refold_plan(t.matrix.index, new_index, order, sizes, t.mapping.dim_order,
                       len(t.mapping.map1), mapping.dim_order, len(mapping.map1),
                       t.matrix.tile, t.device)
    pc.put(key, (new_index, plan), nbytes=plan.nbytes)
    return new_index, plan


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
