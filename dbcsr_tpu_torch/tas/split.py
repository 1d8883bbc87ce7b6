"""Split management for tall-and-skinny matrices.

Copy of ``dbcsr_tpu/tas/split.py`` (numpy only). Analog of
``dbcsr_tas_split_info`` + the split constructors
(``src/tas/dbcsr_tas_split.F:44-371``): the long dimension's block range is
partitioned into ``nsplit`` groups. The reference splits the MPI cartesian
grid into row/column subgroups and assigns long-dimension blocks to them
cyclically; here the split is pure metadata — a block→group map — and the
executor decides whether groups run as a host loop (local) or as mesh
submeshes (distributed).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.errors import dbcsr_assert

__all__ = ["TASSplit", "ROWSPLIT", "COLSPLIT"]

ROWSPLIT = "R"  # the ROW dimension is the long/split one
COLSPLIT = "C"


@dataclass(frozen=True)
class TASSplit:
    """Partition of one block dimension into ``nsplit`` groups.

    ``rowcol`` — which dimension is split (``'R'``/``'C'``, the reference's
    ``rowsplit``/``colsplit`` constants, ``src/tas/dbcsr_tas_split.F:60``);
    ``group_of_block[i]`` — group owning block ``i`` of the split dimension.
    """

    rowcol: str
    nsplit: int
    group_of_block: np.ndarray  # int32 [nblk_long] -> group
    _cache: dict = field(default_factory=dict, compare=False, repr=False)

    def __post_init__(self):
        dbcsr_assert(self.rowcol in (ROWSPLIT, COLSPLIT), "bad split dim")
        dbcsr_assert(self.nsplit >= 1, "nsplit must be >= 1")
        if len(self.group_of_block):
            dbcsr_assert(
                int(self.group_of_block.max()) < self.nsplit,
                "group map exceeds nsplit",
            )

    @property
    def nblk_long(self) -> int:
        return len(self.group_of_block)

    def blocks_of_group(self, g: int) -> np.ndarray:
        """Global block ids of group ``g``, ascending (the group's local
        block order, like the reference's subgroup-local matrices)."""
        key = ("blocks", g)
        if key not in self._cache:
            self._cache[key] = np.flatnonzero(
                self.group_of_block == g
            ).astype(np.int32)
        return self._cache[key]

    def local_of_global(self) -> np.ndarray:
        """Position of each global block inside its group (-1 never occurs:
        every block belongs to exactly one group)."""
        key = "local_of_global"
        if key not in self._cache:
            out = np.empty(self.nblk_long, dtype=np.int64)
            for g in range(self.nsplit):
                blocks = self.blocks_of_group(g)
                out[blocks] = np.arange(len(blocks))
            self._cache[key] = out
        return self._cache[key]

    @staticmethod
    def cyclic(rowcol: str, nblk_long: int, nsplit: int) -> "TASSplit":
        """Round-robin assignment (the reference's default cyclic
        distribution over subgroups, ``dbcsr_tas_dist_cyclic``,
        ``src/tas/dbcsr_tas_global.F``)."""
        return TASSplit(
            rowcol=rowcol,
            nsplit=nsplit,
            group_of_block=(np.arange(nblk_long) % nsplit).astype(np.int32),
        )

    @staticmethod
    def contiguous(rowcol: str, nblk_long: int, nsplit: int) -> "TASSplit":
        """Contiguous chunks — better tile locality when block rows carry
        spatial meaning."""
        bounds = np.linspace(0, nblk_long, nsplit + 1).astype(np.int64)
        g = np.zeros(nblk_long, dtype=np.int32)
        for i in range(nsplit):
            g[bounds[i]:bounds[i + 1]] = i
        return TASSplit(rowcol=rowcol, nsplit=nsplit, group_of_block=g)

    @staticmethod
    def trivial(rowcol: str, nblk_long: int) -> "TASSplit":
        return TASSplit.cyclic(rowcol, nblk_long, 1)
