"""nd process grids for tensors.

Port of ``dbcsr_tpu/tensors/pgrid.py`` on the port's ``ProcessGrid`` of
virtual ranks. Analog of ``dbcsr_t_pgrid_type`` / ``dbcsr_t_nd_mp_comm``
(``src/tensors/dbcsr_tensor_types.F:105-125``): an nd cartesian factorization
of the device mesh, with tensor dims assigned to grid dims. The folded 2-D
representation contracts over a 2-D sub-mesh, so an nd pgrid here is a
(map1, map2)-consistent factorization of a :class:`~dbcsr_tpu_torch.dist.grid.ProcessGrid`:
the row group's dims multiply to nprow and the col group's to
npcol. In a distributed run the grid's ranks are dealt over the processes
(``ProcessGrid.make``), and a contraction over it spans them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.errors import dbcsr_assert
from ..dist.grid import ProcessGrid
from .index import NDMapping

__all__ = ["TensorPGrid", "default_pgrid_dims"]


def default_pgrid_dims(ndevices: int, ndim: int) -> Tuple[int, ...]:
    """Balanced nd factorization of the device count
    (``dbcsr_t_pgrid_create``'s default, via MPI_Dims_create in the
    reference)."""
    dims = [1] * ndim
    n = ndevices
    f = 2
    factors = []
    while f * f <= n:
        while n % f == 0:
            factors.append(f)
            n //= f
        f += 1
    if n > 1:
        factors.append(n)
    for fac in sorted(factors, reverse=True):
        dims[int(np.argmin(dims))] *= fac
    return tuple(sorted(dims, reverse=True))


@dataclass(frozen=True)
class TensorPGrid:
    """nd process grid: per-dim extents + the fold mapping that turns it
    into the 2-D mesh the folded contraction runs on."""

    dims: Tuple[int, ...]
    mapping: NDMapping
    grid: ProcessGrid

    def __post_init__(self):
        nprow = int(np.prod([self.dims[d] for d in self.mapping.map1]))
        npcol = int(np.prod([self.dims[d] for d in self.mapping.map2]))
        dbcsr_assert(
            nprow == self.grid.nprow and npcol == self.grid.npcol,
            "pgrid dims inconsistent with the folded 2-D mesh",
        )

    @property
    def ndim(self) -> int:
        return len(self.dims)

    @staticmethod
    def make(
        ndim: int,
        *,
        dims: Optional[Sequence[int]] = None,
        mapping: Optional[NDMapping] = None,
        devices=None,
    ) -> "TensorPGrid":
        """Create an nd pgrid over ``devices`` (default: the visible CUDA
        devices, raising without one; in a distributed run one rank a
        process) (``dbcsr_t_pgrid_create`` analog)."""
        from ..dist import comm
        from ..dist.grid import rank_devices

        devs = (list(devices) if devices is not None
                else rank_devices(comm.world_size() if comm.is_up()
                                  else max(torch.cuda.device_count(), 1)))
        if dims is None:
            dims = default_pgrid_dims(len(devs), ndim)
        dims = tuple(int(d) for d in dims)
        if mapping is None:
            h = max(1, ndim // 2)
            mapping = NDMapping(ndim, tuple(range(h)), tuple(range(h, ndim)))
        nprow = int(np.prod([dims[d] for d in mapping.map1]))
        npcol = int(np.prod([dims[d] for d in mapping.map2]))
        grid = ProcessGrid.make(nprow, npcol, devices=devs[: nprow * npcol])
        return TensorPGrid(dims=dims, mapping=mapping, grid=grid)
