"""Process grid: a 2-D (or 2.5-D) grid of virtual ranks over torch devices.

Port of ``dbcsr_tpu/dist/grid.py`` (reference ``dbcsr_mp_type``,
``src/core/dbcsr_types.F:108-139``). The JAX package's grid IS a
``jax.sharding.Mesh`` with axes ('pr', 'pc'[, 'layer']) and runs each
distributed product as one ``shard_map`` program over it. Here the grid is
an ``[nprow, npcol(, nlayer)]`` array of ``torch.device``, one rank per
cell, and an array of the same shape of OWNER processes. Ranks may share a
device (four ``cuda:0`` ranks on one card, eight ``cpu`` ranks in the
tests). Without a distributed run every cell's owner is process 0 and one
process drives every rank: a ring shift between ranks on one device hands
over the tensor, between two devices it is a peer copy. After
``init_lib(distributed=True)``, ``make`` deals the cells round-robin over
the world's processes (the JAX battery's ``_balanced_devices``), every
cell on its owner's device; each process then holds and computes its own
ranks' pieces and ``comm.py`` moves pieces between processes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.errors import DbcsrError, dbcsr_assert
from . import comm

__all__ = ["ProcessGrid", "AXIS_ROW", "AXIS_COL", "AXIS_LAYER", "rank_devices"]

AXIS_ROW = "pr"
AXIS_COL = "pc"
AXIS_LAYER = "layer"


def _norm_device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def rank_devices(n: int, devices: Optional[Sequence] = None) -> List[torch.device]:
    """``n`` rank devices: the first ``n`` of ``devices``, or the visible
    CUDA devices taken in turn. With no ``devices`` and no CUDA device it
    raises: a grid never drops to the CPU by itself. In a distributed run
    every rank of this process sits on the process's device (``devices``,
    if given, must name it)."""
    if comm.is_up():
        own = comm.device()
        if devices is not None:
            devs = [_norm_device(d) for d in devices]
            dbcsr_assert(n <= len(devs), f"{n} ranks need {n} devices, have {len(devs)}")
            dbcsr_assert(all(d == own for d in devs[:n]),
                         f"in a distributed run this process's ranks sit on its device "
                         f"{own}, not {sorted(set(map(str, devs[:n])))}")
        return [own] * n
    if devices is not None:
        devs = [_norm_device(d) for d in devices]
        dbcsr_assert(n <= len(devs), f"{n} ranks need {n} devices, have {len(devs)}")
        return devs[:n]
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise DbcsrError(
            "no CUDA device for the process grid: pass devices= (for example "
            "[torch.device('cpu')] * n) to run its ranks elsewhere"
        )
    k = torch.cuda.device_count()
    return [torch.device("cuda", r % k) for r in range(n)]


@dataclass(frozen=True, eq=False)
class ProcessGrid:
    """2-D grid of ranks, optionally with a third "layer" axis for the 2.5D
    C-reduction (the reference's ``num_layers_3D``, ``src/mm/dbcsr_mm_3d.F``).
    ``devices`` is an object array ``[nprow, npcol]`` or ``[nprow, npcol,
    nlayer]`` of ``torch.device``; ``owners`` an int array of the same shape
    (default all 0: one process drives every rank)."""

    devices: np.ndarray
    #: the world rank of the process that holds each cell
    owners: Optional[np.ndarray] = None

    def __post_init__(self):
        own = (np.zeros(self.devices.shape, dtype=np.int64) if self.owners is None
               else np.asarray(self.owners, dtype=np.int64).reshape(self.devices.shape))
        object.__setattr__(self, "owners", own)

    @property
    def nprow(self) -> int:
        return int(self.devices.shape[0])

    @property
    def npcol(self) -> int:
        return int(self.devices.shape[1])

    @property
    def nlayer(self) -> int:
        return int(self.devices.shape[2]) if self.devices.ndim == 3 else 1

    @property
    def size(self) -> int:
        return self.nprow * self.npcol * self.nlayer

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(int(s) for s in self.devices.shape)

    def device(self, i: int, j: int, l: int = 0) -> torch.device:
        """The device of rank (i, j, l)."""
        if self.devices.ndim == 3:
            return self.devices[i, j, l]
        dbcsr_assert(l == 0, "layer index on a 2-D grid")
        return self.devices[i, j]

    def ranks(self):
        """Every rank (i, j, l), in row-major (i, j, l) order."""
        return [(i, j, l) for i in range(self.nprow) for j in range(self.npcol)
                for l in range(self.nlayer)]

    def owner(self, i: int, j: int, l: int = 0) -> int:
        """The process that holds rank (i, j, l)."""
        return int(self.owners[i, j, l] if self.owners.ndim == 3 else self.owners[i, j])

    def owner_list(self) -> List[int]:
        """Every rank's process, in ``ranks()`` order."""
        return [int(o) for o in self.owners.flat]

    def is_local(self, i: int, j: int, l: int = 0) -> bool:
        """Whether this process holds rank (i, j, l)."""
        return self.owner(i, j, l) == comm.rank()

    def local_ranks(self):
        """The ranks this process holds, in ``ranks()`` order."""
        return [rk for rk in self.ranks() if self.is_local(*rk)]

    def unique_devices(self) -> List[torch.device]:
        out: List[torch.device] = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out

    def _key(self):
        return (self.shape, tuple(str(d) for d in self.devices.flat),
                tuple(self.owner_list()))

    def __eq__(self, other) -> bool:
        return isinstance(other, ProcessGrid) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"ProcessGrid({'x'.join(map(str, self.shape))}, {self.unique_devices()})"

    @staticmethod
    def make(nprow: int, npcol: int, nlayer: int = 1,
             devices: Optional[Sequence] = None,
             owners: Optional[Sequence[int]] = None) -> "ProcessGrid":
        """An ``nprow × npcol (× nlayer)`` grid over ``devices`` (its first
        ``nprow·npcol·nlayer`` entries, row-major), or over the visible CUDA
        devices taken in turn (a 2×2×2 grid on one card is eight ``cuda:0``
        ranks). Raises with no ``devices`` and no CUDA device. In a
        distributed run the cells are dealt round-robin over the processes
        (``owners``, row-major, overrides the deal: a TAS sub-grid continues
        its group's place in it)."""
        need = nprow * npcol * nlayer
        devs = rank_devices(need, devices)
        arr = np.empty(need, dtype=object)
        arr[:] = devs
        own = (np.arange(need, dtype=np.int64) % comm.world_size() if owners is None
               else np.asarray(owners, dtype=np.int64))
        dbcsr_assert(own.shape == (need,) and bool((own >= 0).all())
                     and bool((own < comm.world_size()).all()),
                     f"owners must be {need} ranks of the world")
        shape = (nprow, npcol, nlayer) if nlayer > 1 else (nprow, npcol)
        return ProcessGrid(arr.reshape(shape), own.reshape(shape))

    @staticmethod
    def square(devices: Optional[Sequence] = None) -> "ProcessGrid":
        """Largest square grid that fits ``devices`` (default: the visible
        CUDA devices)."""
        if devices is None:
            devices = rank_devices(comm.world_size() if comm.is_up()
                                   else max(torch.cuda.device_count(), 1))
        p = max(math.isqrt(len(devices)), 1)
        return ProcessGrid.make(p, p, devices=devices)

    def plane(self) -> "ProcessGrid":
        """The (row, col) plane of layer 0, as a 2-D grid."""
        if self.devices.ndim != 3:
            return self
        return ProcessGrid(self.devices[..., 0], self.owners[..., 0])

    def transposed(self) -> "ProcessGrid":
        return ProcessGrid(np.swapaxes(self.devices, 0, 1), np.swapaxes(self.owners, 0, 1))
