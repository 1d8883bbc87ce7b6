"""Liquid water as CP2K's linear-scaling benchmarks build it: cells of
``cell_molecules`` molecules at liquid density, replicated ``replicas``
times along each axis, one block per atom (``basis``: O 13 and H 5 rows,
DZVP-MOLOPT-SR-GTH), atoms in the order of the cells and, within one, of
the molecules (O, H, H).

Block (I, J) is stored where atoms I and J lie within ``cutoff`` Å of
each other (minimum image in the periodic box), and every element of it is
scaled by exp(-decay·r_IJ): the decay of an insulator's density matrix
with distance. The cutoff is where that scale reaches the configuration's
``eps``, ln(1/eps)/decay: the blocks a filter at eps would keep.

The base cell comes from ``pattern_seed``: oxygens placed at random at
least ``min_oo_angstrom`` apart (periodic), each molecule's hydrogens at
``oh_angstrom`` and ``hoh_degrees`` in a random orientation. A system's
geometry stays fixed through an SCF run; the data comes from the run's
seed.
"""
from __future__ import annotations

import math

import numpy as np
from scipy.spatial import cKDTree

from benchmark.operands import Pattern
from benchmark.reference.layout import Blocks


def _base_cell(cfg: dict, rng: np.random.Generator) -> np.ndarray:
    """[3·n, 3] positions (Å) of one cell's atoms, O H H a molecule."""
    edge = float(cfg["cell_angstrom"])
    n = int(cfg["cell_molecules"])
    dmin = float(cfg["min_oo_angstrom"])
    oxy = np.zeros((0, 3))
    while len(oxy) < n:
        p = rng.random(3) * edge
        d = oxy - p
        d -= edge * np.round(d / edge)
        if not len(oxy) or float(np.min(np.sum(d * d, axis=1))) >= dmin * dmin:
            oxy = np.vstack([oxy, p])
    r, ang = float(cfg["oh_angstrom"]), math.radians(float(cfg["hoh_degrees"]))
    local = np.array([[r, 0.0, 0.0], [r * math.cos(ang), r * math.sin(ang), 0.0]])
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    rot = np.stack([
        np.stack([w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), w * w - x * x + y * y - z * z, 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), w * w - x * x - y * y + z * z], -1),
    ], 1)  # [n, 3, 3]
    hyd = oxy[:, None, :] + np.einsum("nij,hj->nhi", rot, local)
    return np.concatenate([oxy[:, None, :], hyd], axis=1).reshape(-1, 3)


def geometry(cfg: dict):
    """(positions [atoms, 3], box edges [3], is_oxygen [atoms])."""
    rng = np.random.default_rng(int(cfg["pattern_seed"]))
    base = _base_cell(cfg, rng)
    edge = float(cfg["cell_angstrom"])
    reps = [int(r) for r in cfg["replicas"]]
    cells = np.stack(np.meshgrid(*[np.arange(r) for r in reps], indexing="ij"), -1).reshape(-1, 3)
    pos = (cells[:, None, :] * edge + base[None]).reshape(-1, 3)
    box = np.array(reps, dtype=np.float64) * edge
    oxygen = np.tile(np.array([True, False, False]), len(pos) // 3)
    return np.mod(pos, box), box, oxygen


def cutoff(cfg: dict) -> float:
    return math.log(1.0 / float(cfg["eps"])) / float(cfg["decay_per_angstrom"])


def make(cfg: dict) -> Pattern:
    pos, box, oxygen = geometry(cfg)
    rc = cutoff(cfg)
    if rc >= 0.5 * float(box.min()):
        raise ValueError(f"cutoff {rc:.2f} Å is not under half the box {box.min():.2f} Å")
    pairs = cKDTree(pos, boxsize=box).query_pairs(rc, output_type="ndarray").astype(np.int64)
    na = len(pos)
    diag = np.arange(na, dtype=np.int64)
    rows = np.concatenate([pairs[:, 0], pairs[:, 1], diag])
    cols = np.concatenate([pairs[:, 1], pairs[:, 0], diag])
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    d = pos[rows] - pos[cols]
    d -= box * np.round(d / box)
    r = np.sqrt(np.sum(d * d, axis=1))
    basis = cfg["basis"]
    sizes = np.where(oxygen, int(basis["O"]), int(basis["H"])).astype(np.int64)
    blocks = Blocks(rows=rows, cols=cols, row_sizes=sizes, col_sizes=sizes)
    return Pattern(blocks=blocks, scale=np.exp(-float(cfg["decay_per_angstrom"]) * r))
