"""Plain reference of one RI-HFX exchange build (CP2K's ``hfx_ri.F``,
``RI_FLAVOR RHO``): the 3-center tensor B, its data, and the step

    X(μ,σ,P) = Σ_λ B(μ,λ,P)·D(λ,σ),   X's blocks of norm < eps dropped
    K(μ,ν)   = Σ_{σ,P} X(μ,σ,P)·B(ν,σ,P),   K's blocks of norm < eps dropped

computed in batches of RI atoms P, one atom at a time, in dense float64
with TF32 off. Plain PyTorch, numpy and scipy: nothing of the program
under test. Departures from the published method, each a choice of this
benchmark:

* B is the fitted 3-center tensor C(μλ|P) = Σ_Q (μλ|Q)(Q|P)^-1/2 with the
  2-center matrix folded in once (CP2K's RHO flavor applies it in each
  step; the geometry is fixed through an SCF run, so a step computes the
  same from D). Its data are N(0, 1) times a scale, symmetric in the AO
  pair: B(μ,λ,P) = B(λ,μ,P) with the two AO axes swapped.
* Block (μ,λ,P) is stored where atoms μ and λ lie within ``pair_angstrom``
  of each other and P within ``ri_angstrom`` of the pair's midpoint
  (minimum image), scaled by exp(-a·r_μλ - b·r_P), where ``a`` and ``b``
  bring the scale to ``filter_eps`` at each range.
* D is the benchmark's A store over the density pattern, made by the
  harness from the run's seed (not symmetric).
* Norms are taken in float64 here; the program takes them in single
  precision, as DBCSR does, so a block whose norm² lies within
  ``norm_tie_rel`` of eps² may go either way. An X block that ties is kept
  here, and what it adds to K is bounded apart (``Step.tie``).

Two copies of this file are kept equal byte for byte:
``tools/torch/ri_hfx_reference.py`` and ``benchmark/reference/ri_hfx.py``
(the benchmark's own).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch
from scipy.spatial import cKDTree


@dataclass
class RIPattern:
    """B's blocks (μ, λ, P) in the order of its fold ((μ, P) | λ): by μ,
    then P, then λ."""

    ao: np.ndarray  # int64 AO block size of each atom
    ri: np.ndarray  # int64 RI block size of each atom
    mu: np.ndarray
    lam: np.ndarray
    p: np.ndarray
    scale: np.ndarray  # float64, one a block

    @property
    def n(self) -> int:
        return len(self.mu)

    @property
    def atoms(self) -> int:
        return len(self.ao)

    def classes(self) -> Dict[Tuple[int, int, int], np.ndarray]:
        """Block ids by natural shape (m, n, p), each list ascending."""
        shape = (self.ao[self.mu] << 40) | (self.ao[self.lam] << 20) | self.ri[self.p]
        out = {}
        for s in np.unique(shape):
            out[(int(s >> 40), int((s >> 20) & 0xFFFFF), int(s & 0xFFFFF))] = \
                np.flatnonzero(shape == s)
        return out


def offsets(sizes: np.ndarray) -> np.ndarray:
    return np.concatenate(([0], np.cumsum(np.asarray(sizes, dtype=np.int64))))


def decays(cfg: dict) -> Tuple[float, float]:
    """Per-Å decay of B's scale with the pair's distance and with P's
    distance from the pair's midpoint: each reaches ``filter_eps`` at its
    range."""
    lf = math.log(1.0 / float(cfg["filter_eps"]))
    return lf / float(cfg["pair_angstrom"]), lf / float(cfg["ri_angstrom"])


def pattern(cfg: dict, pos: np.ndarray, box: np.ndarray, oxygen: np.ndarray) -> RIPattern:
    na = len(pos)
    for key in ("pair_angstrom", "ri_angstrom"):
        if float(cfg[key]) >= 0.5 * float(box.min()):
            raise ValueError(f"{key} is not under half the box {box.min():.3f} Å")
    tree = cKDTree(pos, boxsize=box)
    pairs = tree.query_pairs(float(cfg["pair_angstrom"]), output_type="ndarray").astype(np.int64)
    diag = np.arange(na, dtype=np.int64)
    mu = np.concatenate([pairs[:, 0], pairs[:, 1], diag])
    lam = np.concatenate([pairs[:, 1], pairs[:, 0], diag])
    d = pos[lam] - pos[mu]
    d -= box * np.round(d / box)
    r_pair = np.sqrt(np.sum(d * d, axis=1))
    mid = np.mod(pos[mu] + 0.5 * d, box)
    near = tree.query_ball_point(mid, float(cfg["ri_angstrom"]))
    cnt = np.array([len(x) for x in near], dtype=np.int64)
    pair_of = np.repeat(np.arange(len(mu)), cnt)
    p = np.concatenate([np.asarray(x, dtype=np.int64) for x in near]) if len(near) else diag[:0]
    dp = pos[p] - mid[pair_of]
    dp -= box * np.round(dp / box)
    r_p = np.sqrt(np.sum(dp * dp, axis=1))
    a, b = decays(cfg)
    mu, lam = mu[pair_of], lam[pair_of]
    scale = np.exp(-a * r_pair[pair_of] - b * r_p)
    order = np.lexsort((lam, p, mu))
    ao = np.where(oxygen, int(cfg["basis"]["O"]), int(cfg["basis"]["H"])).astype(np.int64)
    ri = np.where(oxygen, int(cfg["ri_basis"]["O"]), int(cfg["ri_basis"]["H"])).astype(np.int64)
    return RIPattern(ao=ao, ri=ri, mu=mu[order], lam=lam[order], p=p[order],
                     scale=scale[order])


def batches(pat: RIPattern, n_batches: int) -> List[Tuple[int, int]]:
    """``n_batches`` contiguous ranges of RI atoms [a0, a1), as equal in
    atoms as they go."""
    cuts = np.linspace(0, pat.atoms, int(n_batches) + 1).round().astype(np.int64)
    return [(int(x), int(y)) for x, y in zip(cuts[:-1], cuts[1:])]


def seed_word(store: torch.Tensor) -> int:
    """The first 64-bit word of a store, as a seed."""
    return int(store.reshape(-1)[:1].contiguous().view(torch.int64).item())


def values(pat: RIPattern, seed: int, device, dtype=torch.float64
           ) -> Dict[Tuple[int, int, int], torch.Tensor]:
    """B's data by class: ``[n_blocks, m, n, p]`` in natural order (μ, λ, P)
    for the class's blocks, N(0, 1) times each block's scale, drawn from one
    ``torch.Generator`` seeded with ``seed``: a block with μ < λ and each
    block with μ = λ (made symmetric) draws; a block with μ > λ is its
    partner's with the two AO axes swapped."""
    na = pat.atoms
    key = (pat.mu * na + pat.lam) * na + pat.p
    order = np.argsort(key)
    partner = order[np.searchsorted(key[order], (pat.lam * na + pat.mu) * na + pat.p)]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    classes = pat.classes()
    out = {}
    for shape, ids in classes.items():
        m, n, p = shape
        own = ids[pat.mu[ids] <= pat.lam[ids]]
        v = torch.randn((len(own), m, n, p), generator=gen, device=device, dtype=torch.float64)
        diag = torch.as_tensor(pat.mu[own] == pat.lam[own], device=device)
        if bool(diag.any()):
            v[diag] = (v[diag] + v[diag].transpose(1, 2)) / math.sqrt(2.0)
        v *= torch.as_tensor(pat.scale[own], device=device)[:, None, None, None]
        out[shape] = torch.empty((len(ids), m, n, p), dtype=torch.float64, device=device)
        out[shape][torch.as_tensor(np.searchsorted(ids, own), device=device)] = v
    for shape, ids in classes.items():
        m, n, p = shape
        other = ids[pat.mu[ids] > pat.lam[ids]]
        if len(other):
            src = (n, m, p)
            rows = np.searchsorted(classes[src], partner[other])
            out[shape][torch.as_tensor(np.searchsorted(ids, other), device=device)] = \
                out[src][torch.as_tensor(rows, device=device)].transpose(1, 2)
    return {k: v.to(dtype) for k, v in out.items()}


def fold_blocks(pat: RIPattern):
    """B's 2-D fold ((μ, P) | λ): (rows, cols, row sizes, col sizes), rows
    ``μ·atoms + P`` of size m·p, columns λ; block b keeps its order."""
    na = pat.atoms
    return (pat.mu * na + pat.p, pat.lam.copy(), np.multiply.outer(pat.ao, pat.ri).reshape(-1),
            pat.ao.copy())


def ieee():
    """TF32 off for the matmuls under it."""
    class _Ctx:
        def __enter__(self):
            self.prev = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False

        def __exit__(self, *exc):
            torch.backends.cuda.matmul.allow_tf32 = self.prev
            return False

    return _Ctx()


def block_sums(x: torch.Tensor, row_owner: torch.Tensor, col_owner: torch.Tensor,
               nrb: int, ncb: int) -> torch.Tensor:
    """``[nrb, ncb]`` sums of the dense 2-D ``x`` over the blocks that own
    its rows and columns."""
    per_col = torch.zeros((x.shape[0], ncb), dtype=x.dtype, device=x.device)
    per_col.index_add_(1, col_owner, x)
    out = torch.zeros((nrb, ncb), dtype=x.dtype, device=x.device)
    out.index_add_(0, row_owner, per_col)
    return out


@dataclass
class Step:
    """One step's reference, over the AO blocks (μ, ν) of K."""

    k: torch.Tensor  # [n_ao, n_ao] dense K, X's ties kept, before K's filter
    bound: torch.Tensor  # [atoms, atoms] Σ |X_kept(μ,σ,P)|·|B(ν,σ,P)|
    tie: torch.Tensor  # [atoms, atoms] Σ over X's tie blocks of |X|·|B|
    x_kept: int  # X blocks kept (ties kept)
    x_ties: int
    x_nonzero: int  # X blocks of nonzero norm


def step(pat: RIPattern, vals: Dict[Tuple[int, int, int], torch.Tensor], d: torch.Tensor,
         eps: float, tie_rel: float, dtype=torch.float64, ranges=None) -> Step:
    """The exchange step on the dense ``[n_ao, n_ao]`` D in ``dtype``, one
    RI atom P at a time, over the batches ``ranges`` (all atoms in one
    batch by default; a batch only orders the sums)."""
    dev = d.device
    ao_off = offsets(pat.ao)
    nao = int(ao_off[-1])
    owner = torch.as_tensor(np.repeat(np.arange(pat.atoms), pat.ao), device=dev)
    d = d.to(dtype)
    k = torch.zeros((nao, nao), dtype=dtype, device=dev)
    bound = torch.zeros((pat.atoms, pat.atoms), dtype=torch.float64, device=dev)
    tie = torch.zeros_like(bound)
    thr = float(eps) ** 2
    kept = ties = nonzero = 0
    by_atom: Dict[int, List[Tuple[Tuple[int, int, int], np.ndarray]]] = {}
    for shape, ids in pat.classes().items():
        for a in np.unique(pat.p[ids]):
            by_atom.setdefault(int(a), []).append((shape, np.flatnonzero(pat.p[ids] == a)))
    ids_of = pat.classes()
    ranges = ranges or [(0, pat.atoms)]
    with ieee():
        for a0, a1 in ranges:
            for a in range(a0, a1):
                p = int(pat.ri[a])
                bp = torch.zeros((nao, nao, p), dtype=dtype, device=dev)
                for shape, rows in by_atom.get(a, []):
                    m, n, _ = shape
                    ids = ids_of[shape][rows]
                    r = torch.as_tensor(ao_off[pat.mu[ids]], device=dev)[:, None] \
                        + torch.arange(m, device=dev)
                    c = torch.as_tensor(ao_off[pat.lam[ids]], device=dev)[:, None] \
                        + torch.arange(n, device=dev)
                    bp[r[:, :, None], c[:, None, :]] = vals[shape][torch.as_tensor(
                        rows, device=dev)].to(dtype)
                # X(μ, k, σ) = Σ_λ B(μ, λ, k)·D(λ, σ)
                x = (bp.permute(0, 2, 1).reshape(nao * p, nao) @ d).view(nao, p, nao)
                nsq = block_sums(x.square().sum(dim=1).to(torch.float64), owner, owner,
                                 pat.atoms, pat.atoms)
                keep = nsq >= thr
                near = (nsq - thr).abs() <= tie_rel * thr
                kept += int(keep.sum())
                ties += int(near.sum())
                nonzero += int((nsq > 0).sum())
                x *= keep[owner][:, owner].to(dtype)[:, None, :]
                # K(μ, ν) += Σ_{k, σ} X(μ, k, σ)·B(ν, σ, k)
                bv = bp.permute(0, 2, 1).reshape(nao, p * nao)
                k += x.reshape(nao, p * nao) @ bv.T
                nb = block_sums(bp.square().sum(dim=2).to(torch.float64), owner, owner,
                                pat.atoms, pat.atoms).sqrt()
                nx = nsq.sqrt()
                bound += (nx * keep) @ nb.T
                tie += (nx * near) @ nb.T
                del bp, x, bv
    return Step(k=k, bound=bound, tie=tie, x_kept=kept, x_ties=ties, x_nonzero=nonzero)


def k_err(ref: Step, pat: RIPattern, k_prog: torch.Tensor, listed: torch.Tensor,
          eps: float, tie_rel: float) -> float:
    """``block_err`` of a program's dense K (``[n_ao, n_ao]``, zero off the
    blocks it lists; ``listed`` ``[atoms, atoms]`` bool) against the
    reference: max over K's blocks of

        e_b = max(0, |P_b - R_b·keep_b|_F - tie_b) / W_b

    with W_b = Σ |X_kept|·|B| over the block's terms and tie_b what X's
    tie blocks add at most. keep_b is |R_b|_F² >= eps²; a K block within
    ``tie_rel`` of eps² may go either way, and reads the smaller. A block
    with W_b = 0 reads 0 where P_b is zero and inf where it is not, as does
    a value that is not finite."""
    if not bool(torch.isfinite(k_prog).all()):
        return math.inf
    dev = ref.k.device
    owner = torch.as_tensor(np.repeat(np.arange(pat.atoms), pat.ao), device=dev)
    p = torch.where(listed[owner][:, owner], k_prog.to(torch.float64),
                    torch.zeros((), dtype=torch.float64, device=dev))
    r = ref.k.to(torch.float64)
    na = pat.atoms
    sr = block_sums(r.square(), owner, owner, na, na)
    sp = block_sums(p.square(), owner, owner, na, na)
    sd = block_sums((p - r).square(), owner, owner, na, na)
    thr = float(eps) ** 2
    diff = torch.where(sr >= thr, sd, sp)
    diff = torch.where((sr - thr).abs() <= tie_rel * thr, torch.minimum(sd, sp), diff)
    excess = (diff.sqrt() - ref.tie).clamp(min=0.0)
    w = ref.bound
    if bool(((w == 0) & (sp > 0)).any()):
        return math.inf
    on = w > 0
    if not bool(on.any()):
        return 0.0
    return float((excess[on] / w[on]).max())


def dense_k_mask(k: torch.Tensor, pat: RIPattern, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K with its blocks of norm² < eps² zeroed, and the kept-block mask
    ``[atoms, atoms]`` (the filter in ``k``'s own precision)."""
    owner = torch.as_tensor(np.repeat(np.arange(pat.atoms), pat.ao), device=k.device)
    nsq = block_sums(k.square(), owner, owner, pat.atoms, pat.atoms)
    keep = nsq >= torch.tensor(float(eps), dtype=k.dtype) ** 2
    return k * keep[owner][:, owner].to(k.dtype), keep
