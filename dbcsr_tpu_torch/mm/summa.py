"""SUMMA distributed multiply over any 2-D (or 2.5-D) grid of virtual ranks.

Port of ``dbcsr_tpu/mm/summa.py``: rank (i, j) owns the C tiles of row-bin
i and col-bin j and consumes A's row panel i (k-sharded along 'pc') and
B's column panel j (k-sharded along 'pr'). SUMMA has no grid-shape
constraint, so it is the choice whenever nprow != npcol. The host plan
(``plan_summa``, ``pad_summa_plan``) is the JAX package's, copied
unchanged (numpy, tile-granular). ``cannon.plan_distributed``, the one
planner of ``multiply(dist=)`` and ``build_distributed_executor``, calls
``plan_summa``; the TAS sub-grids (``tas/parallel.py``) call it per group
and pad the plans to common capacities.

Execution (``cannon.RankPlan``, algorithm "summa"). The JAX package's
``lax.all_gather`` of A along 'pc' and of B along 'pr' is a concatenation
of the owners' pieces on the receiving rank's device (one per panel and
device: ranks that share a device share it; a piece of another process
arrives as one message, ``dist/comm.py``), and the local product is ONE
launch of the port's stack kernel for the dtype per rank, over the rank's
stack with the trash rows dropped. With ``nlayer > 1`` the k range is
pre-split over the layers and the layer partials are summed in layer order
(2.5D, ``src/mm/dbcsr_mm_3d.F:1038-1136``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

from .tileplan import enumerate_tile_triples

__all__ = ["SummaPlan", "plan_summa", "pad_summa_plan"]


@dataclass
class SummaPlan:
    p: int  # nprow
    q: int  # npcol
    n_a: int  # A panel capacity (tiles) per device
    n_b: int
    n_c: int
    s_max: int
    a_pack: np.ndarray  # int32 [P*Q*L*n_a] op-store slot (-1 pad)
    b_pack: np.ndarray
    stacks: np.ndarray  # int32 [P, Q(, L), s_max, 3] (c, a_local, b_local)
    c_unpack: np.ndarray  # int32 [c n_tiles] -> [P*Q*n_c] position
    layers: int = 1  # 2.5D C-reduction layers (L); legacy shapes when 1


def plan_summa(
    a_coords: np.ndarray,
    b_coords: np.ndarray,
    c_layout,
    rowb: np.ndarray,  # m tile-row -> prow
    colb: np.ndarray,  # n tile-col -> pcol
    kb_a: np.ndarray,  # k tile -> pcol bin (A's k sharding)
    kb_b: np.ndarray,  # k tile -> prow bin (B's k sharding)
    p: int,
    q: int,
    layers: int = 1,
) -> SummaPlan:
    """Tile-granular SUMMA schedule.

    A tile (tr, tc) lives on device (rowb[tr], kb_a[tc]); B tile (tr, tc)
    on (kb_b[tr], colb[tc]). After the all_gathers every device holds A's
    full row-panel and B's full col-panel, so the local stacks reference
    positions in the GATHERED panels: A slot = owner_col * n_a + local slot.
    (Plans sharing one shard_map pad to common capacities with
    :func:`pad_summa_plan`.)

    Fully vectorized single pass (no Python loop over tiles, panels or
    grid cells): panels, pack maps, per-device C sets and per-device
    stacks all come from one global triple enumeration + numpy grouping.

    With ``layers > 1`` each k tile additionally carries a 2.5D layer
    (round-robin within its (kq, kp) bin pair — the tile-granular
    ``make_layers_3D_C_reduction``, ``src/mm/dbcsr_mm_3d.F:1038``): panels
    and stacks grow a layer axis and per-layer C partials are psum'd over
    the layer mesh axis by the executor.
    """
    from .cannon import _tile_layer_split

    mt, ktl, ntc = int(len(rowb)), int(len(kb_a)), int(len(colb))
    L = int(layers)
    klay = _tile_layer_split(kb_a * p + kb_b, L)

    # --- owner panels: panel id + slot within panel per tile -------------
    def panelize(coords, rk, ck, ncpan):
        pid = (
            rk[coords[:, 0]].astype(np.int64) * ncpan
            + ck[coords[:, 1]].astype(np.int64)
        )
        order = np.argsort(pid, kind="stable")
        counts = np.bincount(pid, minlength=1)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.empty(len(pid), dtype=np.int64)
        slot[order] = np.arange(len(pid), dtype=np.int64) - starts[pid[order]]
        return pid, slot, counts

    # A panel key (i, kq, l); B panel key (kp, j, l)
    a_pid, a_slot, a_counts = panelize(
        a_coords, rowb, kb_a * L + klay, q * L
    )
    b_pid, b_slot, b_counts = panelize(
        b_coords, kb_b * L + klay, colb, q
    )
    n_a = max(int(a_counts.max()) if a_counts.size else 0, 1)
    n_b = max(int(b_counts.max()) if b_counts.size else 0, 1)

    # pack index layouts: A -> [i, kq, l, slot], B -> [kp, j, l, slot]
    a_i, a_kql = a_pid // (q * L), a_pid % (q * L)
    a_kq, a_l = a_kql // L, a_kql % L
    a_pack = np.full(p * q * L * n_a, -1, dtype=np.int64)
    a_pack[((a_i * q + a_kq) * L + a_l) * n_a + a_slot] = np.arange(
        len(a_coords), dtype=np.int64
    )
    b_kpl, b_j = b_pid // q, b_pid % q
    b_kp, b_l = b_kpl // L, b_kpl % L
    b_pack = np.full(p * q * L * n_b, -1, dtype=np.int64)
    b_pack[((b_kp * q + b_j) * L + b_l) * n_b + b_slot] = np.arange(
        len(b_coords), dtype=np.int64
    )

    # --- C ownership ------------------------------------------------------
    c_coords = c_layout.tile_coords
    c_dev = (
        rowb[c_coords[:, 0]].astype(np.int64) * q
        + colb[c_coords[:, 1]].astype(np.int64)
    )
    c_counts = np.bincount(c_dev, minlength=p * q)
    n_c = max(int(c_counts.max()) if len(c_coords) else 0, 1)
    c_starts = np.concatenate([[0], np.cumsum(c_counts)[:-1]])
    order_c = np.argsort(c_dev, kind="stable")
    pos = np.empty(len(c_dev), dtype=np.int64)
    pos[order_c] = np.arange(len(c_dev), dtype=np.int64) - c_starts[c_dev[order_c]]
    c_unpack = c_dev * n_c + pos
    c_keys = (
        c_coords[:, 0].astype(np.int64) * c_layout.ntc
        + c_coords[:, 1].astype(np.int64)
    )
    keyspace = int(c_layout.ntr) * int(c_layout.ntc) + 1
    c_devkey = c_dev[order_c] * keyspace + c_keys[order_c]

    # --- stacks over the gathered panels: one global enumeration ----------
    amat = sp.csr_matrix(
        (
            np.arange(1, len(a_coords) + 1, dtype=np.int64),
            (a_coords[:, 0].astype(np.int64), a_coords[:, 1].astype(np.int64)),
        ),
        shape=(mt, ktl),
    )
    bmat = sp.csr_matrix(
        (
            np.arange(1, len(b_coords) + 1, dtype=np.int64),
            (b_coords[:, 0].astype(np.int64), b_coords[:, 1].astype(np.int64)),
        ),
        shape=(ktl, ntc),
    )
    cr, cc, asl_g, bsl_g = enumerate_tile_triples(amat, bmat)

    def finish(stacks, s_max):
        if L == 1:  # legacy shapes (stacks [P, Q, s, 3])
            stacks = stacks.reshape(p, q, s_max, 3)
        return SummaPlan(
            p=p, q=q, n_a=n_a, n_b=n_b, n_c=n_c, s_max=s_max,
            a_pack=a_pack, b_pack=b_pack, stacks=stacks,
            c_unpack=c_unpack, layers=L,
        )

    if len(cr) == 0:
        stacks = np.zeros((p, q, L, 1, 3), dtype=np.int32)
        stacks[..., 0] = n_c
        return finish(stacks, 1)

    i_t = rowb[cr].astype(np.int64)
    j_t = colb[cc].astype(np.int64)
    l_t = klay[a_coords[asl_g, 1]]  # layer of the triple's k tile
    dev_t = i_t * q + j_t
    # gathered-panel slots: A slot = owner_col * n_a + local, B analogous
    a_gslot = a_kq[asl_g] * n_a + a_slot[asl_g]
    b_gslot = b_kp[bsl_g] * n_b + b_slot[bsl_g]
    dk = dev_t * keyspace + cr.astype(np.int64) * c_layout.ntc + cc
    ppos = np.searchsorted(c_devkey, dk)
    ok = (ppos < len(c_devkey)) & (
        c_devkey[np.minimum(ppos, max(len(c_devkey) - 1, 0))] == dk
    )
    cslot = np.where(ok, ppos - c_starts[dev_t], n_c)
    group = dev_t * L + l_t
    gcounts = np.bincount(group, minlength=p * q * L)
    s_max = max(int(gcounts.max()), 1)
    gstarts = np.concatenate([[0], np.cumsum(gcounts)[:-1]])
    order_t = np.lexsort((cslot, group))
    posg = np.arange(len(cr), dtype=np.int64) - gstarts[group[order_t]]
    flat = np.zeros((p * q * L * s_max, 3), dtype=np.int32)
    flat[:, 0] = n_c
    rowsel = group[order_t] * s_max + posg
    flat[rowsel, 0] = cslot[order_t]
    flat[rowsel, 1] = a_gslot[order_t]
    flat[rowsel, 2] = b_gslot[order_t]
    return finish(flat.reshape(p, q, L, s_max, 3), s_max)


def pad_summa_plan(
    plan: SummaPlan, n_a: int, n_b: int, n_c: int, s_max: int
) -> SummaPlan:
    """Re-pad a plan to larger capacities (so several group plans share one
    shard_map's static shapes). Gathered-panel slot ids are re-encoded for
    the new panel strides; padded stack rows are trash entries."""
    if (plan.n_a, plan.n_b, plan.n_c, plan.s_max) == (n_a, n_b, n_c, s_max):
        return plan
    assert plan.layers == 1, "pad_summa_plan: layered plans not padded (TAS)"
    p, q = plan.p, plan.q

    def repad_pack(flat: np.ndarray, old_n: int, new_n: int) -> np.ndarray:
        out = np.full((p, q, new_n), -1, dtype=flat.dtype)
        out[:, :, :old_n] = flat.reshape(p, q, old_n)
        return out.reshape(-1)

    st = plan.stacks
    new = np.zeros((p, q, s_max, 3), dtype=np.int32)
    new[..., 0] = n_c  # trash
    so = plan.s_max
    new[:, :, :so, 0] = np.where(st[..., 0] == plan.n_c, n_c, st[..., 0])
    new[:, :, :so, 1] = (st[..., 1] // plan.n_a) * n_a + st[..., 1] % plan.n_a
    new[:, :, :so, 2] = (st[..., 2] // plan.n_b) * n_b + st[..., 2] % plan.n_b
    c_unpack = (plan.c_unpack // plan.n_c) * n_c + plan.c_unpack % plan.n_c
    return SummaPlan(
        p=p, q=q, n_a=n_a, n_b=n_b, n_c=n_c, s_max=s_max,
        a_pack=repad_pack(plan.a_pack, plan.n_a, n_a),
        b_pack=repad_pack(plan.b_pack, plan.n_b, n_b),
        stacks=new, c_unpack=c_unpack,
    )
