"""RI-HFX's exchange step through ``BatchedContract`` (bounds, filter_eps,
accumulation over batches of the contracted index) and the block-granular
refold, on the CPU:

* the port's step against the plain reference
  (``tools/torch/ri_hfx_reference.py``) on one 8-molecule cell of liquid
  water at the benchmark's density (6.207 Å), with the published AO and RI
  block widths and the ranges cut under half the cell; separate cases for
  an X filter with ties, and for X kept whole or dropped whole;
* ``BatchedContract``'s refusals (its parity with the one-shot contracts
  is ``tests/test_torch_batched_contract.py``);
* the refold, bit for bit against the JAX package's element map of
  ``with_layout`` (``torch_refold_map.py``), for every class of block sizes; and the store
  layout's block-granular tiles against its element map.
"""
import math
import os
import sys

import numpy as np
import pytest
import torch

import dbcsr_tpu_torch as dtt
import dbcsr_tpu_torch.tensors as tten
from dbcsr_tpu_torch.block.refold import refold_plain
from dbcsr_tpu_torch.core.config import config_override as torch_override
from dbcsr_tpu_torch.core.stats import get_stats, reset_stats
from dbcsr_tpu_torch.tensors import NDMapping, TensorBuilder
from dbcsr_tpu_torch.tensors.tensor import refold_layout

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (REPO, os.path.join(REPO, "tools", "torch")):
    if p not in sys.path:
        sys.path.insert(0, p)

import ri_hfx_reference as ri  # noqa: E402
from torch_refold_map import element_map_refold  # noqa: E402

from benchmark.patterns import water_box  # noqa: E402

torch.set_num_threads(1)

#: one cell of 8 molecules at the benchmark's density; the ranges cut to
#: fit under half of it, the widths the benchmark's
SMALL = {
    "cell_angstrom": 6.207, "cell_molecules": 8, "replicas": [1, 1, 1],
    "oh_angstrom": 0.9572, "hoh_degrees": 104.52, "min_oo_angstrom": 2.5,
    "basis": {"O": 13, "H": 5}, "ri_basis": {"O": 56, "H": 14},
    "decay_per_angstrom": 1.44, "eps": math.exp(-1.44 * 3.0), "pattern_seed": 0,
    "pair_angstrom": 3.0, "ri_angstrom": 1.5, "filter_eps": 1e-9,
}
TIE_REL = 1e-4
LIMIT = 1e-12
T = 16


def setup_step(seed=7, tile=T):
    """(pattern, B's values, B and its relabelled copy, D's tensor, D dense)
    of the small cell, B built block by block from the reference's values."""
    pos, box, oxygen = water_box.geometry(SMALL)
    pat = ri.pattern(SMALL, pos, box, oxygen)
    vals = ri.values(pat, seed, "cpu")
    ao, rib = pat.ao.astype(np.int32), pat.ri.astype(np.int32)
    tb = TensorBuilder([ao, ao, rib], NDMapping(3, (0, 2), (1,)), device="cpu",
                       dtype=torch.float64, tile=tile)
    for shape, ids in pat.classes().items():
        v = vals[shape].numpy()
        for i, b in enumerate(ids):
            tb.put_block((pat.mu[b], pat.lam[b], pat.p[b]), v[i])
    b = tb.finalize()
    d_pat = water_box.make(SMALL).blocks
    rng = np.random.default_rng(seed)
    sc = water_box.make(SMALL).scale
    blocks = [rng.standard_normal((ao[r], ao[c])) * s
              for r, c, s in zip(d_pat.rows, d_pat.cols, sc)]
    with torch_override(tile_size=tile):
        dm = dtt.BCSRMatrix.from_blocks(d_pat.rows, d_pat.cols, blocks, ao, ao, device="cpu",
                                        dtype=torch.float64)
    d = tten.tensor_from_matrix(dm, name="D")
    return pat, vals, b, tten.copy_tensor(b, order=(1, 0, 2), name="Bt"), d, \
        d.to_dense().to(torch.float64)


def port_step(bc, pat, b, bt, d, eps, n_batches):
    off = ri.offsets(pat.ri)
    k = None
    for a0, a1 in ri.batches(pat, n_batches):
        lo, hi = int(off[a0]), int(off[a1])
        x = bc.contract(b, d, contract_1=(1,), notcontract_1=(0, 2), contract_2=(0,),
                        notcontract_2=(1,), map_1=(0, 2), map_2=(1,),
                        bounds={"nc1": {2: (lo, hi)}}, filter_eps=eps)
        assert x.shape == (int(pat.ao.sum()), int(pat.ao.sum()), hi - lo)
        k = bc.contract(x, bt, contract_1=(1, 2), notcontract_1=(0,), contract_2=(1, 2),
                        notcontract_2=(0,), bounds={"contract": {2: (lo, hi)}},
                        filter_eps=eps, beta=0.0 if k is None else 1.0, c=k)
    return bc.filter(k, eps)


def k_err(pat, vals, k, d_dense, eps, n_batches):
    ref = ri.step(pat, vals, d_dense, eps, TIE_REL, ranges=ri.batches(pat, n_batches))
    idx = k.matrix.index
    listed = torch.zeros((pat.atoms, pat.atoms), dtype=torch.bool)
    listed[torch.as_tensor(idx.blk_rows.astype(np.int64)),
           torch.as_tensor(idx.col_idx.astype(np.int64))] = True
    return ri.k_err(ref, pat, k.to_dense(), listed, eps, TIE_REL), ref


def test_the_two_copies_of_the_reference_are_equal():
    with open(os.path.join(REPO, "tools", "torch", "ri_hfx_reference.py"), "rb") as f:
        a = f.read()
    with open(os.path.join(REPO, "benchmark", "reference", "ri_hfx.py"), "rb") as f:
        assert f.read() == a
    assert b"dbcsr_tpu" not in a and b"jax" not in a


def test_b_is_symmetric_in_its_ao_pair():
    pat, vals, b, bt, _, _ = setup_step()
    dense = b.to_dense()
    assert torch.equal(dense, dense.transpose(0, 1))
    assert torch.equal(bt.to_dense(), dense)
    assert pat.n > 100 and len(pat.classes()) == 8


@pytest.mark.parametrize("n_batches", [1, 2, 3, 5])
@pytest.mark.parametrize("tile", [16, 32])
def test_port_step_against_the_reference(n_batches, tile):
    pat, vals, b, bt, d, dd = setup_step(seed=3 + n_batches, tile=tile)
    reset_stats()
    with tten.BatchedContract() as bc:
        for _ in range(2):  # the second step runs on the plans of the first
            k = port_step(bc, pat, b, bt, d, SMALL["filter_eps"], n_batches)
    err, ref = k_err(pat, vals, k, dd, SMALL["filter_eps"], n_batches)
    assert err <= LIMIT
    # X's filter took effect: some blocks kept, some of nonzero norm dropped
    assert 0 < ref.x_kept < ref.x_nonzero
    assert get_stats().tensor_batches == 2 * 2 * n_batches
    assert get_stats().refold_bytes > 0


def test_port_step_with_ties_in_x():
    """eps set to an X block's own norm: that block ties and may go either
    way; what it adds to K is bounded apart, and the step still reads
    correct."""
    pat, vals, b, bt, d, dd = setup_step(seed=11)
    off = ri.offsets(pat.ri)
    with tten.BatchedContract() as bc:
        x = bc.contract(b, d, contract_1=(1,), notcontract_1=(0, 2), contract_2=(0,),
                        notcontract_2=(1,), map_1=(0, 2), map_2=(1,),
                        bounds={"nc1": {2: (0, int(off[-1]))}})
    nsq = np.array([float(np.sum(blk.astype(np.float64) ** 2)) for _, blk in x.iter_blocks()])
    nsq = np.sort(nsq[nsq > 0])
    eps = float(math.sqrt(nsq[len(nsq) // 2]))
    with tten.BatchedContract() as bc:
        k = port_step(bc, pat, b, bt, d, eps, 2)
    err, ref = k_err(pat, vals, k, dd, eps, 2)
    assert ref.x_ties >= 1
    assert err <= LIMIT


@pytest.mark.parametrize("eps,kept", [(1e-150, "all"), (1e15, "none")])
def test_port_step_with_x_kept_or_dropped_whole(eps, kept):
    pat, vals, b, bt, d, dd = setup_step(seed=13)
    with tten.BatchedContract() as bc:
        k = port_step(bc, pat, b, bt, d, eps, 2)
    err, ref = k_err(pat, vals, k, dd, eps, 2)
    assert err <= LIMIT
    if kept == "all":
        assert ref.x_kept == ref.x_nonzero > 0
    else:
        assert ref.x_kept == 0 and not bool(k.matrix.data.any())


def test_batched_contract_refuses():
    pat, vals, b, bt, d, dd = setup_step()
    kw = dict(contract_1=(1,), notcontract_1=(0, 2), contract_2=(0,), notcontract_2=(1,))
    with tten.BatchedContract() as bc:
        with pytest.raises(Exception, match="unknown bounds"):
            bc.contract(b, d, bounds={"nc3": {}}, **kw)
        with pytest.raises(Exception, match="not aligned"):
            bc.contract(b, d, bounds={"nc1": {2: (0, 3)}}, **kw)
        with pytest.raises(Exception, match="contracted"):
            bc.contract(b, d, bounds={"nc1": {1: (0, 13)}}, **kw)
        with pytest.raises(Exception, match="no filter_eps"):
            bc.filter(d)
        with pytest.raises(Exception, match="beta"):
            bc.contract(b, d, beta=0.5, c=d, **kw)
        # a window result carries where it starts: contracted against
        # another batch's bounds, or with none, it is refused
        off = ri.offsets(pat.ri)
        (a0, a1), (a2, a3) = ri.batches(pat, 3)[:2]
        lo, hi = int(off[a0]), int(off[a1])
        lo2, hi2 = int(off[a2]), int(off[a3])
        x = bc.contract(b, d, bounds={"nc1": {2: (lo2, hi2)}}, map_1=(0, 2), map_2=(1,), **kw)
        assert x.starts == (0, 0, lo2)
        x = x.with_layout(NDMapping(3, (0,), (1, 2)))
        assert x.starts == (0, 0, lo2)
        kw2 = dict(contract_1=(1, 2), notcontract_1=(0,), contract_2=(1, 2), notcontract_2=(0,))
        with pytest.raises(Exception, match="reach outside"):
            bc.contract(x, bt, bounds={"contract": {2: (lo, hi)}}, **kw2)
        with pytest.raises(Exception, match="start at elements"):
            bc.contract(x, bt, **kw2)
        k = bc.contract(x, bt, bounds={"contract": {2: (lo2, hi2)}}, **kw2)
        assert k.starts == (0, 0)
        y = bc.contract(b, d, bounds={"nc1": {2: (lo, hi)}}, map_1=(0, 2), map_2=(1,), **kw)
        with pytest.raises(Exception, match="c starts at"):
            bc.contract(b, d, bounds={"nc1": {2: (lo, hi)}}, map_1=(0, 2), map_2=(1,),
                        beta=1.0, c=x, **kw)
        assert y.starts == (0, 0, lo)


# ---- the refold ------------------------------------------------------------------

def _rand_tensor(block_sizes, mapping, occ, seed, dtype, tile=T):
    rng = np.random.default_rng(seed)
    bs = [np.asarray(s, dtype=np.int32) for s in block_sizes]
    tb = TensorBuilder(bs, NDMapping(len(bs), *mapping), device="cpu", dtype=dtype, tile=tile)
    for bi in np.ndindex(*[len(s) for s in bs]):
        if rng.random() < occ:
            shape = tuple(int(bs[k][bi[k]]) for k in range(len(bs)))
            blk = rng.standard_normal(shape)
            if dtype.is_complex:
                blk = blk + 1j * rng.standard_normal(shape)
            tb.put_block(bi, blk)
    return tb.finalize()


#: (per-dim block sizes, old fold); every other fold of the rank is a target
REFOLD_TENSORS = [
    ([[13, 5, 5], [13, 5], [56, 14, 14]], ((0, 2), (1,))),  # the RI tensor's classes
    ([[2, 3], [4, 1, 2], [3], [1, 5]], ((3, 1), (0, 2))),
    ([[7, 9, 1], [30, 2]], ((0,), (1,))),
]


def _targets(ndim):
    import itertools

    for perm in itertools.permutations(range(ndim)):
        for h in range(1, ndim):
            yield perm[:h], perm[h:]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.complex128])
@pytest.mark.parametrize("case", range(len(REFOLD_TENSORS)))
def test_refold_is_bitwise_the_element_map(case, dtype):
    """Every block class of the tensor, to every fold: the block-granular
    refold equals the element map's gather bit for bit, and so does its
    plain version on the same plan."""
    sizes, mapping = REFOLD_TENSORS[case]
    t = _rand_tensor(sizes, mapping, 0.7, case, dtype)
    classes = {tuple(int(sizes[k][i]) for k, i in enumerate(bi)) for bi in t.block_indices()}
    assert len(classes) >= 4
    for target in _targets(t.ndim):
        target = NDMapping(t.ndim, *target)
        if (target.map1, target.map2) == (t.mapping.map1, t.mapping.map2):
            continue
        want = element_map_refold(t, target)
        got = t.with_layout(target).matrix.data
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
        _, plan = refold_layout(t, target)
        again = torch.zeros_like(want)
        refold_plain(t.matrix.data, plan, again)
        assert torch.equal(again.view(torch.uint8), want.view(torch.uint8))


def test_refold_plan_is_block_granular():
    """The refold's plan keeps a few numbers a block, and no element map."""
    t = _rand_tensor([[13, 5, 5] * 4, [13, 5] * 3, [56, 14, 14] * 2], ((0, 2), (1,)), 0.5, 3,
                     torch.float64)
    _, plan = refold_layout(t, NDMapping(3, (0,), (1, 2)))
    nb = t.matrix.index.nblks
    assert plan.nelems == t.matrix.index.nelems > 20 * nb
    assert plan.n_blocks == nb and plan.sizes.nbytes + plan.src.nbytes + plan.dst.nbytes == 48 * nb
    assert plan.nbytes == 0  # no device arrays on the CPU


def test_store_layout_tiles_without_the_element_map():
    """The store layout places its tiles from the blocks alone; the element
    map is built only when asked for, and agrees with them."""
    from dbcsr_tpu_torch.block.store import block_tile_coords, store_layout
    from dbcsr_tpu_torch.mm.pack import tile_panel_maps

    t = _rand_tensor([[13, 5, 0, 5], [13, 5, 2], [56, 14]], ((0, 2), (1,)), 0.6, 5,
                     torch.float64, tile=32)
    idx = t.matrix.index
    lay = store_layout(idx, 16)
    assert ("store_elem_dest", 16) not in idx._cache
    _, coords, _ = tile_panel_maps(idx, 16, False)
    np.testing.assert_array_equal(lay.tile_coords, coords)
    np.testing.assert_array_equal(block_tile_coords(idx, 16), coords)
    assert len(lay.elem_dest) == idx.nelems
    assert ("store_elem_dest", 16) in idx._cache


@pytest.mark.parametrize("target", [((4, 0), (2, 1, 3)), ((1, 2, 3, 4), (0,))])
def test_refold_above_rank_four_takes_the_plain_version(target):
    t = _rand_tensor([[2, 1], [3, 1], [1, 2], [2, 2], [1, 3]], ((0, 1), (2, 3, 4)), 0.5, 9,
                     torch.float64)
    target = NDMapping(5, *target)
    want = element_map_refold(t, target)
    got = t.with_layout(target).matrix.data
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
