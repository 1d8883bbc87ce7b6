"""``BatchedContract`` with ``bounds`` and ``filter_eps``, batch by batch,
against the one-shot port ``contract`` and the JAX package's ``contract``
with the same bounds, on a small 3-center chain X(μ,σ,P) = Σ_λ A(μ,λ,P)
D(λ,σ), then K(μ,ν) = Σ_{σ,P} X(μ,σ,P) A(ν,σ,P):

* a window over a free dim (P) with eps: each compact window equals that
  window of both one-shots (kept blocks the same, values within rounding);
* batches over the contracted P, summed into one output (beta = 1): the sum
  equals the JAX package's ``contract`` chained over the same bounds, and,
  filtered once, the port's one-shot over the whole P with the same eps.
"""
import numpy as np
import pytest
import torch

import dbcsr_tpu.tensors as jten
from dbcsr_tpu.core.config import config_override as jax_override

import dbcsr_tpu_torch.tensors as tten
from dbcsr_tpu_torch.core.config import config_override as torch_override
from dbcsr_tpu_torch.testing import tensor_from_arrays

torch.set_num_threads(1)

T = 16
AO = [3, 2, 2, 3, 2]
RI = [4, 2, 3, 2, 4, 2]
KW1 = dict(contract_1=(1,), notcontract_1=(0, 2), contract_2=(0,), notcontract_2=(1,),
           map_1=(0, 2), map_2=(1,))
KW2 = dict(contract_1=(1, 2), notcontract_1=(0,), contract_2=(1, 2), notcontract_2=(0,))


def pair(block_sizes, mapping, occ, rng, sym=False):
    """The same random tensor in both packages, built in the JAX package.
    ``sym``: symmetric in dims 0 and 1 (as the fitted 3-center tensor)."""
    bs = [np.asarray(b, dtype=np.int32) for b in block_sizes]
    builder = jten.TensorBuilder(bs, jten.NDMapping(len(bs), *mapping), dtype=np.float64)
    nbpd = [len(b) for b in bs]
    blocks = {}
    for bi in np.ndindex(*nbpd):
        if sym and bi[0] > bi[1]:
            continue
        if rng.random() < occ:
            shape = tuple(int(bs[d][bi[d]]) for d in range(len(bs)))
            blk = rng.standard_normal(shape) * 10.0 ** rng.integers(-3, 1)
            if sym and bi[0] == bi[1]:
                blk = (blk + blk.transpose(1, 0, *range(2, len(bs)))) / 2
            blocks[bi] = blk
            if sym and bi[0] != bi[1]:
                blocks[(bi[1], bi[0]) + bi[2:]] = blk.transpose(1, 0, *range(2, len(bs)))
    for bi, blk in blocks.items():
        builder.put_block(bi, blk)
    with jax_override(tile_size=T):
        tj = builder.finalize()
    m = tj.matrix
    tt = tensor_from_arrays(tj.block_sizes, tj.mapping.map1, tj.mapping.map2,
                            m.index.blk_rows, m.index.col_idx, m.flat_host(),
                            dtype=np.float64, device="cpu", tile=T, name="T")
    return tj, tt


def dense_j(tj):
    return torch.as_tensor(np.asarray(tj.to_dense()), dtype=torch.float64)


def p_ranges(n):
    off = np.concatenate([[0], np.cumsum(RI)])
    cuts = np.linspace(0, len(RI), n + 1).round().astype(int)
    return [(int(off[a]), int(off[b])) for a, b in zip(cuts[:-1], cuts[1:])]


@pytest.mark.parametrize("n_batches", [2, 3])
def test_window_with_eps_against_the_one_shots(n_batches):
    rng = np.random.default_rng(n_batches)
    aj, at = pair([AO, AO, RI], ((0, 2), (1,)), 0.6, rng, sym=True)
    dj, dt_ = pair([AO, AO], ((0,), (1,)), 0.8, rng)
    eps = 0.05
    with tten.BatchedContract() as bc, torch_override(tile_size=T), \
            jax_override(tile_size=T, f64_method="native"):
        for lo, hi in p_ranges(n_batches):
            bounds = {"nc1": {2: (lo, hi)}}
            win = bc.contract(at, dt_, bounds=bounds, filter_eps=eps, **KW1)
            assert win.shape[2] == hi - lo
            got = win.to_dense()
            once = tten.contract(1.0, at, dt_, bounds=bounds, filter_eps=eps, **KW1).to_dense()
            jonce = dense_j(jten.contract(1.0, aj, dj, bounds=bounds, filter_eps=eps, **KW1))
            for full in (once, jonce):
                assert not bool(full[:, :, :lo].any()) and not bool(full[:, :, hi:].any())
                ref = full[:, :, lo:hi]
                assert torch.equal(got != 0, ref != 0)
                assert float((got - ref).abs().max()) <= 1e-13 * float(ref.abs().max())
            assert bool((got == 0).any()) and bool((got != 0).any())


def test_batches_summed_over_the_contracted_dim_against_the_one_shots():
    rng = np.random.default_rng(7)
    aj, at = pair([AO, AO, RI], ((0, 2), (1,)), 0.6, rng, sym=True)
    dj, dt_ = pair([AO, AO], ((0,), (1,)), 0.8, rng)
    bt = tten.copy_tensor(at, order=(1, 0, 2))
    btj = jten.copy_tensor(aj, order=(1, 0, 2))
    eps = 0.5
    with torch_override(tile_size=T), jax_override(tile_size=T, f64_method="native"):
        x = tten.contract(1.0, at, dt_, **KW1).with_layout(tten.NDMapping(3, (0,), (1, 2)))
        xj = jten.contract(1.0, aj, dj, **KW1)
        with tten.BatchedContract() as bc:
            k = kj = None
            for lo, hi in p_ranges(3):
                bounds = {"contract": {2: (lo, hi)}}
                k = bc.contract(x, bt, bounds=bounds, filter_eps=eps,
                                beta=0.0 if k is None else 1.0, c=k, **KW2)
                kj = jten.contract(1.0, xj, btj, 1.0 if kj is not None else 0.0, kj,
                                   bounds=bounds, **KW2)
            ref = dense_j(kj)
            assert float((k.to_dense() - ref).abs().max()) <= 1e-13 * float(ref.abs().max())
            assert [e for _, e in bc._pending] == [eps]
        # finalize filtered it in place
        assert not bc._pending
        once = tten.contract(1.0, x, bt, filter_eps=eps, **KW2).to_dense()
    got = k.to_dense()
    assert torch.equal(got != 0, once != 0)
    assert 0 < int((once != 0).sum()) < once.numel()
    assert float((got - once).abs().max()) <= 1e-13 * float(once.abs().max())


def test_window_cut_follows_new_data():
    """A window is cut from the operand's store as it is at each call: new
    data over the same pattern, the same store changed in place, or the
    same store filtered in place by ``BatchedContract.filter`` (a kernel
    on a card, which writes past torch's version count)."""
    import dataclasses

    rng = np.random.default_rng(3)
    _, at = pair([AO, AO, RI], ((0, 2), (1,)), 0.6, rng, sym=True)
    _, dt_ = pair([AO, AO], ((0,), (1,)), 0.8, rng)
    bounds = {"nc1": {2: p_ranges(2)[1]}}
    with tten.BatchedContract() as bc, torch_override(tile_size=T):
        for step in range(4):
            got = bc.contract(at, dt_, bounds=bounds, **KW1).to_dense()
            want = tten.contract(1.0, at, dt_, bounds=bounds, **KW1).to_dense()
            lo, hi = bounds["nc1"][2]
            assert torch.equal(got, want[:, :, lo:hi])
            if step == 0:  # new data, same pattern
                at = dataclasses.replace(at, matrix=at.matrix.with_data(at.matrix.data * 2.0))
            elif step == 1:  # the same store, changed in place
                at.matrix.data.mul_(-1.5)
            elif step == 2:  # the same store, filtered in place
                nonzero = int((at.matrix.data != 0).sum())
                bc.filter(at, 0.5)
                assert 0 < int((at.matrix.data != 0).sum()) < nonzero
