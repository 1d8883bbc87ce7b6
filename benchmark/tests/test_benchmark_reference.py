"""The plain reference and ``block_err``: a sound float64 product passes; a
corrupted output tile, a wrongly kept block, a wrongly dropped block, a
block outside the pattern and a product computed in float32 fail."""
import json
import math
import os

import numpy as np
import pytest
import torch

from conftest import REPO, TINY

from benchmark.operands import make_operands, pattern_of
from benchmark.products import Control
from benchmark.reference.judge import block_err
from benchmark.reference.layout import (Blocks, dense_rows, positions, tile_keys,
                                        write_rows)
from benchmark.reference.product import Product, superset

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def case():
    with open(os.path.join(REPO, "benchmark", "configs", "water_2048.json")) as f:
        cfg = dict(json.load(f), **TINY)
    ops = make_operands(cfg, pattern_of(cfg), 2**31 + 5, 1, CPU)
    ref = Product(ops.pattern, ops.keys, ops.b, torch.float64)
    c = superset(ops.pattern)
    # the product block by block, as a second witness of the reference's
    # dense product
    a = {(int(i), int(j)): n for n, (i, j) in enumerate(zip(ops.pattern.rows, ops.pattern.cols))}
    return cfg, ops, ref, c, a


def blocks_of(ops, store, b: Blocks):
    """Every block of ``b`` read out of ``store`` (by shape class)."""
    keys = tile_keys(b, store.shape[-1])
    flat = store.reshape(-1)
    out = {}
    for shape, ids in b.classes().items():
        x = flat[positions(b, ids, shape, keys, store.shape[-1], CPU)]
        for n, i in enumerate(ids):
            out[int(i)] = x[n]
    return out


def mask_store(ref, c: Blocks, a_store, keep_fn=None, tweak=None):
    """C in mask form from the reference's dense product (float64)."""
    tile = ref.tile
    keys = tile_keys(c, tile)
    store = torch.zeros((len(keys), tile, tile), dtype=torch.float64)
    full = torch.cat([r for _, r in ref.rows(a_store)])
    sums = ref.sums(full.square(), 0)[:-1, :-1]
    keep = torch.ones_like(sums, dtype=torch.bool) if keep_fn is None else keep_fn(sums)
    if tweak is not None:
        tweak(keep)
    on = torch.zeros((ref.nb + 1, ref.nb + 1), dtype=torch.bool)
    on[torch.as_tensor(c.rows), torch.as_tensor(c.cols)] = True
    on[:-1, :-1] &= keep
    write_rows(store, keys, ref.nt, 0, full * on[ref.owner][:, ref.owner])
    return store


def test_reference_matches_block_products(case):
    cfg, ops, ref, c, a = case
    store = mask_store(ref, c, ops.a[0])
    got = blocks_of(ops, store, c)
    ab = blocks_of(ops, ops.a[0], ops.pattern)
    bb = blocks_of(ops, ops.b, ops.pattern)
    p = ops.pattern
    ptr = np.searchsorted(p.rows, np.arange(len(p.row_sizes) + 1))
    for n in range(0, c.n, max(1, c.n // 200)):
        i, j = int(c.rows[n]), int(c.cols[n])
        want = torch.zeros((int(p.row_sizes[i]), int(p.col_sizes[j])), dtype=torch.float64)
        for ik in range(ptr[i], ptr[i + 1]):
            k = int(p.cols[ik])
            kj = a.get((k, j))
            if kj is not None:
                want += ab[ik] @ bb[kj]
        assert torch.allclose(got[n], want, rtol=1e-12, atol=1e-14), (i, j)


def test_dense_rows_round_trip(case):
    cfg, ops, ref, c, a = case
    d = dense_rows(ops.a[0], ops.keys, ref.nt, 0, ref.nt)
    back = torch.zeros_like(ops.a[0])
    write_rows(back, ops.keys, ref.nt, 0, d)
    assert torch.equal(back, ops.a[0])


def test_sound_product_passes(case):
    cfg, ops, ref, c, a = case
    store = mask_store(ref, c, ops.a[0])
    assert block_err(ref, ops.a[0], c, store) <= cfg["limits"]["block_err"]
    eps = cfg["eps"]
    store = mask_store(ref, c, ops.a[0], lambda s: s >= eps**2)
    err = block_err(ref, ops.a[0], c, store, eps, cfg["norm_tie_rel"])
    assert err <= cfg["limits"]["block_err"]


def test_corrupted_tile_fails(case):
    cfg, ops, ref, c, a = case
    store = mask_store(ref, c, ops.a[0])
    store[3] *= 1.0 + 1e-6
    assert block_err(ref, ops.a[0], c, store) > cfg["limits"]["block_err"]


def test_padding_is_not_read(case):
    """What a store holds between listed blocks does not count."""
    cfg, ops, ref, c, a = case
    small = Blocks(rows=c.rows[:1], cols=c.cols[:1], row_sizes=c.row_sizes,
                   col_sizes=c.col_sizes)
    full = torch.cat([r for _, r in ref.rows(ops.a[0])])
    keys = tile_keys(small, ref.tile)
    store = torch.zeros((len(keys), ref.tile, ref.tile), dtype=torch.float64)
    write_rows(store, keys, ref.nt, 0, full)  # whole tiles, beyond the one block
    err = block_err(ref, ops.a[0], small, store)
    assert 0.5 < err < math.inf  # the blocks left out read as missing, not as garbage
    store[0, 100, 100] = float("nan")
    assert block_err(ref, ops.a[0], small, store) == err


@pytest.mark.parametrize("below", [True, False], ids=["wrongly_kept", "wrongly_dropped"])
def test_wrong_keep_decision_fails(case, below):
    cfg, ops, ref, c, a = case
    eps, tie = cfg["eps"], cfg["norm_tie_rel"]
    full = torch.cat([r for _, r in ref.rows(ops.a[0])])
    sums = ref.sums(full.square(), 0)[:-1, :-1]
    on = torch.zeros_like(sums, dtype=torch.bool)
    on[torch.as_tensor(c.rows), torch.as_tensor(c.cols)] = True
    far = (sums - eps**2).abs() > 10 * tie * eps**2
    side = (sums < eps**2) if below else (sums >= eps**2)
    hit = torch.nonzero(on & far & side)
    assert len(hit), "no block on that side of eps"
    i, j = (int(x) for x in hit[0])

    def flip(keep):
        keep[i, j] = not bool(keep[i, j])

    store = mask_store(ref, c, ops.a[0], lambda s: s >= eps**2, flip)
    assert block_err(ref, ops.a[0], c, store, eps, tie) > cfg["limits"]["block_err"]


def test_block_outside_pattern_fails(case):
    cfg, ops, ref, c, a = case
    w = ref.bound(ops.a[0])
    i, j = (int(x) for x in torch.nonzero(w == 0)[0])
    keys = np.append(c.keys, i * ref.nb + j)
    order = np.argsort(keys)
    extra = Blocks(rows=np.append(c.rows, i)[order], cols=np.append(c.cols, j)[order],
                   row_sizes=c.row_sizes, col_sizes=c.col_sizes)
    store = torch.zeros((len(tile_keys(extra, ref.tile)), ref.tile, ref.tile),
                        dtype=torch.float64)
    assert math.isinf(block_err(ref, ops.a[0], extra, store))


@pytest.mark.parametrize("filtered,compact", [(False, False), (True, False), (True, True)],
                         ids=["plain", "filtered", "compact"])
def test_float32_run_fails_float64_comparison(case, filtered, compact):
    """The control: the reference itself in float32 in the program's place."""
    cfg, ops, ref, c, a = case
    blocks, store = Control(cfg, ops, filtered, compact)(ops.a[0])
    eps = cfg["eps"] if filtered else None
    err = block_err(ref, ops.a[0], blocks, store, eps, cfg["norm_tie_rel"])
    assert err > 100 * cfg["limits"]["block_err"]


@pytest.mark.parametrize("control,sound", [("complex128", True), ("complex64", False)])
def test_complex_operands(case, control, sound):
    """Complex data runs through the same reference: the reference in
    complex128 in the program's place passes, in complex64 it fails."""
    cfg = dict(case[0], dtype="complex128", control_dtype=control)
    ops = make_operands(cfg, pattern_of(cfg), 2**31 + 11, 1, CPU)
    ref = Product(ops.pattern, ops.keys, ops.b, torch.complex128)
    blocks, store = Control(cfg, ops, True, False)(ops.a[0])
    err = block_err(ref, ops.a[0], blocks, store, cfg["eps"], cfg["norm_tie_rel"])
    assert (err <= cfg["limits"]["block_err"]) is sound, err
