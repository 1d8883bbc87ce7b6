"""Port parity, the RCM reordering (``mm/reorder.py``) and the port's
independence of the JAX package's files.

``locality_reorder_plan`` and ``locality_block_permutation`` are compared
array for array with the JAX package's on the same coordinates (both call
scipy's reverse Cuthill-McKee on the same graph); ``permute_blocks`` by the
dense matrices it produces (exactly: it only moves values). The executor's
reordered panel route (``reorder="auto"``) is held to the ``reorder="off"``
result and to a float64 dense product within 2e-5 of the largest entry
(float32 sums in another order).
"""
import os
import re

import numpy as np
import pytest
import torch

import dbcsr_tpu as djax
from dbcsr_tpu.core.config import config_override as jax_override
from dbcsr_tpu.mm.reorder import locality_block_permutation as jax_block_perm
from dbcsr_tpu.mm.reorder import locality_reorder_plan as jax_reorder_plan
from dbcsr_tpu.mm.reorder import permute_blocks as jax_permute_blocks

import dbcsr_tpu_torch as dtt
from dbcsr_tpu_torch.core.config import config_override
from dbcsr_tpu_torch.mm.panel import plan_panel_stack
from dbcsr_tpu_torch.mm.reorder import (
    ReorderPlan,
    locality_block_permutation,
    locality_reorder_plan,
    permute_blocks,
    tile_bandwidth,
)
from dbcsr_tpu_torch.mm.tileplan import plan_tile_stacks_stores

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def scrambled_band_pair(n, w, seed=0):
    """As tests/test_reorder.py: banded A and B tile patterns |i-j| <= w
    whose labels are scrambled by three hidden permutations (A's column
    scramble is B's row scramble)."""
    rng = np.random.default_rng(seed)
    i = np.repeat(np.arange(n, dtype=np.int64), 2 * w + 1)
    j = i + np.tile(np.arange(-w, w + 1, dtype=np.int64), n)
    keep = (j >= 0) & (j < n)
    i, j = i[keep], j[keep]
    sig_m, sig_k, sig_n = (rng.permutation(n).astype(np.int64) for _ in range(3))

    def scramble(sr, sc):
        coords = np.stack([sr[i], sc[j]], axis=1)
        return coords[np.argsort(coords[:, 0] * n + coords[:, 1])]

    return scramble(sig_m, sig_k), scramble(sig_k, sig_n)


def scrambled_chain(n, sizes, seed, dmax=9, decay=3.0):
    """As bench.py's clustered leg, narrowed: a hidden 1-D chain with
    coupling probability exp(-d/decay) out to ``dmax`` blocks, block
    numbering scrambled by one random permutation."""
    rng = np.random.default_rng(seed)
    bs = rng.choice(sizes, size=n).astype(np.int32)
    i = np.repeat(np.arange(n, dtype=np.int64), 2 * dmax + 1)
    off = np.tile(np.arange(-dmax, dmax + 1, dtype=np.int64), n)
    j = i + off
    keep = (j >= 0) & (j < n) & (rng.random(len(j)) < np.exp(-np.abs(off) / decay))
    sig = rng.permutation(n).astype(np.int64)
    rbs = np.empty(n, np.int32)
    rbs[sig] = bs
    rows, cols = sig[i[keep]], sig[j[keep]]
    blocks = [rng.standard_normal((rbs[r], rbs[c])).astype(np.float32)
              for r, c in zip(rows, cols)]
    return rows, cols, blocks, rbs


def both_matrices(rows, cols, blocks, rbs, tile, sym="N"):
    with jax_override(tile_size=tile), config_override(tile_size=tile):
        mj = djax.BCSRMatrix.from_blocks(rows, cols, blocks, rbs, rbs, sym=sym)
        mt = dtt.BCSRMatrix.from_blocks(rows, cols, blocks, rbs, rbs, sym=sym,
                                        device="cpu")
    return mj, mt


def assert_same_reorder_plan(pj, pt):
    if pj is None or pt is None:
        assert pj is None and pt is None
        return
    for f in ReorderPlan.__dataclass_fields__:
        vj, vt = getattr(pj, f), getattr(pt, f)
        np.testing.assert_array_equal(vj, vt, err_msg=f)
        assert vj.dtype == vt.dtype, f


@pytest.mark.parametrize("n,w,seed", [(96, 3, 1), (64, 2, 3), (120, 5, 4)])
def test_reorder_plan_matches_scrambled_band(n, w, seed):
    ac, bc = scrambled_band_pair(n, w, seed)
    pj = jax_reorder_plan(ac, (n, n), bc, (n, n))
    pt = locality_reorder_plan(ac, (n, n), bc, (n, n))
    assert pt is not None
    assert_same_reorder_plan(pj, pt)
    keys = np.sort(np.random.default_rng(0).choice(n * n, 50, replace=False))
    np.testing.assert_array_equal(pj.c_slot_keys(keys, n), pt.c_slot_keys(keys, n))
    assert tile_bandwidth(pt.a_coords) < tile_bandwidth(ac) // 2


@pytest.mark.parametrize("shape", [(40, 32, 24), (48, 48, 48)])
def test_reorder_plan_matches_rectangular_random(shape):
    mt, kt, nt = shape
    rng = np.random.default_rng(7)

    def rand_coords(nr, nc):
        r, c = np.nonzero(rng.random((nr, nc)) < 0.3)
        return np.stack([r, c], axis=1).astype(np.int64)

    ac, bc = rand_coords(mt, kt), rand_coords(kt, nt)
    pt = locality_reorder_plan(ac, (mt, kt), bc, (kt, nt))
    assert_same_reorder_plan(jax_reorder_plan(ac, (mt, kt), bc, (kt, nt)), pt)
    # a bijective renumbering: the replanned stack has the same triples
    nat = plan_tile_stacks_stores(ac, (mt, kt), bc, (kt, nt))
    rpl = plan_tile_stacks_stores(pt.a_coords, (mt, kt), pt.b_coords, (kt, nt))
    assert len(rpl.stack) == len(nat.stack) and rpl.n_c_tiles == nat.n_c_tiles


def test_reorder_plan_degenerate_inputs_match():
    z = np.zeros((0, 2), dtype=np.int64)
    tiny = np.array([[0, 0]], dtype=np.int64)
    for c, g in ((z, (4, 4)), (tiny, (2, 2))):
        assert jax_reorder_plan(c, g, c, g) is None
        assert locality_reorder_plan(c, g, c, g) is None


def test_reorder_recovers_panel_admissibility():
    n, w = 96, 3
    ac, bc = scrambled_band_pair(n, w, seed=1)
    kw = dict(c_win=16, a_cap=64, b_cap=64, chunk=8, admit_ratio=0.9)
    nat = plan_tile_stacks_stores(ac, (n, n), bc, (n, n))
    assert plan_panel_stack(nat.stack, nat.n_c_tiles, len(ac), len(bc), **kw) is None
    rp = locality_reorder_plan(ac, (n, n), bc, (n, n))
    rpl = plan_tile_stacks_stores(rp.a_coords, (n, n), rp.b_coords, (n, n))
    pp = plan_panel_stack(rpl.stack, rpl.n_c_tiles, len(ac), len(bc), **kw)
    assert pp is not None and pp.traffic_ratio < 0.9


@pytest.mark.parametrize("with_b", [False, True])
def test_block_permutation_matches(with_b):
    rows, cols, blocks, rbs = scrambled_chain(300, [3, 5, 8], seed=11)
    aj, at = both_matrices(rows, cols, blocks, rbs, 16)
    pj = jax_block_perm(aj.index, aj.index if with_b else None)
    pt = locality_block_permutation(at.index, at.index if with_b else None)
    assert pt is not None
    for vj, vt in zip(pj, pt):
        np.testing.assert_array_equal(vj, vt)
    if not with_b:
        assert np.array_equal(pt[0], pt[1]) and np.array_equal(pt[1], pt[2])
    tiny = dtt.BCSRMatrix.from_blocks([0], [0], [np.ones((2, 2))], [2] * 4, [2] * 4,
                                      device="cpu")
    assert locality_block_permutation(tiny.index) is None
    with pytest.raises(ValueError, match="square"):
        locality_block_permutation(dtt.BCSRMatrix.from_blocks(
            [0], [0], [np.ones((2, 2))], [2] * 9, [2] * 8, device="cpu").index)


def test_permute_blocks_matches_and_recovers_tile_density():
    rows, cols, blocks, rbs = scrambled_chain(400, [3, 5, 8], seed=11)
    aj, at = both_matrices(rows, cols, blocks, rbs, 16)
    pm, pk, pn = locality_block_permutation(at.index)
    with jax_override(tile_size=16), config_override(tile_size=16):
        pj, pt = jax_permute_blocks(aj, pm, pn), permute_blocks(at, pm, pn)
    np.testing.assert_array_equal(pj.index.row_ptr, pt.index.row_ptr)
    np.testing.assert_array_equal(pj.index.col_idx, pt.index.col_idx)
    np.testing.assert_array_equal(pj.index.row_block_sizes, pt.index.row_block_sizes)
    np.testing.assert_array_equal(np.asarray(pj.data), pt.data.numpy())
    assert pt.tile == at.tile and pt.dtype == at.dtype and pt.device == at.device
    # locality recovered: the tile count shrinks substantially
    assert pt.layout.n_tiles < 0.5 * at.layout.n_tiles
    # the inverse permutations restore the matrix exactly
    back = permute_blocks(pt, np.argsort(pm), np.argsort(pn))
    assert torch.equal(back.to_dense(), at.to_dense())


@pytest.mark.parametrize("sym", ["S", "A"])
def test_permute_blocks_symmetric_similarity_matches(sym):
    rng = np.random.default_rng(5)
    rbs = djax.random_block_sizes(40, [3, 5, 8], rng)
    n = len(rbs)
    with jax_override(tile_size=8):
        aj = djax.random_matrix(rbs, rbs, 0.4, rng, dtype=np.float64, sym=sym)
    at = dtt.testing.matrix_from_arrays(
        rbs, rbs, aj.index.blk_rows, aj.index.col_idx, np.asarray(aj.data),
        device="cpu", sym=sym)
    p = np.random.default_rng(11).permutation(n).astype(np.int64)
    q = np.random.default_rng(12).permutation(n).astype(np.int64)
    with jax_override(tile_size=8), config_override(tile_size=8):
        pj, pt = jax_permute_blocks(aj, p, p), permute_blocks(at, p, p)
        assert pt.sym == sym
        np.testing.assert_array_equal(np.asarray(pj.data), pt.data.numpy())
        np.testing.assert_array_equal(
            np.asarray(djax.desymmetrize(pj).to_dense()),
            dtt.desymmetrize(pt).to_dense().numpy())
        # unequal permutations break the symmetry: full storage, sym 'N'
        uj, ut = jax_permute_blocks(aj, p, q), permute_blocks(at, p, q)
        assert ut.sym == "N" and uj.sym == "N"
        np.testing.assert_array_equal(np.asarray(uj.to_dense()), ut.to_dense().numpy())


def test_permuted_product_is_the_permuted_product():
    """C(perm) == perm(C), as bench.py's clustered leg relies on."""
    rows, cols, blocks, rbs = scrambled_chain(200, [4, 7], seed=13, dmax=5)
    _, a = both_matrices(rows, cols, blocks, rbs, 16)
    n = len(rbs)
    pm, pk, pn = (np.random.default_rng(s).permutation(n).astype(np.int64) for s in (1, 2, 3))
    with config_override(tile_size=16):
        c_ref = dtt.multiply("N", "N", 1.0, a, a)
        cp = dtt.multiply("N", "N", 1.0, permute_blocks(a, pm, pk),
                          permute_blocks(a, pk, pn))
        want = permute_blocks(c_ref, pm, pn)
    np.testing.assert_array_equal(cp.index.col_idx, want.index.col_idx)
    err = (cp.to_dense() - want.to_dense()).abs().max() / want.to_dense().abs().max()
    assert float(err) <= 2e-5


# ---------------------------------------------------------------------------
# the port needs no file of the JAX package
# ---------------------------------------------------------------------------

def test_native_planner_source_is_the_ports_own_identical_copy():
    from dbcsr_tpu_torch import native

    port = os.path.join(REPO, "dbcsr_tpu_torch", "native", "stackbuild.cpp")
    assert os.path.samefile(native._SRC, port)
    with open(port, "rb") as f, open(
            os.path.join(REPO, "dbcsr_tpu", "native", "stackbuild.cpp"), "rb") as g:
        assert f.read() == g.read(), "the two planner sources have drifted"


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "dbcsr_tpu_torch")):
        if "_build" not in root:
            out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_no_port_module_names_a_path_under_the_jax_package():
    """No ``.py`` of the port, nor ``chip_smoke.py``, imports the JAX
    package or builds a path into ``dbcsr_tpu/`` in code: no string literal
    outside a docstring names the package's directory, and no path join
    has it as a component. Docstrings and comments may mention its files,
    and a bare ``file.py:line`` citation is not a path that is opened."""
    import ast

    assert len(_port_sources()) > 30
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        docstrings = set()
        for node in ast.walk(tree):
            if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef,
                                 ast.AsyncFunctionDef)):
                body = node.body
                if (body and isinstance(body[0], ast.Expr)
                        and isinstance(body[0].value, ast.Constant)
                        and isinstance(body[0].value.value, str)):
                    docstrings.add(id(body[0].value))
            if isinstance(node, ast.Import):
                for alias in node.names:
                    assert not re.match(r"(jax|dbcsr_tpu)(\\.|$)", alias.name), (path, alias.name)
            if isinstance(node, ast.ImportFrom) and node.level == 0:
                assert not re.match(r"(jax|dbcsr_tpu)(\\.|$)", node.module or ""), (path, node.module)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docstrings):
                if re.fullmatch(r"dbcsr_tpu/[\w/]+\.py:\d+", node.value):
                    continue  # a file:line citation (chip_smoke.py's "replaces")
                assert not re.search(r"(^|[/\\\\])dbcsr_tpu([/\\\\]|$)", node.value), (
                    path, node.lineno, node.value)
