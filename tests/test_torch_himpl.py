"""The C API's Python side, in process: ``dbcsr_tpu_torch.capi.himpl`` (and
``helpers``) against ``dbcsr_tpu.capi.himpl``, each case of
``tests/test_himpl.py`` run on both with the same inputs and the results
compared, then what the port adds: the device rule, the host mirror, grids
larger than the JAX test mesh, checkpoints across the two packages.

Tolerance relative to the largest reference entry: 1e-10 for the d and z
type classes (float64 sums of the same products in another order), 1e-4
for s and c (float32). Data movement (puts, reservations, info arrays,
indices) compares exactly. The port's shim runs with
``DBCSR_CAPI_DEVICE=cpu``; the JAX package on its 8-device CPU mesh."""
import numpy as np
import pytest
import torch

from dbcsr_tpu.capi import helpers as JHELP
from dbcsr_tpu.capi import himpl as JH

from dbcsr_tpu_torch.capi import helpers as THELP
from dbcsr_tpu_torch.capi import himpl as TH
from dbcsr_tpu_torch.core.errors import DbcsrError

torch.set_num_threads(1)

TOL = {"d": 1e-10, "z": 1e-10, "s": 1e-4, "c": 1e-4}
CONST = {"s": 1, "d": 3, "c": 5, "z": 7}


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    monkeypatch.setenv("DBCSR_CAPI_DEVICE", "cpu")
    TH.init_lib(0, 0)
    assert TH.device() == torch.device("cpu")


def _addr(arr):
    return arr.ctypes.data


def dense(H, cell):
    d = H._mat(cell).to_dense()
    return d.cpu().numpy() if isinstance(d, torch.Tensor) else np.asarray(d)


def tdense(H, cell):
    d = H._tensor(cell).to_dense()
    return d.cpu().numpy() if isinstance(d, torch.Tensor) else np.asarray(d)


def close(got, ref, tol=1e-10):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)


def both(scenario, *args):
    """Run ``scenario(H, *args)`` on both himpls; returns (port, jax)."""
    return scenario(TH, *args), scenario(JH, *args)


def _mk(H, typ="d", sym="N", n=4):
    rbs = np.array([2, 3, 2, 3][:n], dtype=np.int32)
    cell = H.create_new("m", None, sym, _addr(rbs), n, _addr(rbs), n, CONST[typ])
    rng = np.random.default_rng(0)
    for i in range(n):
        for j in range(i if sym != "N" else 0, n):
            m, k = int(rbs[i]), int(rbs[j])
            blk = rng.standard_normal((m, k))
            if typ in ("z", "c"):
                blk = blk + 1j * rng.standard_normal((m, k))
            blk = np.ascontiguousarray(blk.astype(H._DTYPES[typ]))
            H.put_block2d(cell, typ, i, j, _addr(blk), m, k, 0)
    H.finalize(cell)
    return cell, rbs


# ---------------------------------------------------------------------------
# the cases of tests/test_himpl.py, on both
# ---------------------------------------------------------------------------

def _typed_roundtrip(H, typ):
    cell, rbs = _mk(H, typ)
    out = {
        "info": (H.get_data_type(cell), H.nblkrows_total(cell), H.nfullrows_total(cell),
                 H.valid_index(cell), H.get_matrix_type(cell)),
        "a": dense(H, cell), "trace": H.trace(cell), "dot": H.dot(cell, cell),
    }
    c_cell = H.create_template(cell, "C", None, "N", 0)
    H.finalize(c_cell)
    out["flops"] = H.multiply(typ, "N", "T", 1.0, 0.0, cell, cell, 0.0, 0.0, c_cell, 0, -1.0)
    out["c"] = dense(H, c_cell)
    H.scale(c_cell, typ, 2.0, 0.0)
    H.add(c_cell, c_cell, typ, 0.5, 0.0, 0.0, 0.0)  # C <- 0.5*C
    out["c2"] = dense(H, c_cell)
    return out


@pytest.mark.parametrize("typ", ["d", "s", "z", "c"])
def test_typed_roundtrip(typ):
    got, ref = both(_typed_roundtrip, typ)
    assert got["info"] == ref["info"] == (CONST[typ], 4, 10, 1, "N")
    assert got["flops"] == ref["flops"] > 0
    np.testing.assert_array_equal(got["a"], ref["a"])
    tol = TOL[typ]
    assert got["trace"] == pytest.approx(ref["trace"], rel=tol)
    assert got["dot"] == pytest.approx(ref["dot"], rel=tol)
    close(got["c"], ref["c"], tol)
    close(got["c"], got["a"] @ got["a"].T, tol)
    close(got["c2"], ref["c2"], tol)


def _diag_and_vectors(H):
    cell, rbs = _mk(H, "d")
    n = int(rbs.sum())
    out = {}
    diag = np.zeros(n, dtype=np.float64)
    H.get_diag(cell, "d", _addr(diag), n)
    out["diag"] = diag
    newdiag = np.arange(1.0, n + 1.0)
    H.set_diag(cell, "d", _addr(newdiag), n)
    out["set"] = dense(H, cell)
    H.add_on_diag(cell, "d", 1.0, 0.0)
    out["add"] = dense(H, cell)
    vec = np.linspace(1.0, 2.0, n)
    for side in ("right", "left"):
        H.scale_by_vector(cell, "d", _addr(vec), n, side)
        out[side] = dense(H, cell)
    return out


def test_diag_and_vectors():
    got, ref = both(_diag_and_vectors)
    for k in ref:
        close(got[k], ref[k])
    np.testing.assert_array_equal(np.diag(got["set"]), np.arange(1.0, 11.0))


def _copy_into_existing(H):
    rbs = np.array([2, 3, 2, 3], dtype=np.int32)
    a_cell = H.create_new("A", None, "N", _addr(rbs), 4, _addr(rbs), 4, 3)
    rng = np.random.default_rng(1)
    for i in range(4):
        s = int(rbs[i])
        blk = np.ascontiguousarray(rng.standard_normal((s, s)))
        H.put_block2d(a_cell, "d", i, i, _addr(blk), s, s, 0)
    H.finalize(a_cell)
    b_cell = H.create_template(a_cell, "B", None, "N", 3)
    blk = np.ones((2, 2), dtype=np.float64)
    H.put_block2d(b_cell, "d", 0, 0, _addr(blk), 2, 2, 0)
    blk2 = np.ascontiguousarray(np.full((3, 3), 7.0))
    H.put_block2d(b_cell, "d", 1, 3, _addr(blk2), 3, 3, 0)
    H.finalize(b_cell)
    before = H.get_num_blocks(b_cell)
    H.copy_into_existing(b_cell, a_cell)
    return before, H.get_num_blocks(b_cell), dense(H, b_cell), H._mat(b_cell).get_block(1, 3)


def test_copy_into_existing_keeps_pattern():
    got, ref = both(_copy_into_existing)
    assert got[0] == got[1] == ref[0] == ref[1] == 2
    np.testing.assert_array_equal(got[2], ref[2])
    assert got[3] is not None and not np.asarray(got[3]).any()


def _iterators_and_misc(H):
    cell, rbs = _mk(H, "d")
    out = {}
    it = H.iterator_start(cell)
    seen = []
    while H.iterator_blocks_left(it):
        seen.append(H.iterator_next_block_index(it))
    H.iterator_stop(it)
    out["iter"] = seen
    H.filter_matrix(cell, 1e-12)
    other, _ = _mk(H, "d")
    prod = H.create_template(cell, "P", None, "N", 3)
    H.hadamard_product(cell, other, prod)
    out["hadamard"] = dense(H, prod)
    H.triu(prod)
    out["triu"] = dense(H, prod)
    H.function_of_elements(prod, 1, 0, 0, 0)  # tanh
    out["tanh"] = dense(H, prod)
    H.clear(prod)
    out["clear"] = H.frobenius_norm(prod)
    H.init_random(cell, 1)
    out["random"] = dense(H, cell)
    H.init_random(other, 0)  # a new pattern at half the blocks
    out["random_pattern"] = dense(H, other)
    out["transposed"] = dense(H, H.transposed(cell))
    out["norms"] = [H.norm_scalar(cell, kind) for kind in (1, 2, 3, 4)]
    out["checksum"] = (H.checksum(cell, 0), H.checksum(cell, 1))
    H.setname(cell, "renamed")
    out["name"] = H.get_name(cell)
    return out


def test_iterators_and_misc():
    got, ref = both(_iterators_and_misc)
    assert got["iter"] == ref["iter"] and len(got["iter"]) == 16
    for k in ("hadamard", "triu", "tanh", "random", "random_pattern", "transposed"):
        close(got[k], ref[k])
    assert got["clear"] == ref["clear"] == 0.0
    np.testing.assert_allclose(got["norms"], ref["norms"], rtol=1e-10)
    np.testing.assert_allclose(got["checksum"], ref["checksum"], rtol=1e-10)
    assert got["name"] == ref["name"] == "renamed"


def _tensor_surface(H):
    bs_i = np.array([2, 3], dtype=np.int32)
    bs_k = np.array([2, 2], dtype=np.int32)
    nblk = np.array([2, 2], dtype=np.int32)
    t_cell = H.t_create_new("T", 2, _addr(nblk), [_addr(bs_i), _addr(bs_k)], [0], [1], 3)
    blk = np.ascontiguousarray(np.arange(4, dtype=np.float64).reshape(2, 2))
    idx = np.array([0, 0], dtype=np.int32)
    shp = np.array([2, 2], dtype=np.int32)
    H.t_put_block(t_cell, "d", 2, _addr(idx), _addr(shp), _addr(blk), 0)
    H.t_finalize(t_cell)
    out = {"ndims": H.t_ndims(t_cell), "nblks": H.t_get_num_blocks(t_cell)}
    buf = np.zeros(4, dtype=np.float64)
    out["get"] = (H.t_get_block(t_cell, "d", 2, _addr(idx), _addr(buf)), buf.copy())
    H.t_scale(t_cell, "d", 3.0, 0.0)
    H.t_get_block(t_cell, "d", 2, _addr(idx), _addr(buf))
    out["scaled"] = buf.copy()
    out["info"] = H.t_get_info(t_cell)
    out["nze"] = H.t_get_nze(t_cell)
    data = np.zeros(8, dtype=np.float64)
    out["data"] = (H.t_get_data_p(t_cell, "d", _addr(data), 8), data)
    out["mapping"] = H.t_get_mapping_info(t_cell)
    return out


def test_tensor_surface():
    got, ref = both(_tensor_surface)
    assert (got["ndims"], got["nblks"], got["nze"]) == (ref["ndims"], ref["nblks"], ref["nze"]) == (2, 1, 4)
    assert got["get"][0] == ref["get"][0] == (1, [2, 2])
    np.testing.assert_array_equal(got["get"][1], ref["get"][1])
    np.testing.assert_array_equal(got["scaled"], 3.0 * np.arange(4.0))
    np.testing.assert_array_equal(got["scaled"], ref["scaled"])
    assert got["info"] == ref["info"] == (2, [5, 4], [2, 2], 3)
    assert got["data"][0] == ref["data"][0] == 4
    np.testing.assert_array_equal(got["data"][1], ref["data"][1])
    assert got["mapping"] == ref["mapping"] == ([0], [1])


def _infovar_arrays(H):
    cell, rbs = _mk(H, "d")
    n = len(rbs)
    out = {}
    for which in ("row_blk_size", "col_blk_size", "row_blk_offset", "col_blk_offset",
                  "local_rows", "local_cols", "proc_row_dist", "proc_col_dist"):
        arr = np.full(n, -1, dtype=np.int32)
        H.get_infovar(cell, which, _addr(arr), n)
        out[which] = arr
    short = np.full(n, -1, dtype=np.int32)
    H.get_infovar(cell, "row_blk_size", _addr(short), 2)
    out["short"] = short
    with pytest.raises(Exception):
        H.get_infovar(cell, "bogus", _addr(short), n)
    return out


def test_infovar_arrays():
    got, ref = both(_infovar_arrays)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_array_equal(got["row_blk_offset"], [0, 2, 5, 7])
    np.testing.assert_array_equal(got["short"], [2, 3, -1, -1])


def _rank2_tensor(H, name, bs_a, bs_b, blocks):
    nblk = np.array([len(bs_a), len(bs_b)], dtype=np.int32)
    cell = H.t_create_new(name, 2, _addr(nblk), [_addr(bs_a), _addr(bs_b)], [0], [1], 3)
    for (i, j), blk in blocks.items():
        idx = np.array([i, j], dtype=np.int32)
        shp = np.array(blk.shape, dtype=np.int32)
        blk = np.ascontiguousarray(blk.astype(np.float64))
        H.t_put_block(cell, "d", 2, _addr(idx), _addr(shp), _addr(blk), 0)
    H.t_finalize(cell)
    return cell


def _ab_blocks():
    rng = np.random.default_rng(3)
    bs_i = np.array([2, 3], dtype=np.int32)
    bs_k = np.array([2, 2], dtype=np.int32)
    bs_j = np.array([3, 2], dtype=np.int32)
    a = {(i, k): rng.standard_normal((bs_i[i], bs_k[k])) for i in range(2) for k in range(2)}
    b = {(k, j): rng.standard_normal((bs_k[k], bs_j[j])) for k in range(2) for j in range(2)}
    return bs_i, bs_k, bs_j, a, b


def _typed_contract_index(H):
    bs_i, bs_k, bs_j, a_blocks, b_blocks = _ab_blocks()
    a_cell = _rank2_tensor(H, "A", bs_i, bs_k, a_blocks)
    b_cell = _rank2_tensor(H, "B", bs_k, bs_j, b_blocks)
    c_cell = _rank2_tensor(H, "C", bs_i, bs_j, {})
    ridx = np.full(16, -7, dtype=np.int32)
    n1 = H.t_contract_index_typed("d", 1.0, 0.0, a_cell, b_cell, 0.0, 0.0, c_cell,
                                  [1], [0], [0], [1], -1.0, _addr(ridx), 16)
    short = np.full(3, -7, dtype=np.int32)
    n2 = H.t_contract_index_typed("d", 1.0, 0.0, a_cell, b_cell, 0.0, 0.0, c_cell,
                                  [1], [0], [0], [1], -1.0, _addr(short), 3)
    n3 = H.t_contract_index(a_cell, b_cell, c_cell, [1], [0], [0], [1])
    fl = H.t_contract("d", 1.0, 0.0, a_cell, b_cell, 0.0, 0.0, c_cell,
                      [1], [0], [0], [1], [0], [1], -1.0)
    return n1, ridx, n2, short, n3, fl, tdense(H, c_cell)


def test_typed_contract_index():
    got, ref = both(_typed_contract_index)
    assert got[0] == ref[0] == got[2] == ref[2] == got[4] == ref[4] == 4
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[3].tolist() == ref[3].tolist() == [0, 0, 0]
    assert got[5] == ref[5] > 0
    close(got[6], ref[6])


def _typed_filter(H):
    bs = np.array([2, 2], dtype=np.int32)
    blocks = {(0, 0): np.full((2, 2), 10.0), (1, 1): np.full((2, 2), 1e-6)}
    out = []
    for eps, absolute in ((1e-3, 0), (1e-4, 1), (1e-9, 0)):
        cell = _rank2_tensor(H, "F", bs, bs, blocks)
        H.t_filter(cell, eps, 1, absolute)
        out.append(H.t_get_num_blocks(cell))
    with pytest.raises(Exception):
        H.t_filter(cell, 1e-3, 2, 0)  # only Frobenius
    return out


def test_typed_filter():
    got, ref = both(_typed_filter)
    assert got == ref == [1, 1, 2]


# ---------------------------------------------------------------------------
# more of the surface, on both
# ---------------------------------------------------------------------------

def _tensor_ops(H):
    bs_i, bs_k, bs_j, a_blocks, b_blocks = _ab_blocks()
    a_cell = _rank2_tensor(H, "A", bs_i, bs_k, a_blocks)
    b_cell = _rank2_tensor(H, "B", bs_k, bs_j, b_blocks)
    out = {}
    c_cell = _rank2_tensor(H, "C", bs_i, bs_j, {})
    # bounds_1: the contracted index restricted to its first block (0, 2)
    H.t_contract("d", 1.0, 0.0, a_cell, b_cell, 0.0, 0.0, c_cell,
                 [1], [0], [0], [1], [0], [1], -1.0, [0, 2], None, None)
    out["bounded"] = tdense(H, c_cell)
    H.t_contract("d", 2.0, 0.0, a_cell, b_cell, 1.0, 0.0, c_cell,
                 [1], [0], [0], [1], [0], [1], -1.0)
    out["beta"] = tdense(H, c_cell)
    d_cell = _rank2_tensor(H, "D", bs_i, bs_k, {})
    H.t_copy(a_cell, d_cell, 0)
    H.t_copy(a_cell, d_cell, 1)  # summation: 2A
    out["copy"] = tdense(H, d_cell)
    facs = np.array([2, 1], dtype=np.int32)
    H.t_split_blocks(d_cell, 2, _addr(facs))
    out["split"] = (H.t_get_nd_index_blk(d_cell), tdense(H, d_cell))
    H.t_set(d_cell, "d", 0.5, 0.0)
    out["set"] = tdense(H, d_cell)
    H.t_clear(d_cell)
    out["clear"] = tdense(H, d_cell)
    m_cell, _ = _mk(H, "d")
    t_cell = H.t_create_matrix(m_cell, "TM")
    out["from_matrix"] = tdense(H, t_cell)
    back = H.create_template(m_cell, "back", None, "N", 3)
    H.t_copy_tensor_to_matrix(t_cell, back)
    out["to_matrix"] = dense(H, back)
    it = H.t_iterator_start(a_cell)
    seen = []
    while H.t_iterator_blocks_left(it):
        buf = np.zeros(16)
        seen.append(H.t_iterator_next_block(it, "d", _addr(buf)))
    H.t_iterator_stop(it)
    out["iter"] = seen
    state = H.t_batched_contract_init(a_cell)
    H.t_batched_contract_finalize(state)
    out["state"] = state.obj
    return out


def test_tensor_operations():
    got, ref = both(_tensor_ops)
    for k in ("bounded", "beta", "copy", "set", "clear", "from_matrix", "to_matrix"):
        close(got[k], ref[k])
    assert got["split"][0] == ref["split"][0] == [4, 2]
    close(got["split"][1], ref["split"][1])
    assert got["iter"] == ref["iter"]
    assert got["state"] is None and ref["state"] is None


def _symmetric_and_access(H, typ):
    cell, rbs = _mk(H, typ, sym="H" if typ in ("z", "c") else "S")
    out = {"type": H.get_matrix_type(cell), "sym": H.has_symmetry(cell)}
    lower = np.zeros(9, dtype=H._DTYPES[typ])
    out["lower"] = (H.get_block_p(cell, typ, 1, 0, _addr(lower)), lower)
    out["absent"] = H.get_block_p(cell, typ, 3, 3, 0)
    out["desym"] = dense(H, H.desymmetrize(cell))
    out["size"] = H.get_data_size(cell)
    data = np.zeros(out["size"], dtype=H._DTYPES[typ])
    out["data"] = (H.get_data(cell, typ, _addr(data), data.size), data)
    out["info"] = H.get_info(cell)
    out["occ"] = H.get_occupation(cell)
    out["diag"] = dense(H, H.get_block_diag(cell))
    return out


@pytest.mark.parametrize("typ", ["d", "z"])
def test_symmetric_matrix_and_block_access(typ):
    got, ref = both(_symmetric_and_access, typ)
    assert (got["type"], got["sym"]) == (ref["type"], ref["sym"])
    assert got["lower"][0] == ref["lower"][0] == (1, 3, 2)
    np.testing.assert_array_equal(got["lower"][1], ref["lower"][1])
    assert got["absent"][0] == 1 and got["absent"] == ref["absent"]
    close(got["desym"], ref["desym"])
    assert got["size"] == ref["size"]
    assert got["data"][0] == ref["data"][0] == got["size"]
    np.testing.assert_array_equal(got["data"][1], ref["data"][1])
    assert got["info"] == ref["info"]
    assert got["occ"] == pytest.approx(ref["occ"], rel=1e-12)
    close(got["diag"], ref["diag"])


def _reserve(H):
    rbs = np.array([2, 3, 2], dtype=np.int32)
    cell = H.create_new("R", None, "N", _addr(rbs), 3, _addr(rbs), 3, 3)
    H.reserve_block2d(cell, 0, 2)
    rows = np.array([1, 2], dtype=np.int32)
    cols = np.array([0, 2], dtype=np.int32)
    H.reserve_blocks(cell, _addr(rows), _addr(cols), 2)
    blk = np.ones((2, 2))
    H.put_block2d(cell, "d", 2, 2, _addr(blk), 2, 2, 0)
    H.reserve_diag_blocks(cell)
    H.finalize(cell)
    n1 = H.get_num_blocks(cell)
    full = H.create_template(cell, "F", None, "N", 3)
    H.reserve_all_blocks(full)
    # a put on a finalized matrix reopens it
    H.put_block2d(cell, "d", 0, 1, _addr(np.ones((2, 3))), 2, 3, 0)
    return n1, dense(H, cell), H.get_num_blocks(full)


def test_reserved_blocks_through_the_shim():
    got, ref = both(_reserve)
    assert got[0] == ref[0] == 5
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[2] == ref[2] == 9


def test_checkpoint_written_by_one_shim_reads_in_the_other(tmp_path):
    for H, G in ((TH, JH), (JH, TH)):
        cell, _ = _mk(H, "z")
        path = str(tmp_path / f"{H.__name__}.bin")
        H.binary_write(cell, path)
        back = G.binary_read(path)
        np.testing.assert_array_equal(dense(G, back), dense(H, cell))
        assert G.get_data_type(back) == 7
    assert TH._mat(TH.binary_read(path)).device == torch.device("cpu")


def _legacy(HELP):
    rbs = np.array([2, 3], dtype=np.int32)
    b = HELP.create("L", _addr(rbs), 2, _addr(rbs), 2)
    blk = np.ascontiguousarray(np.arange(6.0).reshape(2, 3))
    HELP.put_block(b, 0, 1, _addr(blk), 2, 3, 0)
    HELP.put_block(b, 0, 1, _addr(blk), 2, 3, 1)
    HELP.reserve_diag_blocks(b)
    a = HELP.finalize(b)
    out = {"nblks": HELP.get_nblks(a), "occ": HELP.get_occupation(a)}
    buf = np.zeros(6)
    out["block"] = (HELP.get_block(a, 0, 1, _addr(buf)), buf)
    t = HELP.transpose(a)
    c = HELP.multiply("N", "N", 1.0, a, t, 0.0, None, -1.0, 0)
    c = HELP.add(1.0, c, 0.5, HELP.scale(c, 2.0))
    c = HELP.filter_blocks(c, 1e-12)
    out["scalars"] = (HELP.trace(c), HELP.dot(c, c), HELP.norm_frobenius(c),
                      HELP.maxabs(c), HELP.checksum(c))
    return out


def test_legacy_helpers():
    got, ref = _legacy(THELP), _legacy(JHELP)
    assert got["nblks"] == ref["nblks"] == 3
    assert got["occ"] == ref["occ"]
    assert got["block"][0] == ref["block"][0] == (1, 2, 3)
    np.testing.assert_array_equal(got["block"][1], 2 * np.arange(6.0))
    np.testing.assert_allclose(got["scalars"], ref["scalars"], rtol=1e-12)


def test_statistics_and_callgraph(tmp_path, capsys):
    cell, _ = _mk(TH, "d")
    c = TH.create_template(cell, "C", None, "N", 0)
    TH.multiply("d", "N", "N", 1.0, 0.0, cell, cell, 0.0, 0.0, c, 0, -1.0)
    path = tmp_path / "graph.callgrind"
    TH.print_statistics(1, str(path))
    out = capsys.readouterr().out
    assert "multiplications" in out and "routine" in out
    assert "fn=multiply" in path.read_text()
    TH.clear_mempools()
    TH.mp_grid_setup(None)


# ---------------------------------------------------------------------------
# distributions: the grid asked for, on the shim's device
# ---------------------------------------------------------------------------

def _distributed_product(H, p, q):
    rbs = np.array([2, 3, 2, 3, 2, 3], dtype=np.int32)
    rd = (np.arange(6) % p).astype(np.int32)
    cd = (np.arange(6) % q).astype(np.int32)
    dist = H.distribution_new(0, _addr(rd), 6, _addr(cd), 6)
    a = H.create_new("A", dist, "N", _addr(rbs), 6, _addr(rbs), 6, 3)
    rng = np.random.default_rng(5)
    for i in range(6):
        for j in range(6):
            if (i + 2 * j) % 3:
                blk = np.ascontiguousarray(rng.standard_normal((rbs[i], rbs[j])))
                H.put_block2d(a, "d", i, j, _addr(blk), int(rbs[i]), int(rbs[j]), 0)
    H.finalize(a)
    c = H.create_template(a, "C", None, "N", 3)
    H.finalize(c)
    H.multiply("d", "N", "T", 1.0, 0.0, a, a, 0.0, 0.0, c, 0, -1.0)
    owner = H.get_stored_coordinates(a, 5, 4)
    got = H.get_distribution(c).obj
    return H.distribution_get(dist), owner, dense(H, a), dense(H, c), got


def test_distributed_handles_multiply_over_the_grid():
    got, ref = both(_distributed_product, 2, 2)
    assert got[0] == ref[0] == (2, 2, 6, 6)
    assert got[1] == ref[1] == (5 % 2) * 2 + 4 % 2
    close(got[3], ref[3])
    close(got[3], got[2] @ got[2].T)
    grid = got[4].grid
    assert grid.shape == (2, 2) and grid.unique_devices() == [torch.device("cpu")]


def test_grid_larger_than_the_jax_mesh_is_kept():
    """A 3×3 grid is 9 ranks: past the 8 devices of the JAX test mesh, the
    JAX shim collapses it to 1×1; the port's shim keeps 3×3 virtual ranks
    on its device. The product is the same either way."""
    got, ref = both(_distributed_product, 3, 3)
    assert got[0] == (3, 3, 6, 6)
    assert ref[0] == (1, 1, 6, 6)
    assert got[1] == 2 * 3 + 1 and ref[1] == 0
    close(got[3], ref[3])


def test_complete_redistribute_and_replicate():
    for H in (TH, JH):
        cell, _ = _mk(H, "d")
        rd = np.array([0, 1, 0, 1], dtype=np.int32)
        dist = H.distribution_new(0, _addr(rd), 4, _addr(rd), 4)
        moved = H.complete_redistribute(cell, dist)
        assert H.get_stored_coordinates(moved, 1, 1) == 3
        H.distribute(cell, dist)
        assert H.get_distribution(cell).obj is not None
        H.replicate_all(cell)
        H.sum_replicated(cell)
        assert H.get_stored_coordinates(cell, 1, 1) == -1
        np.testing.assert_array_equal(dense(H, moved), dense(H, cell))


def test_reserve_blocks_template_raises_in_jax_and_works_in_the_port():
    """``t_reserve_blocks_template`` iterates ``Tensor.block_indices``
    without calling it in the JAX shim (a TypeError); the port reserves the
    template's blocks."""
    def run(H):
        bs_i, bs_k, _, a_blocks, _ = _ab_blocks()
        del a_blocks[(1, 0)]
        src = _rank2_tensor(H, "S", bs_i, bs_k, a_blocks)
        dst = _rank2_tensor(H, "D", bs_i, bs_k, {})
        H.t_reserve_blocks_template(src, dst)
        return H.t_get_num_blocks(dst), tdense(H, dst)

    with pytest.raises(TypeError):
        run(JH)
    n, d = run(TH)
    assert n == 3 and not d.any()


# ---------------------------------------------------------------------------
# the device rule and the host mirror
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value,cuda,message", [
    (None, False, "DBCSR_CAPI_DEVICE"),
    ("cuda", False, "DBCSR_CAPI_DEVICE=cpu"),
    ("cuda:3", True, "only 1 CUDA devices"),
    ("tpu", False, "is not a device"),
    ("meta", False, "cuda or cpu"),
])
def test_device_rule(monkeypatch, value, cuda, message):
    if value is None:
        monkeypatch.delenv("DBCSR_CAPI_DEVICE")
    else:
        monkeypatch.setenv("DBCSR_CAPI_DEVICE", value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(DbcsrError, match=message):
        TH.init_lib(0, 0)


def test_nothing_runs_before_init(monkeypatch):
    monkeypatch.setattr(TH, "_device", None)
    rbs = np.array([2], dtype=np.int32)
    with pytest.raises(DbcsrError, match="c_dbcsr_init_lib"):
        TH.create_new("m", None, "N", _addr(rbs), 1, _addr(rbs), 1, 3)
    with pytest.raises(DbcsrError, match="c_dbcsr_init_lib"):
        THELP.create("m", _addr(rbs), 1, _addr(rbs), 1)


def test_cuda_names_a_card_when_one_is_there(monkeypatch):
    monkeypatch.setenv("DBCSR_CAPI_DEVICE", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert TH.device_from_env() == torch.device("cuda", 1)
    monkeypatch.setenv("DBCSR_CAPI_DEVICE", "cuda:0")
    assert TH.device_from_env() == torch.device("cuda", 0)


def test_pointer_returns_copy_from_a_host_mirror():
    cell, _ = _mk(TH, "d")
    m = TH._mat(cell)
    n = TH.get_data_size(cell)
    buf = np.zeros(n)
    assert TH.get_data(cell, "d", _addr(buf), n) == n
    np.testing.assert_array_equal(buf, m.flat_host())
    assert not np.shares_memory(cell.mirror, m.data.numpy())
    assert not np.shares_memory(cell.mirror, buf)
    buf[:] = 7.0  # the caller's buffer is its own
    np.testing.assert_array_equal(TH._mat(cell).flat_host(), cell.mirror)
    short = np.zeros(3)
    assert TH.get_data(cell, "d", _addr(short), 3) == n
    np.testing.assert_array_equal(short, cell.mirror[:3])
    blk = np.zeros(6)
    TH.get_block_p(cell, "d", 0, 1, _addr(blk))
    np.testing.assert_array_equal(blk, cell.mirror.reshape(-1))
    # the builder holds a copy of the caller's block, never the buffer
    src = np.ones((2, 2))
    b = TH.create_template(cell, "B", None, "N", 3)
    TH.put_block2d(b, "d", 0, 0, _addr(src), 2, 2, 0)
    src[:] = 5.0
    np.testing.assert_array_equal(TH._mat(b).get_block(0, 0), np.ones((2, 2)))
