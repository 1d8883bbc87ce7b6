"""Port parity of matrix I/O and CSR exchange against dbcsr_tpu: binary
checkpoints (byte for byte, read across packages, bfloat16 read back,
corrupt and truncated files refused), the element CSR conversions and the
coordinate text dump, the printers, ``get_info``, ``verify_matrix`` and
both checksums (bitwise: the port computes them on the host in float64 as
the JAX package does, from the same flat data).

One numpy description feeds both packages. Every comparison here is exact:
no arithmetic differs between the two sides.
"""
import io
import json
import struct
from contextlib import ExitStack

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import dbcsr_tpu as djax
from dbcsr_tpu.core.config import config_override as jax_override

import dbcsr_tpu_torch as dtt
from dbcsr_tpu_torch.core.config import config_override as torch_override
from dbcsr_tpu_torch.core.errors import DbcsrError

torch.set_num_threads(1)

DTYPES = {"float32": (np.float32, torch.float32), "float64": (np.float64, torch.float64),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def both(tile):
    es = ExitStack()
    es.enter_context(jax_override(tile_size=tile))
    es.enter_context(torch_override(tile_size=tile))
    return es


def pair(dtype="float64", sym="N", nb=14, occ=0.4, seed=0, tile=8, name="M"):
    """The same random matrix in both packages (symmetric: upper triangle)."""
    rng = np.random.default_rng(seed)
    rbs = rng.choice([2, 3, 5], nb).astype(np.int32)
    mask = rng.random((nb, nb)) < occ
    if sym != "N":
        mask = np.triu(mask)
    rows, cols = np.nonzero(mask)
    blocks = []
    for r, c in zip(rows, cols):
        blk = rng.standard_normal((rbs[r], rbs[c]))
        if sym != "N" and r == c:
            blk = 0.5 * (blk + blk.T)
        blocks.append(blk.astype(np.float32 if dtype == "bfloat16" else dtype))
    jd, td = DTYPES[dtype]
    with both(tile):
        mj = djax.BCSRMatrix.from_blocks(rows, cols, blocks, rbs, rbs, dtype=jd, sym=sym,
                                         name=name)
        mt = dtt.BCSRMatrix.from_blocks(rows, cols, blocks, rbs, rbs, dtype=td, sym=sym,
                                        name=name, device="cpu")
    return mj, mt


def same_matrix(mt, mj):
    """Index, symmetry, name and flat data (bitwise) of a port matrix equal a
    JAX matrix's."""
    for f in ("row_block_sizes", "col_block_sizes", "row_ptr", "col_idx", "blk_offset"):
        np.testing.assert_array_equal(getattr(mt.index, f), getattr(mj.index, f))
    assert (mt.sym, mt.name) == (mj.sym, mj.name)
    np.testing.assert_array_equal(mt.flat_host(), np.asarray(mj.flat_host(), np.float64)
                                  .astype(mt.flat_host().dtype))


# ---------------------------------------------------------------------------
# binary checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sym", ["N", "S"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_checkpoint_bytes_equal_jax(tmp_path, dtype, sym):
    mj, mt = pair(dtype, sym, seed=1)
    djax.binary_write(mj, str(tmp_path / "jax.bin"))
    dtt.binary_write(mt, str(tmp_path / "port.bin"))
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()


@pytest.mark.parametrize("tile", [8, 16])
@pytest.mark.parametrize("sym", ["N", "S"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_checkpoints_cross_read(tmp_path, dtype, sym, tile):
    mj, mt = pair(dtype, sym, seed=2, tile=tile, name="scf_density")
    djax.binary_write(mj, str(tmp_path / "jax.bin"))
    dtt.binary_write(mt, str(tmp_path / "port.bin"))
    with both(tile):
        from_jax = dtt.binary_read(str(tmp_path / "jax.bin"), device="cpu")
        from_port = djax.binary_read(str(tmp_path / "port.bin"))
        renamed = dtt.binary_read(str(tmp_path / "port.bin"), device="cpu", name="P")
    same_matrix(from_jax, mj)
    assert torch.equal(from_jax.data, mt.data) and from_jax.dtype == mt.dtype
    same_matrix(mt, from_port)
    np.testing.assert_array_equal(mt.data.numpy(), np.asarray(from_port.data))
    assert renamed.name == "P" and torch.equal(renamed.data, mt.data)


@pytest.mark.parametrize("sym", ["N", "S"])
def test_bf16_checkpoint_reads_back_as_bf16(tmp_path, sym):
    mj, mt = pair("bfloat16", sym, seed=3)
    djax.binary_write(mj, str(tmp_path / "jax.bin"))
    dtt.binary_write(mt, str(tmp_path / "port.bin"))
    with both(8):
        for path in ("jax.bin", "port.bin"):
            got = dtt.binary_read(str(tmp_path / path), device="cpu")
            assert got.dtype == torch.bfloat16 and got.sym == sym
            assert torch.equal(got.data.view(torch.int16), mt.data.view(torch.int16))
    # the fault the port repairs: the JAX package cannot read its own file
    with pytest.raises(TypeError, match="V2"):
        djax.binary_read(str(tmp_path / "jax.bin"))


def write_port(tmp_path, **kw):
    _, mt = pair("float64", seed=4, **kw)
    path = tmp_path / "m.bin"
    dtt.binary_write(mt, str(path))
    return path, path.read_bytes()


@pytest.mark.parametrize("cut", [5, 14, 20, 40, 200, -8, -1])
def test_truncated_checkpoint_rejected(tmp_path, cut):
    path, raw = write_port(tmp_path)
    path.write_bytes(raw[:cut])
    with pytest.raises(DbcsrError):
        dtt.binary_read(str(path), device="cpu")


MESSAGES = {"magic": "not a dbcsr_tpu checkpoint", "version": "newer",
            "header": "header", "descriptor": "descriptor", "size": "negative",
            "nblks": "mismatch"}


@pytest.mark.parametrize("fault", list(MESSAGES))
def test_corrupt_checkpoint_rejected(tmp_path, fault):
    path, raw = write_port(tmp_path)
    hlen = struct.unpack("<q", raw[17:25])[0]
    rec = 25 + hlen  # first array record: flag, 16-byte descriptor, size
    b = bytearray(raw)
    if fault == "magic":
        b[0:5] = b"XXXXX"
    elif fault == "version":
        b[13:17] = struct.pack("<i", 99)
    elif fault == "header":
        b[25] = ord("#")
    elif fault == "descriptor":
        b[rec + 1:rec + 17] = b"\xff" * 16
    elif fault == "size":
        b[rec + 17:rec + 25] = struct.pack("<q", -3)
    elif fault == "nblks":  # a well-formed header that disagrees with the index
        header = json.loads(raw[25:25 + hlen])
        header["nblks"] += 1
        h = json.dumps(header).encode()
        b = bytearray(raw[:17] + struct.pack("<q", len(h)) + h + raw[25 + hlen:])
    path.write_bytes(bytes(b))
    with pytest.raises(DbcsrError, match=MESSAGES[fault]):
        dtt.binary_read(str(path), device="cpu")


def test_checkpoint_refuses_complex_and_dist(tmp_path):
    _, mt = pair("float64", seed=5)
    # complex is ported since: a complex store writes and reads back bitwise
    mc = mt.with_data(mt.data.to(torch.complex128) * (1 - 2j))
    dtt.binary_write(mc, str(tmp_path / "c"))
    with torch_override(tile_size=8):
        back = dtt.binary_read(str(tmp_path / "c"), device="cpu")
    assert back.dtype == torch.complex128 and torch.equal(back.data, mc.data)
    # dist is ported since: the read attaches it
    from dbcsr_tpu_torch.dist import ProcessGrid, block_cyclic_dist

    dtt.binary_write(mt, str(tmp_path / "m.bin"))
    d = block_cyclic_dist(ProcessGrid.make(2, 2, devices=["cpu"] * 4), mt.nblkrows,
                          mt.nblkcols)
    with torch_override(tile_size=8):
        back = dtt.binary_read(str(tmp_path / "m.bin"), device="cpu", dist=d)
    assert back.dist is d and torch.equal(back.data, mt.data)


# ---------------------------------------------------------------------------
# CSR exchange
# ---------------------------------------------------------------------------

def same_csr(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_array_equal(got.indptr, ref.indptr)
    np.testing.assert_array_equal(got.indices, ref.indices)
    np.testing.assert_array_equal(got.data, ref.data)


@pytest.mark.parametrize("sym", ["N", "S"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_to_csr_matches_jax(dtype, sym):
    mj, mt = pair(dtype, sym, seed=6)
    same_csr(dtt.to_csr(mt), djax.to_csr(mj))
    for eps in (0.5, 2.0, 4.0):
        same_csr(dtt.to_csr_filter(mt, eps), djax.to_csr_filter(mj, eps))


def test_to_csr_of_an_empty_matrix():
    rbs = np.array([2, 3], np.int32)
    with both(8):
        mj = djax.BCSRMatrix.from_blocks([], [], [], rbs, rbs, dtype=np.float64)
        mt = dtt.BCSRMatrix.from_blocks([], [], [], rbs, rbs, dtype=np.float64, device="cpu")
    same_csr(dtt.to_csr(mt), djax.to_csr(mj))


def random_csr(seed, n=40, m=33, density=0.08, dtype=np.float64):
    rng = np.random.default_rng(seed)
    csr = sp.random(n, m, density=density, format="csr", random_state=rng, dtype=dtype)
    # explicit zeros: stored entries of value 0 must still make their block
    csr.data[rng.random(csr.nnz) < 0.2] = 0.0
    return csr


@pytest.mark.parametrize("keep", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_from_csr_matches_jax(dtype, keep):
    rng = np.random.default_rng(7)
    csr = random_csr(8, dtype=dtype)
    rbs = np.array([5, 3, 7, 2, 9, 4, 6, 4], np.int32)  # 40 rows
    cbs = np.array([4, 6, 5, 3, 8, 7], np.int32)  # 33 cols
    assert rbs.sum() == 40 and cbs.sum() == 33 and rng is not None
    with both(8):
        mj = djax.from_csr(csr, rbs, cbs, keep_zero_blocks=keep, name="X")
        mt = dtt.from_csr(csr, rbs, cbs, keep_zero_blocks=keep, name="X", device="cpu")
    same_matrix(mt, mj)
    assert mt.dtype == dtt.block.bcsr.torch_dtype(dtype)
    if keep:
        assert mt.nblks == len(rbs) * len(cbs)


def test_from_csr_explicit_zero_makes_a_block():
    csr = sp.csr_matrix((np.array([0.0, 1.5]), np.array([0, 4]), np.array([0, 1, 1, 2])),
                        shape=(3, 5))
    rbs, cbs = np.array([1, 2], np.int32), np.array([2, 3], np.int32)
    with both(8):
        mj = djax.from_csr(csr, rbs, cbs)
        mt = dtt.from_csr(csr, rbs, cbs, device="cpu")
    same_matrix(mt, mj)
    assert mt.nblks == 2 and mt.get_block(0, 0) is not None


def test_from_csr_sums_duplicates_like_jax():
    rows = np.array([0, 0, 3, 3, 3, 7])
    cols = np.array([1, 1, 2, 2, 9, 0])
    vals = np.array([1.0, 2.0, -1.0, 0.5, 4.0, 3.0])
    coo = sp.coo_matrix((vals, (rows, cols)), shape=(8, 10))
    csr = sp.csr_matrix((coo.data, coo.col, np.searchsorted(coo.row, np.arange(9))),
                        shape=(8, 10))
    assert not csr.has_canonical_format
    before = csr.data.copy()
    rbs, cbs = np.array([3, 5], np.int32), np.array([4, 6], np.int32)
    with both(8):
        mj = djax.from_csr(csr, rbs, cbs)
        mt = dtt.from_csr(csr, rbs, cbs, device="cpu")
    same_matrix(mt, mj)
    np.testing.assert_array_equal(csr.data, before)  # the caller's matrix is untouched


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_csr_round_trip(dtype):
    mj, mt = pair(dtype, seed=9)
    with both(8):
        back = dtt.from_csr(dtt.to_csr(mt), mt.row_block_sizes, mt.col_block_sizes,
                            name="M", device="cpu")
    same_matrix(back, mj)
    assert torch.equal(back.data, mt.data)


def test_from_csr_refuses_bad_shape_and_dist():
    csr = random_csr(10)
    with pytest.raises(DbcsrError, match="shape"):
        dtt.from_csr(csr, [20, 19], [33], device="cpu")
    # dist is ported since: the result carries it
    from dbcsr_tpu_torch.dist import ProcessGrid, block_cyclic_dist

    d = block_cyclic_dist(ProcessGrid.make(2, 2, devices=["cpu"] * 4), 2, 1)
    assert dtt.from_csr(csr, [20, 20], [33], device="cpu", dist=d).dist is d


@pytest.mark.parametrize("threshold", [None, 0.5])
def test_csr_write_text_equals_jax(tmp_path, threshold):
    csr = random_csr(11)
    a, b = io.StringIO(), io.StringIO()
    djax.csr_write(csr, a, threshold=threshold)
    dtt.csr_write(csr, b, threshold=threshold)
    assert a.getvalue() == b.getvalue() and a.getvalue().startswith("% 40 33")
    djax.csr_write(csr, str(tmp_path / "j.txt"))
    dtt.csr_write(csr, str(tmp_path / "t.txt"))
    assert (tmp_path / "j.txt").read_text() == (tmp_path / "t.txt").read_text()


# ---------------------------------------------------------------------------
# printers, info, verification, checksums
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sym", ["N", "S"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_printers_match_jax(dtype, sym):
    mj, mt = pair(dtype, sym, seed=12)
    for kw in ({}, {"max_blocks": 3}, {"values": False}):
        a, b = io.StringIO(), io.StringIO()
        djax.print_matrix(mj, a, **kw)
        dtt.print_matrix(mt, b, **kw)
        assert a.getvalue() == b.getvalue(), kw
    a, b = io.StringIO(), io.StringIO()
    djax.print_block_sum(mj, a)
    dtt.print_block_sum(mt, b)
    assert a.getvalue() == b.getvalue()


@pytest.mark.parametrize("sym", ["N", "S"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_info_and_coordinates_match_jax(dtype, sym):
    mj, mt = pair(dtype, sym, seed=13)
    ij, it = djax.get_info(mj), dtt.get_info(mt)
    assert ij.keys() == it.keys()
    for k in ij:
        if isinstance(ij[k], np.ndarray):
            np.testing.assert_array_equal(it[k], ij[k])
        else:
            assert it[k] == ij[k], k
    assert it["dtype"] == dtype
    for r, c in ((0, 0), (3, 5), (13, 1)):
        assert dtt.get_stored_coordinates(mt, r, c) == djax.get_stored_coordinates(mj, r, c)


@pytest.mark.parametrize("sym", ["N", "S"])
def test_verify_matrix(sym):
    mj, mt = pair("float64", sym, seed=14)
    assert dtt.verify_matrix(mt) is True and djax.verify_matrix(mj) is True
    lay = mt.layout
    bad = mt.data.clone()
    # one padding element of the first tile that no block covers
    from dbcsr_tpu_torch.block.tileops import valid_mask

    pad = (valid_mask(mt.index, mt.tile, mt.device) < 0.5).nonzero()
    assert len(pad) and lay.n_tiles
    bad[tuple(pad[0])] = 1.0
    with pytest.raises(DbcsrError, match="padding"):
        dtt.verify_matrix(mt.with_data(bad))


@pytest.mark.parametrize("sym", ["N", "S"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_checksums_bitwise_equal_jax(dtype, sym):
    mj, mt = pair(dtype, sym, seed=15)
    for pos in (False, True):
        assert dtt.checksum(mt, pos=pos) == djax.checksum(mj, pos=pos)
