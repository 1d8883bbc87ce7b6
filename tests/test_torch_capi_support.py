"""Port parity of what the C API shim needs below it: ``BCSRBuilder``'s
``reserve_block`` / ``reserve_blocks`` / ``reserve_all_blocks`` /
``reserve_diag_blocks`` and ``timings_report_callgraph``, against
dbcsr_tpu.

The reserved and put patterns come from one numpy description; the stores
are exact copies of host data (no arithmetic but the sum of two puts), so
the dense matrices, block counts and indices must be equal."""
import numpy as np
import pytest
import torch

import dbcsr_tpu as djax
from dbcsr_tpu.core import timing as jtiming

import dbcsr_tpu_torch as dtt
from dbcsr_tpu_torch.core import timing as ttiming

torch.set_num_threads(1)

SIZES = np.array([2, 3, 1, 4, 2], dtype=np.int32)


def _builders(sym, dtype):
    bj = djax.BCSRBuilder(SIZES, SIZES, dtype=dtype, sym=sym, tile=8)
    bt = dtt.BCSRBuilder(SIZES, SIZES, dtype=dtype, sym=sym, tile=8, device="cpu")
    return bj, bt


def _apply(b, steps):
    for op, *args in steps:
        getattr(b, op)(*args)
    return b.finalize()


def _same(mj, mt):
    for f in ("row_ptr", "col_idx", "blk_offset"):
        np.testing.assert_array_equal(getattr(mj.index, f), getattr(mt.index, f), err_msg=f)
    assert mj.nblks == mt.nblks
    np.testing.assert_array_equal(np.asarray(mj.to_dense()), mt.to_dense().numpy())


def _steps(sym, rng, dtype):
    n = len(SIZES)
    upper = [(i, j) for i in range(n) for j in range(n) if sym == "N" or i <= j]
    picks = [upper[k] for k in rng.choice(len(upper), size=6, replace=False)]
    put = picks[:3]
    blk = lambda i, j: rng.standard_normal((SIZES[i], SIZES[j])).astype(dtype)  # noqa: E731
    rows = np.array([p[0] for p in picks[2:]], dtype=np.int32)
    cols = np.array([p[1] for p in picks[2:]], dtype=np.int32)
    return [
        ("put_block", put[0][0], put[0][1], blk(*put[0])),
        ("put_block", put[1][0], put[1][1], blk(*put[1])),
        # reserving a block that is already staged keeps its data
        ("reserve_block", put[0][0], put[0][1]),
        ("reserve_blocks", rows, cols),
        # a put after the reservation overwrites the zeros
        ("put_block", put[2][0], put[2][1], blk(*put[2])),
        ("reserve_diag_blocks",),
    ]


@pytest.mark.parametrize("sym", ["N", "S"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.complex128])
def test_reserve_and_put_pattern_matches(sym, dtype):
    steps = _steps(sym, np.random.default_rng(7), dtype)
    bj, bt = _builders(sym, dtype)
    mj, mt = _apply(bj, steps), _apply(bt, steps)
    _same(mj, mt)
    assert mt.dtype == dtt.block.bcsr.torch_dtype(dtype)
    # the reserved blocks not put are stored, as zeros
    r, c = steps[3][1][-1], steps[3][2][-1]
    if (r, c) not in [(s[1], s[2]) for s in steps if s[0] == "put_block"]:
        assert mt.get_block(int(r), int(c)) is not None
        assert not mt.get_block(int(r), int(c)).any()


@pytest.mark.parametrize("sym", ["N", "S"])
def test_reserve_all_blocks_matches(sym):
    bj, bt = _builders(sym, np.float64)
    blk = np.arange(6, dtype=np.float64).reshape(2, 3)
    for b in (bj, bt):
        b.put_block(0, 1, blk)
        b.reserve_all_blocks()
        b.put_block(0, 1, blk, sum=True)  # sums into the staged block
    mj, mt = bj.finalize(), bt.finalize()
    _same(mj, mt)
    n = len(SIZES)
    assert mt.nblks == (n * n if sym == "N" else n * (n + 1) // 2)
    np.testing.assert_array_equal(mt.get_block(0, 1), 2 * blk)


def test_symmetric_builder_refuses_a_lower_reservation():
    for b in _builders("S", np.float64):
        with pytest.raises(ValueError):
            b.reserve_block(3, 1)


def _timed_tree(timing):
    timing.reset_timers()
    with timing.timed("outer"):
        for _ in range(2):
            with timing.timed("inner_a"):
                with timing.timed("leaf"):
                    pass
        with timing.timed("inner_b"):
            pass


def _callgraph_names(path):
    fns, cfns, calls = set(), set(), []
    current = None
    with open(path) as f:
        for line in f:
            if line.startswith("fn="):
                current = line[3:].strip()
                fns.add(current)
            elif line.startswith("cfn="):
                cfns.add((current, line[4:].strip()))
            elif line.startswith("calls="):
                calls.append(int(line.split("=")[1].split()[0]))
    return fns, cfns, calls


def test_callgraph_file_names_the_same_timers(tmp_path):
    _timed_tree(jtiming)
    _timed_tree(ttiming)
    pj, pt = tmp_path / "jax.callgrind", tmp_path / "torch.callgrind"
    jtiming.timings_report_callgraph(str(pj))
    ttiming.timings_report_callgraph(str(pt))
    got, ref = _callgraph_names(pt), _callgraph_names(pj)
    assert got == ref
    assert got[0] == {"outer", "inner_a", "inner_b", "leaf"}
    assert ("outer", "inner_a") in got[1] and ("inner_a", "leaf") in got[1]
    assert sorted(got[2]) == [1, 2, 2]
    assert pt.read_text().splitlines()[1] == "events: Walltime_us"


def test_reset_timers_clears_the_call_graph(tmp_path):
    _timed_tree(ttiming)
    ttiming.reset_timers()
    path = tmp_path / "empty.callgrind"
    ttiming.timings_report_callgraph(str(path))
    assert _callgraph_names(path) == (set(), set(), [])
