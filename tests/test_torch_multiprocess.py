"""The port's multi-process battery: ``init_lib(distributed=True)`` over
``torch.distributed`` (``gloo``, a ``file://`` rendezvous in the test's
own directory, so parallel test workers never race for a port), the JAX
package's ten scenarios of ``tests/mp_worker.py`` across real process
boundaries, plus the self-test ``testing.test_dist`` and checks of the
transport and the logger (``tests/torch_mp_worker.py``).

The inputs are made here in the JAX package from seeds and handed to the
workers as numpy arrays, with the JAX package's result of each scenario.
Every worker holds each scenario's result bitwise against the port's
single-process virtual-rank run on the same grid and within 1e-5 (float32)
or 1e-12 (float64, complex128) of the largest entry of the JAX result;
plan hashes must agree across processes. Process counts 2 (the scenarios
in three launches, as ``tests/test_multiprocess.py``), 1 and 4; each
launch runs once, and each (launch, scenario) is a test case. A worker is
joined with a timeout of its own and all are killed when one fails.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import dbcsr_tpu as djax
import dbcsr_tpu.tensors as jten
from dbcsr_tpu.core.config import config_override as jax_override

import dbcsr_tpu_torch as dtt
from dbcsr_tpu_torch.core.errors import DbcsrError
from dbcsr_tpu_torch.dist import comm

T = 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_mp_worker.py")
#: each worker's own limit: a hang fails fast, well inside the suite's limit
JOIN_TIMEOUT = 120

BATTERIES = {
    "2proc-mesh": (2, ("cannon", "summa", "cannon25d", "summa25d", "comm")),
    "2proc-storage": (2, ("tas", "sharded", "sharded_elementwise", "checkpoint",
                          "logger")),
    "2proc-tensor": (2, ("tensor", "complex", "selftest")),
    "1proc": (1, ("cannon", "sharded", "checkpoint", "tas", "comm")),
    "4proc": (4, ("cannon", "summa", "cannon25d", "summa25d", "sharded", "checkpoint",
                  "tas", "sharded_elementwise", "complex", "comm")),
}
CASES = [(b, s) for b, (_, names) in BATTERIES.items() for s in names]


# ---------------------------------------------------------------------------
# inputs and JAX references (the worker's scenarios, made in the JAX package)
# ---------------------------------------------------------------------------

def _put(out: dict, prefix: str, m) -> None:
    out[f"{prefix}_rbs"] = np.asarray(m.row_block_sizes)
    out[f"{prefix}_cbs"] = np.asarray(m.col_block_sizes)
    out[f"{prefix}_rows"] = np.asarray(m.index.blk_rows)
    out[f"{prefix}_cols"] = np.asarray(m.index.col_idx)
    out[f"{prefix}_data"] = np.asarray(m.data)


def _mats(rng, square=False, dtype=np.float32, nblk=48, sizes=(3, 5)):
    rbs = djax.random_block_sizes(nblk, list(sizes), rng)
    if square:
        return (djax.random_matrix(rbs, rbs, 0.5, rng, dtype=dtype, name="A"),
                djax.random_matrix(rbs, rbs, 0.5, rng, dtype=dtype, name="B"))
    cbs = djax.random_block_sizes(40, [4], rng)
    return (djax.random_matrix(rbs, cbs, 0.4, rng, dtype=dtype, name="A"),
            djax.random_matrix(cbs, rbs, 0.4, rng, dtype=dtype, name="B"))


def _dense(m):
    return np.asarray(m.to_dense())


def _product_case(seed, keys, square=False):
    a, b = _mats(np.random.default_rng(seed), square=square)
    c = _dense(djax.multiply("N", "N", 1.0, a, b))
    inputs = {}
    _put(inputs, "a", a)
    _put(inputs, "b", b)
    return inputs, {k: c for k in keys}


def _elementwise_case():
    a, b = _mats(np.random.default_rng(6), square=True)
    ad, bd = _dense(a), _dense(b)
    inputs = {}
    _put(inputs, "a", a)
    _put(inputs, "b", b)
    fro_tr = np.array([np.linalg.norm(ad.astype(np.float64)),
                       np.trace(ad.astype(np.float64))], dtype=np.float32)
    return inputs, {"half": 0.5 * ad, "hadamard": ad * bd, "fro_trace": fro_tr}


def _checkpoint_case():
    a, _ = _mats(np.random.default_rng(7), square=True)
    inputs = {}
    _put(inputs, "a", a)
    return inputs, {"a": _dense(a)}


def _tensor_case():
    rng = np.random.default_rng(8)
    bs_i, bs_j = np.asarray([3] * 16, np.int32), np.asarray([3] * 4, np.int32)
    bs_k, bs_l = np.asarray([3] * 12, np.int32), np.asarray([3] * 10, np.int32)
    tb = jten.TensorBuilder([bs_i, bs_j, bs_k], jten.NDMapping(3, (0, 1), (2,)),
                            dtype=np.float64)
    for bi in np.ndindex(16, 4, 12):
        if rng.random() < 0.25:
            tb.put_block(bi, rng.standard_normal((3, 3, 3)))
    mb = jten.TensorBuilder([bs_k, bs_l], dtype=np.float64)
    for bi in np.ndindex(12, 10):
        if rng.random() < 0.5:
            mb.put_block(bi, rng.standard_normal((3, 3)))
    t, m = tb.finalize(), mb.finalize()
    out = jten.contract(1.0, t, m, contract_1=(2,), notcontract_1=(0, 1),
                        contract_2=(0,), notcontract_2=(1,))
    inputs = {}
    for p, x in (("t", t), ("m", m)):
        inputs[f"{p}_ndim"] = np.int64(len(x.block_sizes))
        for d, bs in enumerate(x.block_sizes):
            inputs[f"{p}_bs{d}"] = np.asarray(bs)
        inputs[f"{p}_map1"] = np.asarray(x.mapping.map1)
        inputs[f"{p}_map2"] = np.asarray(x.mapping.map2)
        inputs[f"{p}_rows"] = np.asarray(x.matrix.index.blk_rows)
        inputs[f"{p}_cols"] = np.asarray(x.matrix.index.col_idx)
        inputs[f"{p}_flat"] = np.asarray(x.matrix.flat_host())
    return inputs, {"out": np.asarray(out.to_dense())}


def _complex_case():
    rng = np.random.default_rng(9)
    rbs = djax.random_block_sizes(36, [3], rng)
    a = djax.random_matrix(rbs, rbs, 0.5, rng, dtype=np.complex128, name="A")
    b = djax.random_matrix(rbs, rbs, 0.5, rng, dtype=np.complex128, name="B")
    c = _dense(djax.multiply("C", "N", 1.0 + 0.5j, a, b))
    inputs = {}
    _put(inputs, "a", a)
    _put(inputs, "b", b)
    return inputs, {"c": c, "fro": np.array([np.linalg.norm(_dense(a))])}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """Every scenario's inputs and the JAX package's results, made once."""
    d = tmp_path_factory.mktemp("mp_data")
    mults = ("c", "c_exec")
    with jax_override(tile_size=T, f64_method="native"):
        cases = {
            "cannon": _product_case(0, mults),
            "summa": _product_case(1, mults),
            "cannon25d": _product_case(2, mults),
            "summa25d": _product_case(3, mults),
            "tas": _product_case(4, ("c", "c_k", "c_subgrid")),
            "sharded": _product_case(0, ("c",), square=True),
            "sharded_elementwise": _elementwise_case(),
            "checkpoint": _checkpoint_case(),
            "tensor": _tensor_case(),
            "complex": _complex_case(),
        }
    for name, (inputs, refs) in cases.items():
        np.savez(d / f"inputs_{name}.npz", **inputs)
        np.savez(d / f"ref_{name}.npz", **refs)
    return d


# ---------------------------------------------------------------------------
# launches
# ---------------------------------------------------------------------------

def run_workers(nprocs, names, data: str, out: str) -> list:
    """Start ``nprocs`` workers on a ``file://`` rendezvous in ``out``;
    join each with its own timeout, kill all on the first failure. Returns
    the workers' outputs; raises on a failure or a timeout."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    url = "file://" + os.path.join(out, "rendezvous")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, url, str(pid), str(nprocs), data, out, ",".join(names)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    ) for pid in range(nprocs)]
    outs = [None] * nprocs
    try:
        for pid, p in enumerate(procs):
            outs[pid], _ = p.communicate(timeout=JOIN_TIMEOUT)
            if p.returncode != 0:
                raise AssertionError(f"worker {pid} failed (rc {p.returncode}):\n"
                                     f"{outs[pid][-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    return outs


_RESULTS: dict = {}


def battery(name: str, data_dir, tmp_path_factory) -> list:
    """The reports of battery ``name`` (launched once for all its cases)."""
    if name not in _RESULTS:
        nprocs, names = BATTERIES[name]
        out = tmp_path_factory.mktemp(name)
        t0 = time.perf_counter()
        try:
            run_workers(nprocs, names, str(data_dir), str(out))
            reports = [json.loads((out / f"report_{pid}.json").read_text())
                       for pid in range(nprocs)]
            _RESULTS[name] = (reports, time.perf_counter() - t0)
        except Exception as e:  # every case of the launch reports the failure
            _RESULTS[name] = e
    got = _RESULTS[name]
    if isinstance(got, Exception):
        raise got
    return got[0]


@pytest.mark.parametrize("name,scenario", CASES, ids=[f"{b}-{s}" for b, s in CASES])
def test_battery(data_dir, tmp_path_factory, name, scenario):
    reports = battery(name, data_dir, tmp_path_factory)
    for pid, rep in enumerate(reports):
        assert "_error" not in rep, rep["_error"]
        assert rep["_finalized"], f"process {pid}: finalize_lib left the group up"
        r = rep[scenario]
        assert not r["not_bitwise"], (
            f"process {pid}: {scenario} differs from the single-process run in "
            f"{r['not_bitwise']}")
        for k, (err, bound) in r["errors"].items():
            assert err <= bound, f"process {pid}: {scenario}/{k} rel {err:.2e} > {bound:.0e}"
        assert r["ok"]
    # plan determinism across processes
    hashes = {rep[scenario].get("plan_hash") for rep in reports}
    assert len(hashes) == 1, hashes
    # across processes pieces really moved, and every byte sent was received
    moved = np.array([rep[scenario]["moved"] for rep in reports])
    assert moved[:, 1].sum() == moved[:, 2].sum()
    if len(reports) > 1 and scenario not in ("logger", "selftest"):
        assert (moved[:, 0] > 0).all(), moved
    if scenario == "sharded":
        # each shard lives on exactly one process (round-robin over the plane)
        held = np.array([rep["sharded"]["held_shards"] for rep in reports])
        assert (held.sum(axis=0) == 1).all(), held
    if scenario == "logger":
        assert [rep["logger"]["printed"] for rep in reports] == [
            [pid == 0, pid == 1] for pid in range(len(reports))]


# ---------------------------------------------------------------------------
# bring-up arguments, in this process (nothing is started)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("address,url", [
    ("127.0.0.1:29500", "tcp://127.0.0.1:29500"),
    ("node-a:1234", "tcp://node-a:1234"),
    ("tcp://10.0.0.1:7000", "tcp://10.0.0.1:7000"),
    ("file:///tmp/rdzv", "file:///tmp/rdzv"),
    (None, "env://"),
])
def test_init_method(address, url):
    assert comm.init_method(address) == url


@pytest.mark.parametrize("address", ["node-a", "node-a:port", "udp://x:1"])
def test_init_method_rejects(address):
    with pytest.raises(DbcsrError):
        comm.init_method(address)


def test_nccl_on_cpu_raises():
    """nccl with a CPU device raises before any rendezvous and names gloo;
    the backend is never switched by itself."""
    with pytest.raises(DbcsrError, match='backend="gloo"'):
        dtt.init_lib(distributed=True, coordinator_address="127.0.0.1:1",
                     num_processes=2, process_id=0, backend="nccl", device="cpu")
    assert not comm.is_up()


def test_no_cuda_raises(monkeypatch):
    """Without CUDA and without an explicit "cpu" the process's device
    raises, as ``ProcessGrid.make`` does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DbcsrError, match="device='cpu'"):
        dtt.init_lib(distributed=True, coordinator_address="127.0.0.1:1",
                     num_processes=2, process_id=0)
    with pytest.raises(DbcsrError, match="device='cpu'"):
        comm.process_device("cuda", 0)
    assert comm.process_device("cpu", 3) == torch.device("cpu")
    assert not comm.is_up()


def test_duplicate_cards():
    """The check behind nccl's refusal of two processes on one card."""
    assert comm.duplicate_cards(["GPU-a", "GPU-b", "GPU-c"]) is None
    assert comm.duplicate_cards(["GPU-a", "GPU-b", "GPU-a"]) == (0, 2)


def test_no_world_means_one_process():
    """Without a world: rank 0 of 1, every grid cell on process 0, the
    logger prints, finalize_lib is safe, and a transfer between processes
    refuses."""
    import io

    from dbcsr_tpu_torch.core.logging import Logger

    assert (comm.rank(), comm.world_size(), comm.is_up()) == (0, 1, False)
    g = dtt.dist.ProcessGrid.make(2, 2, 2, devices=[torch.device("cpu")] * 8)
    assert g.owner_list() == [0] * 8 and len(g.local_ranks()) == 8
    buf = io.StringIO()
    Logger(stream=buf).note("x")
    assert "x" in buf.getvalue()
    with pytest.raises(DbcsrError, match="distributed"):
        comm.exchange([(0, 1, (1,), torch.float32)], lambda i: torch.zeros(1))
