"""Port parity of the ``.perf`` driver, the built-in self-tests, the logger
stack and the machine helpers against dbcsr_tpu.

``parse_perf`` must read every shipped recipe field by field as the JAX
package's parser does. ``run_perf`` draws the same matrices from the same
seed in both packages (the port's random generators are the JAX package's
streams), so its position-weighted checksum agrees with the JAX package's
to float64 rounding of the product (relative 1e-12: the same float64
products summed in another order; the JAX side runs native float64).
"""
import dataclasses
import glob
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import dbcsr_tpu as djax
from dbcsr_tpu import perf as jax_perf
from dbcsr_tpu import testing as jax_testing
from dbcsr_tpu.core.config import config_override as jax_override

import dbcsr_tpu_torch as dtt
from dbcsr_tpu_torch import perf, testing
from dbcsr_tpu_torch.autotune import steady_state_time
from dbcsr_tpu_torch.core import logging as tlog
from dbcsr_tpu_torch.core import machine

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
RECIPES = sorted(glob.glob(os.path.join(HERE, "inputs", "*.perf")))
CPU = torch.device("cpu")


def test_ten_recipes_ship():
    assert len(RECIPES) == 10


@pytest.mark.parametrize("path", RECIPES, ids=os.path.basename)
def test_parse_perf_matches_jax(path):
    got, ref = perf.parse_perf(path), jax_perf.parse_perf(path)
    fields = [f.name for f in dataclasses.fields(ref)]
    assert [f.name for f in dataclasses.fields(got)] == fields
    for f in fields:
        assert getattr(got, f) == getattr(ref, f), f
    for sizes, total in ((got.m_blocks, got.m), (got.n_blocks, got.n), (got.k_blocks, got.k)):
        np.testing.assert_array_equal(perf._block_sizes(total, sizes),
                                      jax_perf._block_sizes(total, sizes))


@pytest.mark.parametrize("name", ["singleblock", "square_dense", "mixed_blocks"])
def test_run_perf_checksum_matches_jax(name):
    cfg = perf.parse_perf(os.path.join(HERE, "inputs", f"{name}.perf"))
    cfg = dataclasses.replace(cfg, nrep=1)
    with jax_override(f64_method="native"):
        ref = jax_perf.run_perf(jax_perf.PerfConfig(**dataclasses.asdict(cfg)), seed=0,
                                verbose=False)
    got = perf.run_perf(cfg, device=CPU, seed=0, verbose=False)
    assert abs(got["checksum"] - ref["checksum"]) <= 1e-12 * abs(ref["checksum"])
    assert got["eff_flops_per_mult"] == ref["eff_flops_per_mult"]
    assert got["checksum_match"] == ref["checksum_match"] is True
    assert got["n_devices"] == 1 and got["nrep"] == 1
    assert got["route"] is not None and got["steady_time_s"] > 0
    assert got["flops_per_s_steady"] > 0


def test_run_perf_limits_and_float32():
    """A recipe with element limits on all three dimensions (block-aligned)
    in float32 runs the limited multiply; its checksum agrees with the JAX
    package's (float32 on both sides: relative 2e-5)."""
    cfg = perf.parse_perf(os.path.join(HERE, "inputs", "square_dense.perf"))
    cfg = dataclasses.replace(cfg, data_type=1, nrep=1, lim_row=(6, 50),
                              lim_col=(1, 95), lim_k=(11, 100))
    with jax_override(f64_method="native", matmul_precision="highest"):
        ref = jax_perf.run_perf(jax_perf.PerfConfig(**dataclasses.asdict(cfg)), seed=3,
                                verbose=False)
    with dtt.config_override(matmul_precision="highest"):
        got = perf.run_perf(cfg, device=CPU, seed=3, verbose=False)
    assert abs(got["checksum"] - ref["checksum"]) <= 2e-5 * abs(ref["checksum"])
    with pytest.raises(ValueError, match="aligned"):
        perf.run_perf(dataclasses.replace(cfg, lim_row=(2, 50)), device=CPU, verbose=False)


@pytest.mark.parametrize("data_type", [5, 7])
def test_run_perf_complex_raises(data_type):
    # complex recipes are ported since: they run, in their complex type, and
    # match the JAX package's checksum (tests/test_torch_complex.py holds a
    # sparse recipe of data type 7 to its driver too)
    cfg = dataclasses.replace(perf.parse_perf(RECIPES[0]), data_type=data_type, nrep=1)
    res = perf.run_perf(cfg, device=CPU, verbose=False)
    a, _, _, _ = perf.perf_operands(cfg, device=CPU)
    assert a.dtype == (torch.complex64 if data_type == 5 else torch.complex128)
    assert np.isfinite(res["checksum"]) and res["route"] is not None


def test_run_perf_prints_its_report(capsys):
    cfg = perf.parse_perf(os.path.join(HERE, "inputs", "singleblock.perf"))
    perf.run_perf(dataclasses.replace(cfg, nrep=2), device=CPU)
    out = capsys.readouterr().out
    assert "multiplies 2" in out and "checksum" in out and "steady-state executor" in out


def run_cli(*args, cuda_hidden=True):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="" if cuda_hidden else "0")
    return subprocess.run([sys.executable, "-m", "dbcsr_tpu_torch.perf", *args],
                          capture_output=True, text=True, env=env, timeout=300)


def test_perf_cli_needs_cuda_unless_cpu():
    recipe = os.path.join(HERE, "inputs", "singleblock.perf")
    res = run_cli(recipe)
    assert res.returncode != 0 and "--device cpu" in res.stderr
    assert "checksum" not in res.stdout
    res = run_cli(recipe, "--device", "cpu", "--emit-checksum")
    assert res.returncode == 0, res.stderr
    assert "checksum check: OK" in res.stdout and "1.0E-6" in res.stdout
    assert "jax" not in res.stderr.lower()


def test_steady_state_time_on_the_cpu():
    x = torch.ones(64, 64, dtype=torch.float64)
    t = steady_state_time(lambda a, b: a @ b, (x, x), reps=3, warmup=1)
    assert isinstance(t, float) and t > 0


def test_executor_takes():
    rbs = np.array([2, 3], np.int32)
    rng = np.random.default_rng(0)
    a = dtt.random_matrix(rbs, rbs, 1.0, rng, device=CPU, dtype=np.float64)
    assert perf.executor_takes(a, a)
    assert not perf.executor_takes(a, a.astype(torch.float32))


# ---------------------------------------------------------------------------
# the self-test API
# ---------------------------------------------------------------------------

def pair(seed, occ=0.4, nb=12, dtype=np.float64):
    """The same random square matrix in both packages: one block structure,
    the pattern and values from ``seed``."""
    rbs = np.random.default_rng(0).choice([2, 3, 5], nb).astype(np.int32)
    rng = np.random.default_rng(seed)
    mask = rng.random((nb, nb)) < occ
    rows, cols = np.nonzero(mask)
    blocks = [rng.standard_normal((rbs[r], rbs[c])).astype(dtype) for r, c in zip(rows, cols)]
    return (djax.BCSRMatrix.from_blocks(rows, cols, blocks, rbs, rbs, dtype=dtype),
            dtt.BCSRMatrix.from_blocks(rows, cols, blocks, rbs, rbs, dtype=dtype, device=CPU))


@pytest.mark.parametrize("seed", [0, 1])
def test_impose_sparsity_matches_jax(seed):
    mj, mt = pair(seed)
    dense = np.random.default_rng(9).standard_normal(mt.shape)
    np.testing.assert_array_equal(testing.impose_sparsity(dense, mt),
                                  jax_testing.impose_sparsity(dense, mj))
    np.testing.assert_array_equal(testing.to_dense_local(mt), jax_testing.to_dense_local(mj))


def test_impose_sparsity_symmetric():
    rbs = np.array([2, 3, 4], np.int32)
    blocks = [np.ones((2, 3)), np.eye(4)]
    m = dtt.BCSRMatrix.from_blocks([0, 2], [1, 2], blocks, rbs, rbs, sym="S", device=CPU,
                                   dtype=np.float64)
    dense = np.arange(81.0).reshape(9, 9)
    got = testing.impose_sparsity(dense, m)
    kept = np.zeros((9, 9), bool)
    kept[0:2, 2:5] = kept[2:5, 0:2] = kept[5:9, 5:9] = True
    np.testing.assert_array_equal(got, np.where(kept, dense, 0.0))


@pytest.mark.parametrize("trans", ["NN", "TN", "NT"])
def test_check_multiply_accepts_and_detects_a_corrupted_block(trans):
    _, a = pair(1)
    _, b = pair(2)
    _, c = pair(3)
    ta, tb = trans
    out = dtt.multiply(ta, tb, 2.0, a, b, 0.5, c)
    assert testing.check_multiply(ta, tb, 2.0, a, b, 0.5, c, out)
    flat = out.flat_host().copy()
    blk = out.nblks // 2
    flat[out.index.blk_offset[blk]] += 1e-3
    assert not testing.check_multiply(ta, tb, 2.0, a, b, 0.5, c, out.with_flat(flat))


def test_check_multiply_retain_sparsity():
    _, a = pair(4)
    _, b = pair(5)
    _, c = pair(6, occ=0.3)
    out = dtt.multiply("N", "N", 1.0, a, b, 1.0, c, retain_sparsity=True)
    assert testing.check_multiply("N", "N", 1.0, a, b, 1.0, c, out, retain_sparsity=True)
    full = dtt.multiply("N", "N", 1.0, a, b, 1.0, c)
    assert not testing.check_multiply("N", "N", 1.0, a, b, 1.0, c, full,
                                      retain_sparsity=True)


def test_run_tests_on_the_cpu(capsys):
    assert testing.run_tests(CPU, verbose=True) is True
    out = capsys.readouterr().out
    assert "run_tests: ALL OK" in out and "test_binary_io: OK" in out


def test_self_tests_each():
    assert testing.test_mm(CPU, nblkrows=12, nblkcols=10, nblkks=11, dtype=np.float32)
    assert testing.test_binary_io(CPU, seed=3)
    assert testing.test_tas(CPU, seed=1)
    assert testing.test_tensor(CPU, seed=2)
    assert testing.validate_kernels(CPU) is True
    assert testing.validate_kernels("cpu", tile=16) is True


def test_validation_cases_build_on_the_cpu():
    """Every kernel family's case plans and runs its plain version here (the
    wrappers take their plain versions on CPU tensors)."""
    cases = testing._kernel_validation_cases(CPU, 16, 4, 0)
    assert [c[0].split(" ")[0] for c in cases] == [
        "flat", "grouped", "float64", "band", "panel", "panel-bf16", "panel-runs",
        "complex64", "complex128"]
    for name, tol, run_kernel, run_plain in cases:
        got, ref = run_kernel(), run_plain()
        assert got.shape == ref.shape and torch.equal(got, ref), name
        assert tol == {"float64": 1e-12, "complex128": 1e-12,
                       "panel-bf16": 2e-2}.get(name.split(" ")[0], 1e-4)


# ---------------------------------------------------------------------------
# logging and machine
# ---------------------------------------------------------------------------

def test_logging_levels_and_stack():
    base = tlog.get_logger()
    buf = io.StringIO()
    lg = tlog.Logger(stream=buf, level=tlog.LOG_WARNING, prefix="t")
    tlog.push_logger(lg)
    try:
        assert tlog.get_logger() is lg
        tlog.log(tlog.LOG_ERROR, "e")
        lg.warning("w")
        lg.note("n")  # above the level: dropped
        lg.debug("d")
        inner = tlog.Logger(stream=buf, level=tlog.LOG_DEBUG, prefix="u")
        tlog.push_logger(inner)
        tlog.log(tlog.LOG_DEBUG, "deep")
        assert tlog.pop_logger() is inner
    finally:
        assert tlog.pop_logger() is lg
    assert buf.getvalue().splitlines() == ["[t:ERROR] e", "[t:WARN] w", "[u:DEBUG] deep"]
    assert tlog.get_logger() is base
    assert tlog.pop_logger() is base  # the root logger is never popped
    assert dtt.core.get_logger() is base


def test_logging_matches_jax_format(capsys):
    from dbcsr_tpu.core import logging as jlog

    for mod in (tlog, jlog):
        mod.Logger(level=9, prefix="p").log(7, "x")  # a level without a name
        mod.Logger(prefix="p").note("hello")
        mod.Logger(prefix="p").debug("dropped")
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == out[2:] == ["[p:7] x", "[p:NOTE] hello"]
    tlog.Logger().note("port")
    assert capsys.readouterr().out == "[dbcsr_tpu_torch:NOTE] port\n"


def test_machine_helpers():
    t0 = machine.m_walltime()
    assert isinstance(t0, float) and machine.m_walltime() >= t0
    mem, peak = machine.m_memory(), machine.m_peak_memory()
    assert isinstance(mem, int) and isinstance(peak, int) and 0 < mem <= peak
    assert isinstance(machine.m_energy(), float) and machine.m_energy() >= 0.0
    machine.m_flush()
    machine.m_flush(io.StringIO())
    assert machine.backend_supports_complex() is True
    assert machine.device_memory_stats(CPU) is None
    assert machine.device_memory_stats("cpu") is None
    if not torch.cuda.is_available():
        assert machine.device_memory_stats() is None
    assert dtt.core.device_memory_stats is machine.device_memory_stats


def test_peak_memory_without_vmhwm(monkeypatch):
    """Where ``/proc/self/status`` has no VmHWM line (as in some containers),
    the peak comes from ``getrusage``, not 0."""
    import builtins
    import resource

    real_open = builtins.open

    def no_status(path, *a, **kw):
        if path == "/proc/self/status":
            return io.StringIO("Name:\tpython\nVmRSS:\t1 kB\n")
        return real_open(path, *a, **kw)

    monkeypatch.setattr(builtins, "open", no_status)
    lo = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    got = machine.m_peak_memory()
    assert 0 < lo <= got <= resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
