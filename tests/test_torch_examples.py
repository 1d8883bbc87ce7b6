"""The port's distributed examples run as programs: ``examples/torch/``'s
example 4 (Cannon, 2.5D and SUMMA across processes) and example 7 (the
sharded at-rest loop and a per-process checkpoint), each at two processes
on the CPU over gloo. Each example asserts against its own oracle (a dense
product, the local pipeline) and prints an OK line on its I/O process."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("script,ok", [
    ("example_4_distributed.py", "OK — every process holds the product"),
    ("example_7_sharded_storage.py", "OK — the sharded loop matches the local one"),
])
def test_distributed_example(script, ok):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "torch", script),
         "--nprocs", "2", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=180, cwd=REPO,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert ok in res.stdout
    assert res.stdout.count(ok) == 1  # the logger prints on the I/O process only


SINGLE_PROCESS_EXAMPLES = [
    ("example_1_create_multiply.py", "checksum(C) = "),
    ("example_2_tensor_contraction.py", "contraction C[i,j,l]: shape=(5, 4, 5) blocks=4"),
    ("example_3_sparse_1000.py", "host perf_counter, CPU"),
    ("example_5_purification.py", "(target 303)"),
    ("example_8_reordering.py", "inverse permutation restores the original numbering"),
    ("example_9_reference_example_3.py", "OK — reference example 3 semantics reproduced"),
    ("example_10_reference_tensor_example_2.py",
     "OK — reference tensor example 2 semantics reproduced"),
]


def run_example(script, *args):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "torch", script), *args],
        env=env, capture_output=True, text=True, timeout=180, cwd=REPO,
    )


@pytest.mark.parametrize("script,ok", SINGLE_PROCESS_EXAMPLES)
def test_example_runs_on_the_cpu_when_asked(script, ok):
    res = run_example(script, "--device", "cpu")
    assert res.returncode == 0, res.stderr[-3000:]
    assert ok in res.stdout


@pytest.mark.parametrize("script", [s for s, _ in SINGLE_PROCESS_EXAMPLES])
def test_example_without_cuda_stops_and_names_the_cpu_flag(script):
    """The default device is the card; without one an example stops with a
    message naming ``--device cpu`` and never carries on on the CPU."""
    import importlib.util

    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    spec = importlib.util.spec_from_file_location(
        "nocuda_" + script[:-3], os.path.join(REPO, "examples", "torch", script))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for argv in ([], ["--device", "cuda"]):
        with pytest.raises(SystemExit, match="--device cpu"):
            mod.main(argv)


def test_example_without_cuda_exits_non_zero():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = run_example("example_1_create_multiply.py")
    assert res.returncode != 0
    assert "--device cpu" in res.stderr and "checksum" not in res.stdout


def test_example_9_across_processes_is_bitwise_the_single_process_product():
    """``--nprocs 2`` deals the 2x2 grid over two processes (gloo): the
    product's store is bit for bit the four-virtual-rank one."""
    one = run_example("example_9_reference_example_3.py", "--device", "cpu")
    two = run_example("example_9_reference_example_3.py", "--device", "cpu", "--nprocs", "2")
    assert one.returncode == 0, one.stderr[-3000:]
    assert two.returncode == 0, two.stderr[-3000:]
    digest = [ln for ln in one.stdout.splitlines() if "sha256 of C's store" in ln]
    assert len(digest) == 1 and digest[0] in two.stdout.splitlines()
    assert "held by processes [0, 1, 0, 1]" in two.stdout
    assert two.stdout.count("OK — reference example 3 semantics reproduced") == 1


def _guide_names() -> list:
    """Every port name in the last column of ``docs/user_guide_torch.md``'s
    migration table, as written there (``dt.x.y``, ``M.x``, ``Bld.x``,
    ``T.x``)."""
    import re

    with open(os.path.join(REPO, "docs", "user_guide_torch.md")) as f:
        text = f.read()
    table = text.split("## Migration table", 1)[1].split("\n## ", 1)[0]
    names = []
    for line in table.splitlines():
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        if len(cells) != 3 or set(cells[2]) <= set("-") or cells[2] == "`dbcsr_tpu_torch`":
            continue
        for tok in re.findall(r"`([^`]+)`", cells[2]):
            tok = tok.split("(")[0]
            if re.fullmatch(r"(dt|M|Bld|T)(\.\w+)+", tok):
                names.append(tok)
    return names


def test_user_guide_migration_table_names_resolve():
    """The guide cannot rot: every name its migration table gives for the
    port resolves, attribute by attribute (a submodule is imported where
    the package does not import it itself)."""
    import importlib

    import dbcsr_tpu_torch as dt

    roots = {"dt": dt, "M": dt.BCSRMatrix, "Bld": dt.BCSRBuilder, "T": dt.tensors.Tensor}
    names = _guide_names()
    assert len(names) > 100
    for name in names:
        head, *parts = name.split(".")
        obj, path = roots[head], "dbcsr_tpu_torch"
        for part in parts:
            path += "." + part
            if not hasattr(obj, part) and obj.__name__ == path.rsplit(".", 1)[0]:
                importlib.import_module(path)
            assert hasattr(obj, part), name
            obj = getattr(obj, part)
