"""Port parity of examples 1, 2, 3 and 5: each JAX example (``examples/``)
runs as a program on JAX's CPU (``DBCSR_PLATFORM=cpu``, through
``torch_example_runner.py``'s recorder), the port's counterpart
(``examples/torch/``) runs with ``--device cpu`` in this process, and the
numbers the two print are held against each other:

- ex 1: the block list equal, the checksum to 1e-12 relative;
- ex 2: shape and block count equal, both errors against einsum <= 1e-12;
- ex 3: C's block count, occupation and effective flops equal;
- ex 5 (McWeeny, float64, eps 1e-8): the iteration count within one, the
  trace of every iteration to 1e-8, the occupation to 1e-3, both final
  idempotency errors <= 1e-12 and the electron counts equal. Filter
  decisions on marginal blocks may flip between two float64 sums in other
  orders, so the loop is compared under these tolerances, not bitwise.
"""
import re

import pytest
import torch

from torch_example_runner import finish_jax, port_example, start_jax

torch.set_num_threads(1)



def numbers(line: str) -> list:
    return [float(x) for x in re.findall(r"[-+]?\d+\.?\d*(?:[eE][-+]?\d+)?", line)]


def test_example_1_create_multiply(capsys):
    jax = start_jax("example_1_create_multiply.py")
    port, lines = port_example("example_1_create_multiply", capsys)
    jlines, rec = finish_jax(jax)
    blocks = [ln.strip() for ln in jlines if ln.strip().startswith("block (")]
    assert blocks and [ln.strip() for ln in lines if ln.strip().startswith("block (")] == blocks
    coords = [tuple(map(int, re.match(r"block \((\d+),(\d+)\)", b).groups())) for b in blocks]
    assert [tuple(b) for b in port["blocks"]] == coords
    header = next(ln for ln in jlines if ln.startswith("matrix "))
    assert header in lines
    (jcs,) = rec["checksums"]
    assert port["checksum"] == pytest.approx(jcs, rel=1e-12)
    printed = next(ln for ln in jlines if ln.startswith("checksum(C)"))
    assert numbers(printed)[-1] == pytest.approx(port["checksum"], rel=1e-12)


def test_example_2_tensor_contraction(capsys):
    jax = start_jax("example_2_tensor_contraction.py")
    port, lines = port_example("example_2_tensor_contraction", capsys)
    jlines, _ = finish_jax(jax)
    jline = next(ln for ln in jlines if ln.startswith("contraction C[i,j,l]"))
    jshape = tuple(int(x) for x in re.search(r"shape=\(([^)]*)\)", jline).group(1).split(","))
    jblocks = int(re.search(r"blocks=(\d+)", jline).group(1))
    jerr = float(re.search(r"max_err=(\S+)", jline).group(1))
    assert port["shape"] == jshape and port["blocks"] == jblocks
    assert jerr <= 1e-12 and port["max_err"] <= 1e-12
    assert any(ln.startswith(f"contraction C[i,j,l]: shape={jshape} blocks={jblocks}")
               for ln in lines)


def test_example_3_sparse_1000(capsys):
    jax = start_jax("example_3_sparse_1000.py")
    port, lines = port_example("example_3_sparse_1000", capsys)
    jlines, _ = finish_jax(jax)
    jline = next(ln for ln in jlines if ln.startswith("C: "))
    assert jline in lines  # blocks, occupation and effective flops, as printed
    jb, jocc, jflops = numbers(jline)
    assert port["c_blocks"] == int(jb)
    assert round(port["occupation"], 3) == jocc
    assert float(f"{port['eff_flops']:.3e}") == jflops
    assert port["clock"] == "host perf_counter, CPU"  # a CPU run says so
    assert port["launches"] == {}  # plain versions on CPU tensors


def test_example_5_purification(capsys):
    jax = start_jax("example_5_purification.py")
    port, lines = port_example("example_5_purification", capsys)
    jlines, rec = finish_jax(jax)
    jiters = [ln for ln in jlines if ln.startswith(" iter ")]
    jtraces = rec["traces"][:len(jiters)]
    assert abs(port["iterations"] - len(jiters)) <= 1
    for k in range(min(len(jtraces), port["iterations"])):
        assert port["traces"][k] == pytest.approx(jtraces[k], abs=1e-8), k
        assert port["occupations"][k] == pytest.approx(numbers(jiters[k])[2], abs=1e-3), k
    final = next(ln for ln in jlines if ln.startswith("idempotency"))
    jidem = float(re.search(r"= (\S+);", final).group(1))
    jelectrons = rec["traces"][-1]
    assert jidem <= 1e-12 and port["idempotency"] <= 1e-12
    assert round(port["electrons"]) == round(jelectrons) == port["target"]
    assert f"(target {port['target']})" in final
