"""Port parity of examples 8, 9 and 10: each JAX example (``examples/``)
runs as a program on JAX's CPU (``DBCSR_PLATFORM=cpu``, through
``torch_example_runner.py``'s recorder), the port's counterpart
(``examples/torch/``) runs with ``--device cpu`` in this process, and the
numbers the two print are held against each other:

- ex 8 (float32): the tile counts before and after the renumbering equal
  (host numpy in both), both product errors <= 1e-4 of the largest entry;
- ex 9: the printed C (block list) equal and the checksum to 1e-12
  relative against BOTH of the JAX example's branches — its 2x2 grid over
  eight virtual devices and its local engine on one — and the OK line;
- ex 10: the shape and block count equal, the sum of squares of the result
  to 1e-12 relative, and the OK line.
"""
import re

import pytest
import torch

from torch_example_runner import finish_jax, port_example, start_jax

torch.set_num_threads(1)



def test_example_8_reordering(capsys):
    jax = start_jax("example_8_reordering.py")
    port, lines = port_example("example_8_reordering", capsys)
    jlines, _ = finish_jax(jax)
    scr = next(ln for ln in jlines if ln.startswith("scrambled numbering"))
    rcm = next(ln for ln in jlines if ln.startswith("RCM-recovered"))
    assert scr in lines and rcm in lines  # the same blocks and tile counts, as printed
    jblocks, jscr = map(int, re.findall(r"(\d+) (?:blocks|hardware)", scr))
    assert (port["blocks"], port["tiles_scrambled"]) == (jblocks, jscr)
    assert port["tiles_ordered"] == int(re.search(r"-> (\d+) hardware", rcm).group(1))
    jerr = float(re.search(r"max err (\S+)", next(
        ln for ln in jlines if ln.startswith("renumbered product"))).group(1))
    assert jerr <= 1e-4 * port["largest"] and port["max_err"] <= 1e-4 * port["largest"]
    assert "inverse permutation restores the original numbering" in jlines
    assert "inverse permutation restores the original numbering" in lines


@pytest.mark.parametrize("devices,branch", [(8, "grid: 2x2"), (1, "fewer than 4 devices")])
def test_example_9_reference_example_3(capsys, devices, branch):
    jax = start_jax("example_9_reference_example_3.py", devices=devices)
    port, lines = port_example("example_9_reference_example_3", capsys)
    jlines, rec = finish_jax(jax)
    assert jlines[0].startswith(branch)
    (jcs,) = rec["checksums"]
    assert port["checksum"] == pytest.approx(jcs, rel=1e-12)
    jmatrix = [ln for ln in jlines if ln.startswith(("matrix ", "  block ("))]
    assert len(jmatrix) == 17 and jmatrix == [
        ln for ln in lines if ln.startswith(("matrix ", "  block ("))]
    jc = next(ln for ln in jlines if ln.startswith("C = 3*A*B + 2*C"))
    assert f"C = 3*A*B + 2*C: {port['blocks']} blocks" in jc
    ok = "OK — reference example 3 semantics reproduced"
    assert ok in jlines and ok in lines
    assert port["launches"] == {}  # plain versions on CPU tensors


def test_example_10_reference_tensor_example_2(capsys):
    jax = start_jax("example_10_reference_tensor_example_2.py")
    port, lines = port_example("example_10_reference_tensor_example_2", capsys)
    jlines, rec = finish_jax(jax)
    (jcs,) = rec["tensor_checksums"]
    assert port["checksum"] == pytest.approx(jcs, rel=1e-12)
    jline = next(ln for ln in jlines if ln.startswith("(13|2)x(54|21)=(3|45)"))
    assert f"out blocks={port['blocks']} shape={port['shape']}" in jline
    ok = "OK — reference tensor example 2 semantics reproduced"
    assert ok in jlines and ok in lines
