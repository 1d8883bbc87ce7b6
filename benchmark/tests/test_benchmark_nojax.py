"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: ``dbcsr_tpu_torch`` begins with ``dbcsr_tpu``), none
reads the old harnesses, and the reference imports nothing of the program."""
import ast
import os

from conftest import REPO

BENCH = os.path.join(REPO, "benchmark")
FORBIDDEN = {"jax", "jaxlib", "flax", "dbcsr_tpu", "bench", "chip_smoke"}


def imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


def modules():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    found = {os.path.relpath(p, REPO): imports(p) & FORBIDDEN for p in modules()}
    assert not {k: v for k, v in found.items() if v}
    assert len(found) > 20


def test_prefix_is_not_a_match():
    """products.py drives the port, which is not the JAX package."""
    names = imports(os.path.join(BENCH, "products.py"))
    assert "dbcsr_tpu_torch" in names and not names & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            assert "dbcsr_tpu_torch" not in imports(os.path.join(ref, f)), f


def test_run_loads_no_jax(tiny):
    import sys

    from conftest import BIG_SEED

    from benchmark.harness import forbidden_modules, run

    root, here = tiny
    out = run("water2048.plain_step", BIG_SEED, 0.2, False, root=root, here=here, device="cpu")
    assert out["forbidden"] == [] and forbidden_modules() == []
    assert "jax" not in sys.modules
