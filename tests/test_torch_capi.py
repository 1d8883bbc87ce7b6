"""The port's C API shim (``dbcsr_tpu_torch/capi/``) against the JAX
package's (``dbcsr_tpu/capi/``).

The C programs of the JAX package's own C API tests (``C_PROGRAM`` of
``tests/test_capi.py``, ``MATRIX_PROGRAM`` and ``TENSOR_PROGRAM`` of
``tests/test_capi_v2.py``, read from those files, not copied) and
``examples/example_6_c_api.c`` compile unchanged against each shim and run
in subprocesses on the CPU: the JAX shim with ``JAX_PLATFORMS=cpu``, the
port's with ``DBCSR_CAPI_DEVICE=cpu``. Their printed numbers agree within
1e-10 relative (float64, complex128) and 1e-4 (float32, complex64: the
lines of the ``s`` and ``c`` type classes). Static checks: every function
of the port's header has a Python counterpart that the C sources call; the
port's C sources equal the JAX package's but for the package they import
and their comments; the port's shim builds from its own directory only and
imports neither jax nor dbcsr_tpu; ``c_dbcsr_init_lib`` fails, naming
``DBCSR_CAPI_DEVICE``, where there is no CUDA device and no explicit cpu.
"""
import ast
import os
import re
import shutil
import subprocess
import sys
import sysconfig
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from dbcsr_tpu.capi import build_capi as build_jax_capi
from dbcsr_tpu.capi import header_path as jax_header_path

from dbcsr_tpu_torch import capi as tcapi
from dbcsr_tpu_torch.capi import helpers as thelpers
from dbcsr_tpu_torch.capi import himpl as thimpl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_CAPI = os.path.join(REPO, "dbcsr_tpu_torch", "capi")
JAX_CAPI = os.path.join(REPO, "dbcsr_tpu", "capi")

pytestmark = pytest.mark.skipif(shutil.which("gcc") is None, reason="no C compiler")

PROGRAMS = ["C_PROGRAM", "MATRIX_PROGRAM", "TENSOR_PROGRAM", "example_6"]
_SOURCES = {"C_PROGRAM": "tests/test_capi.py", "MATRIX_PROGRAM": "tests/test_capi_v2.py",
            "TENSOR_PROGRAM": "tests/test_capi_v2.py"}


def program_text(name: str) -> str:
    """The C program text: a string constant of the JAX tests (read with
    ``ast``, nothing executed) or the example file."""
    if name == "example_6":
        with open(os.path.join(REPO, "examples", "example_6_c_api.c")) as f:
            return f.read()
    with open(os.path.join(REPO, _SOURCES[name])) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name for t in node.targets):
            return ast.literal_eval(node.value)
    raise KeyError(name)


def _env(shim: str) -> dict:
    env = dict(os.environ)
    env.pop("DBCSR_CAPI_DEVICE", None)
    env["PYTHONPATH"] = os.pathsep.join([REPO, sysconfig.get_paths()["purelib"]])
    if shim == "jax":
        env["JAX_PLATFORMS"] = "cpu"
    else:
        env["DBCSR_CAPI_DEVICE"] = "cpu"
    return env


def compile_program(text: str, so: str, header_dir: str, exe: str) -> str:
    src = exe + ".c"
    with open(src, "w") as f:
        f.write(text)
    subprocess.run(
        ["gcc", "-O1", src, so, f"-I{header_dir}", f"-Wl,-rpath,{os.path.dirname(so)}",
         "-o", exe],
        check=True, capture_output=True,
    )
    return exe


@pytest.fixture(scope="module")
def shims():
    jso, tso = build_jax_capi(), tcapi.build_capi()
    if jso is None or tso is None:
        pytest.skip("could not build a C shim (no shared libpython?)")
    return {"jax": (jso, os.path.dirname(jax_header_path())),
            "torch": (tso, os.path.dirname(tcapi.header_path()))}


@pytest.fixture(scope="module")
def runs(shims, tmp_path_factory):
    """Every program against both shims, four processes at a time."""
    d = tmp_path_factory.mktemp("capi")
    jobs = {}
    for name in PROGRAMS:
        for shim, (so, hdr) in shims.items():
            jobs[(name, shim)] = compile_program(
                program_text(name), so, hdr, str(d / f"{name}_{shim}"))

    def run(key):
        return subprocess.run([jobs[key]], capture_output=True, text=True,
                              env=_env(key[1]), timeout=540, cwd=str(d))

    with ThreadPoolExecutor(4) as pool:
        return dict(zip(jobs, pool.map(run, jobs)))


def _tokens(line: str):
    out = []
    for tok in line.replace(",", " ").split():
        try:
            out.append(float(tok))
        except ValueError:
            out.append(tok)
    return out


def assert_outputs_agree(got: str, ref: str) -> None:
    gl, rl = got.strip().splitlines(), ref.strip().splitlines()
    assert len(gl) == len(rl), (got, ref)
    for g, r in zip(gl, rl):
        tg, tr = _tokens(g), _tokens(r)
        assert len(tg) == len(tr), (g, r)
        # the s and c lines of the typed sweep are single precision
        rtol = 1e-4 if tr and tr[0] in ("s", "c") else 1e-10
        for a, b in zip(tg, tr):
            if isinstance(b, float):
                assert isinstance(a, float), (g, r)
                assert abs(a - b) <= rtol * max(abs(a), abs(b)), (g, r)
            else:
                assert a == b, (g, r)


@pytest.mark.parametrize("name", PROGRAMS)
def test_c_program_agrees_with_the_jax_shim(runs, name):
    jax_run, torch_run = runs[(name, "jax")], runs[(name, "torch")]
    assert jax_run.returncode == 0, jax_run.stderr + jax_run.stdout
    assert torch_run.returncode == 0, torch_run.stderr + torch_run.stdout
    assert_outputs_agree(torch_run.stdout, jax_run.stdout)
    if name == "example_6":
        assert torch_run.stdout.startswith("C = A*A^T: "), torch_run.stdout
    else:
        assert torch_run.stdout.strip().endswith("OK"), torch_run.stdout


def test_example_6_result_against_the_port_in_process(runs):
    """Example 6's numbers against the same product through the port's
    Python API (the example's LCG fill re-made in numpy)."""
    import dbcsr_tpu_torch as dtt

    nb, bs = 10, 5
    seed = 42
    b = dtt.BCSRBuilder([bs] * nb, [bs] * nb, dtype=np.float64, device="cpu")
    for i in range(nb):
        for j in range(nb):
            seed = (seed * 1103515245 + 12345) % 2**32
            if (seed >> 16) % 10 < 3:
                blk = np.empty(bs * bs)
                for k in range(bs * bs):
                    seed = (seed * 1103515245 + 12345) % 2**32
                    blk[k] = ((seed >> 16) % 1000) / 1000.0 - 0.5
                b.put_block(i, j, blk.reshape(bs, bs))
    a = b.finalize()
    c = dtt.multiply("N", "N", 1.0, a, dtt.transpose(a), filter_eps=1e-9)
    words = _tokens(runs[("example_6", "torch")].stdout)
    assert words[3] == c.nblks
    assert words[8] == pytest.approx(float(dtt.trace(c)), abs=1e-6)
    assert words[10] == pytest.approx(dtt.norm_frobenius(c), abs=1e-6)


# ---------------------------------------------------------------------------
# static checks of the sources
# ---------------------------------------------------------------------------

def _preprocessed(path: str, *includes: str) -> str:
    inc = [f"-I{d}" for d in includes]
    res = subprocess.run(["gcc", "-E", "-P", *inc, path], check=True,
                         capture_output=True, text=True)
    return res.stdout


def _declared_functions() -> set:
    text = _preprocessed(tcapi.header_path())
    return set(re.findall(r"\b(c_dbcsr_\w+)\s*\(", text))


def _definitions() -> dict:
    """c function name -> (python names it calls through helpers, through
    himpl, the c_dbcsr functions it calls)."""
    text = _preprocessed(os.path.join(PORT_CAPI, "capi.c"), PORT_CAPI,
                         sysconfig.get_paths()["include"])
    heads = list(re.finditer(
        r"(?:\bint|const char \*)\s*(c_dbcsr_\w+)\s*\([^;{)]*\)\s*\{", text))
    out = {}
    for k, m in enumerate(heads):
        body = text[m.end():heads[k + 1].start() if k + 1 < len(heads) else len(text)]
        helpers = set(re.findall(r'callh\(\s*"(\w+)"', body))
        helpers |= set(re.findall(r'CallMethod\(\s*g_helpers\s*,\s*"(\w+)"', body))
        out[m.group(1)] = (helpers, set(re.findall(r'callv\(\s*"(\w+)"', body)),
                           set(re.findall(r"\b(c_dbcsr_\w+)\s*\(", body)))
    return out


#: entry points that are C alone (the handle table and the error text)
PURE_C = {"c_dbcsr_release", "c_dbcsr_last_error"}


def test_every_header_function_reaches_python():
    declared = _declared_functions()
    defs = _definitions()
    assert len(declared) > 200
    assert declared <= set(defs), sorted(declared - set(defs))

    def reaches(name, seen=()):
        if name in PURE_C:
            return True
        helpers, himpl, calls = defs[name]
        for h in helpers:
            assert callable(getattr(thelpers, h, None)), (name, h)
        for h in himpl:
            assert callable(getattr(thimpl, h, None)), (name, h)
        return bool(helpers or himpl) or any(
            reaches(c, seen + (name,)) for c in calls - {name} - set(seen) if c in defs)

    missing = [n for n in sorted(declared) if not reaches(n)]
    assert not missing, missing


def test_the_shared_library_exports_every_header_function(shims):
    res = subprocess.run(["nm", "-D", "--defined-only", shims["torch"][0]],
                         capture_output=True, text=True)
    if res.returncode != 0:
        pytest.skip("no nm")
    exported = set(re.findall(r"\bT (c_dbcsr_\w+)", res.stdout))
    assert _declared_functions() <= exported


_COMMENT = re.compile(r"/\*.*?\*/|//[^\n]*", re.S)


def _code_lines(text: str):
    return [ln.rstrip() for ln in _COMMENT.sub("", text).splitlines() if ln.strip()]


@pytest.mark.parametrize("name", ["capi.c", "capi2.c", "capi3.c", "dbcsr_tpu.h"])
def test_c_sources_are_in_step_with_the_jax_package(name):
    """The port's C sources are the JAX package's but for the module names
    they import (one macro) and comments."""
    with open(os.path.join(JAX_CAPI, name)) as f:
        ref = f.read()
    with open(os.path.join(PORT_CAPI, name)) as f:
        got = f.read()
    ref = re.sub(r'"dbcsr_tpu(\.capi\.\w+)"', r'DBCSR_PY_PACKAGE "\1"', ref)
    got_lines = [ln for ln in _code_lines(got)
                 if ln != '#define DBCSR_PY_PACKAGE "dbcsr_tpu_torch"']
    assert got_lines == _code_lines(ref)
    comments = " ".join(_COMMENT.findall(got))
    assert "jax" not in comments.lower()
    if name == "capi.c":
        assert '#define DBCSR_PY_PACKAGE "dbcsr_tpu_torch"' in got


def test_build_uses_the_ports_directory_only(tmp_path):
    cmd = tcapi.capi_build_command("gcc", str(tmp_path / "x.so"))
    assert cmd is not None
    for arg in cmd:
        path = arg[2:] if arg.startswith(("-I", "-L")) else arg
        assert "dbcsr_tpu" not in re.split(r"[/\\]", os.path.normpath(path)), arg
    assert os.path.join(PORT_CAPI, "capi.c") in cmd
    # every file capi.c includes by quotes is in the port's own directory
    for part in ("capi.c", "capi2.c", "capi3.c"):
        with open(os.path.join(PORT_CAPI, part)) as f:
            for inc in re.findall(r'#include\s+"([^"]+)"', f.read()):
                assert os.path.exists(os.path.join(PORT_CAPI, inc)), inc
    assert tcapi.header_path() == os.path.join(PORT_CAPI, "dbcsr_tpu.h")


def test_build_lands_in_the_ports_build_directory(shims):
    from dbcsr_tpu_torch import _build

    assert os.path.dirname(shims["torch"][0]) == _build.BUILD_DIR
    assert tcapi.build_capi() == shims["torch"][0]  # cached by hash


def test_shim_modules_import_neither_jax_nor_the_jax_package():
    code = ("import sys, dbcsr_tpu_torch.capi.himpl, dbcsr_tpu_torch.capi.helpers; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'dbcsr_tpu' or m.startswith('dbcsr_tpu.')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr


INIT_PROGRAM = r"""
#include <stdio.h>
#include "dbcsr_tpu.h"
int main(void) {
  int rc = c_dbcsr_init_lib();
  printf("init %d\n", rc);
  printf("error %s\n", c_dbcsr_last_error());
  int sizes[2] = {2, 3};
  int64_t m = 0;
  rc = c_dbcsr_create_new(&m, "M", 0, 'N', sizes, 2, sizes, 2, dbcsr_type_real_8);
  printf("create %d\n", rc);
  printf("error %s\n", c_dbcsr_last_error());
  return 0;
}
"""


@pytest.mark.parametrize("value", [None, "cuda", "tpu"])
def test_init_lib_fails_without_a_cuda_device(shims, tmp_path, value):
    """No CUDA device (hidden from torch) and no explicit cpu: init returns 1
    with a message that names the variable, and no later call runs."""
    so, hdr = shims["torch"]
    exe = compile_program(INIT_PROGRAM, so, hdr, str(tmp_path / "init"))
    env = _env("torch")
    env.pop("DBCSR_CAPI_DEVICE")
    env["CUDA_VISIBLE_DEVICES"] = ""
    if value is not None:
        env["DBCSR_CAPI_DEVICE"] = value
    res = subprocess.run([exe], capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert lines[0] == "init 1", res.stdout
    assert "DBCSR_CAPI_DEVICE" in lines[1], res.stdout
    assert lines[2] == "create 1", res.stdout
    assert "c_dbcsr_init_lib" in lines[3], res.stdout
