"""Helpers of the port's example and tool parity tests.

As a program, ``python tests/torch_example_runner.py <jax example.py>``
runs one JAX example as ``__main__`` (on JAX's CPU when ``DBCSR_PLATFORM=cpu``
is set) with a recorder around the JAX package's ``trace``, ``print_matrix``
and ``tensors.contract``, and prints, after the example's own output, one
line ``RECORD {json}``: every trace it took, the checksum of every matrix
it printed and the sum of squares of every contraction's result, at full
precision (the examples print fewer digits). Nothing of the JAX package
changes: the recorder wraps its functions in this process only.

As a module it starts and finishes that program (``start_jax``,
``finish_jax``), loads a port example or tool by path (``load``) and runs a
port example on the CPU (``port_example``).
"""
import importlib.util
import json
import os
import runpy
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_env(devices: int = 1) -> dict:
    env = dict(os.environ, DBCSR_PLATFORM="cpu", OMP_NUM_THREADS="1")
    if devices > 1:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    else:
        env.pop("XLA_FLAGS", None)
    return env


def start_jax(script: str, *args: str, devices: int = 1, runner: bool = True):
    """Start a JAX example (``examples/<script>``, through the recorder) or
    tool (``tools/<script>`` with ``runner=False``) in a subprocess."""
    path = os.path.join(REPO, "examples" if runner else "tools", script)
    cmd = [sys.executable] + ([os.path.abspath(__file__)] if runner else []) + [path, *args]
    return subprocess.Popen(cmd, env=jax_env(devices), cwd=REPO, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def finish_jax(proc, timeout: float = 300) -> tuple:
    """(stdout lines without the record, record) of a finished run."""
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    lines = out.splitlines()
    record = {}
    if lines and lines[-1].startswith("RECORD "):
        record = json.loads(lines.pop()[len("RECORD "):])
    return lines, record


def load(relpath: str, name: str):
    """Import ``relpath`` (under the repository) as module ``name``."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_example(name: str, capsys, *args: str):
    """Run ``examples/torch/<name>.py``'s main on the CPU; (its returned
    readings, its printed lines)."""
    mod = load(f"examples/torch/{name}.py", f"torch_{name}")
    capsys.readouterr()
    out = mod.main(["--device", "cpu", *args])
    return out, capsys.readouterr().out.splitlines()


def _record_and_run(path: str) -> None:
    import numpy as np

    sys.path.insert(0, REPO)
    import dbcsr_tpu as dt
    import dbcsr_tpu.tensors as dtt

    record = {"traces": [], "checksums": [], "tensor_checksums": []}
    trace, print_matrix, contract = dt.trace, dt.print_matrix, dtt.contract

    def traced(m, *a, **k):
        v = trace(m, *a, **k)
        record["traces"].append(float(v))
        return v

    def printed(m, *a, **k):
        record["checksums"].append(float(dt.checksum(m)))
        return print_matrix(m, *a, **k)

    def contracted(*a, **k):
        out = contract(*a, **k)
        d = np.asarray(out.to_dense()).astype(np.float64)
        record["tensor_checksums"].append(float((d ** 2).sum()))
        return out

    dt.trace, dt.print_matrix, dtt.contract = traced, printed, contracted
    sys.argv = [path]
    runpy.run_path(path, run_name="__main__")
    sys.stdout.flush()
    print("RECORD " + json.dumps(record), flush=True)


if __name__ == "__main__":
    _record_and_run(sys.argv[1])
