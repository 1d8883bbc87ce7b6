"""The command line shared by the port's examples (``examples/torch/``).

Every example runs on the card unless told otherwise: ``--device`` defaults
to ``cuda``, and where torch finds no CUDA device the example stops with a
message naming ``--device cpu``; it never carries on on the CPU by itself.
``--tile`` sets the tile size T of the stores (the library's default, 128,
otherwise). Each example has a ``main(argv=None)`` that parses ``argv``
(the command line when None), runs, prints what the JAX example prints,
and returns its readings as a dict, so that a driver can call it
in-process. ``spawn`` runs a function in several processes brought up with
``init_lib(distributed=True)`` (the ``--nprocs`` form of the examples and
of ``tools/torch/weak_scaling.py``).
"""
import argparse
import contextlib
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default), cuda:N, or cpu; never a fallback")
    ap.add_argument("--tile", type=int, default=None,
                    help="tile size T of the stores (default: the library's)")
    return ap


@contextlib.contextmanager
def session(args):
    """Initialise the library for one example on ``args.device`` (with
    ``args.tile`` if given, undone on exit) and yield the device. The
    statistics start empty, so that ``routes`` names this run's routes."""
    import dbcsr_tpu_torch as dt
    from dbcsr_tpu_torch.core.machine import program_device
    from dbcsr_tpu_torch.core.stats import reset_stats

    dev = program_device(args.device)
    dt.init_lib()
    reset_stats()
    knobs = {} if args.tile is None else {"tile_size": args.tile}
    with dt.config_override(**knobs):
        yield dev


def routes() -> list:
    """The routes the one-shot local multiplies since ``session`` began
    have taken (``print_statistics``' "local routes")."""
    from dbcsr_tpu_torch.core.stats import get_stats

    return sorted(get_stats().local_routes)


def spawn(target, nprocs: int, device: str, backend: str, *args):
    """Run ``target(*args)`` in ``nprocs`` processes, each brought up with
    ``init_lib(distributed=True)`` over ``torch.distributed`` (a ``file://``
    rendezvous; ``backend`` gloo or nccl; ``device`` "cuda" puts process i
    on card i modulo the card count). Returns what process 0's call
    returned, if it returned a JSON-able value, else None."""
    import torch

    from dbcsr_tpu_torch.core.machine import program_device

    program_device(device)  # no CUDA and no --device cpu: stop here
    with tempfile.TemporaryDirectory() as d:
        report = os.path.join(d, "report.json")
        torch.multiprocessing.start_processes(
            _process, args=(nprocs, f"file://{d}/rendezvous", device, backend, target, args,
                            report),
            nprocs=nprocs, start_method="spawn")
        if not os.path.exists(report):
            return None
        with open(report) as f:
            return json.load(f)


def _process(pid: int, nprocs: int, url: str, device: str, backend: str, target, args,
             report: str) -> None:
    import torch

    import dbcsr_tpu_torch as dt

    torch.set_num_threads(1)
    dt.init_lib(distributed=True, coordinator_address=url, num_processes=nprocs,
                process_id=pid, backend=backend, device=None if device == "cuda" else device)
    try:
        out = target(*args)
        if pid == 0 and out is not None:
            with open(report, "w") as f:
                json.dump(out, f)
    finally:
        dt.finalize_lib()
