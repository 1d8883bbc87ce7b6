"""Weak-scaling harness (PyTorch port) for the distributed multiply
(BASELINE metric #2).

The counterpart of ``tools/weak_scaling.py``. Runs the Cannon (square
grids) or SUMMA (any grid) executor on one rank and on n ranks with the
per-rank problem held constant (23-row blocks at 25% occupancy, ``nblk``
growing as √n), and reports the weak-scaling efficiency: the ideal n-rank
time (the one-rank time times the flop ratio over n) over the measured one.

The ranks are those of a ``ProcessGrid``, in one of two forms:

- one process over ``--devices`` (default: every CUDA device; ``--device
  cpu``: the CPU), or ``--ranks N`` virtual ranks on the first of them;
- ``--nprocs N`` processes, each brought up with
  ``init_lib(distributed=True)`` over ``torch.distributed`` (``--backend``
  gloo or nccl) and holding one rank on its device (card i modulo the
  card count); every executor call ends with the whole product on every
  process, the one-rank leg's too (its rank is process 0's).

Ranks that share a device (virtual ranks on one card, or the host's CPU
cores) time-share it, so the efficiency then measures the orchestration
only, not scaling (perfect time-sharing gives 1/n): ``shared_device`` says
so, and the ×n-normalised view is reported beside it.

Protocol (the JAX tool's): the two executors are timed back to back in
each of ``rounds`` rounds (the least of ``reps`` calls each, the host
clock around work that ends in a synchronise of every rank's device), the
efficiency is formed per round from same-round times, so slow drift
cancels in the ratio, and the report is the median efficiency with its
IQR across rounds.

    python tools/torch/weak_scaling.py [blocks_per_device] [rounds] [reps]
        [--device cuda|cpu] [--devices cuda:0,cuda:1] [--ranks N]
        [--nprocs N --backend gloo|nccl]
"""
import argparse
import hashlib
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for _p in (REPO, os.path.join(REPO, "examples", "torch")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from _common import spawn  # noqa: E402  (the examples' --nprocs helper)


def rank_devices(devices=None, ranks=None) -> list:
    """The devices of the n ranks in one process: ``devices`` (default every
    CUDA device), or ``ranks`` virtual ranks on the first of them."""
    from dbcsr_tpu_torch.core.machine import program_device

    if devices is None:
        devices = [program_device("cuda")]
        devices += [torch.device("cuda", i) for i in range(1, torch.cuda.device_count())]
    devs = [program_device(d) for d in devices]
    return devs[:1] * ranks if ranks else devs


def _grid_shape(n: int) -> tuple:
    p = int(np.sqrt(n))
    while p > 1 and n % p:
        p -= 1
    return p, n // p


def _sync(devs) -> None:
    for d in {str(d): d for d in devs}.values():
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def run(blocks_per_dev: int = 64, rounds: int = 7, reps: int = 3, *,
        devices=None, ranks=None) -> dict:
    """The weak-scaling measurement over the ranks of this process
    (``devices`` / ``ranks``) or, after ``init_lib(distributed=True)``, over
    one rank a process. Returns the JAX tool's readings (``virtual_mesh``
    renamed ``shared_device``) and the digest of the n-rank product."""
    import dbcsr_tpu_torch as dt
    from dbcsr_tpu_torch.dist import ProcessGrid, comm, tile_aligned_dist
    from dbcsr_tpu_torch.mm import kernel_launches, launches_since

    dt.init_lib()
    if comm.is_up():
        n = comm.world_size()
        devs = [comm.device()] * n  # this process's view: its own rank's device
        shared = comm.device().type == "cpu" or n > torch.cuda.device_count()
    else:
        devs = rank_devices(devices, ranks)
        n = len(devs)
        shared = len({str(d) for d in devs}) < n or devs[0].type == "cpu"
    p, q = _grid_shape(n)
    g1 = ProcessGrid.make(1, 1, devices=devs[:1])  # process 0's rank when distributed
    gn = ProcessGrid.make(p, q, devices=devs)

    def build(grid, nblk):
        rng = np.random.default_rng(0)
        rbs = np.full(nblk, 23, dtype=np.int32)
        dev = grid.device(0, 0) if not comm.is_up() else comm.device()
        a = dt.random_matrix(rbs, rbs, 0.25, rng, dtype=np.float32, name="A", device=dev)
        b = dt.random_matrix(rbs, rbs, 0.25, rng, dtype=np.float32, name="B", device=dev)
        dist = tile_aligned_dist(grid, rbs, rbs, a.tile)
        fn, _, fl = dt.build_distributed_executor("N", "N", a, b, dist)
        fn(a.data, b.data)  # plan, allocate, warm up
        _sync(devs)
        return fn, (a.data, b.data), fl

    def time_min(fn, args):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(*args)
            _sync(devs)
            best = min(best, time.perf_counter() - t0)
        return best

    # per-rank problem held constant: nblk grows with sqrt(ranks)
    fn1, args1, fl1 = build(g1, blocks_per_dev)
    fnn, argsn, fln = build(gn, int(blocks_per_dev * np.sqrt(n)))
    before = kernel_launches()
    prod = fnn(*argsn)
    _sync(devs)
    launched = launches_since(before)
    digest = hashlib.sha256(prod.cpu().numpy().tobytes()).hexdigest()
    del prod

    effs, t1s, tns = [], [], []
    for _ in range(rounds):
        t1 = time_min(fn1, args1)  # back to back: drift cancels in
        tn = time_min(fnn, argsn)  # the same-round ratio below
        effs.append(t1 * (fln / (n * fl1)) / tn if tn > 0 else 0.0)
        t1s.append(t1)
        tns.append(tn)
    q25, q50, q75 = np.percentile(np.asarray(effs), [25, 50, 75])
    kinds = sorted({torch.cuda.get_device_name(d) if d.type == "cuda" else "cpu"
                    for d in devs})
    out = {
        "devices": n,
        "grid": [p, q],
        "processes": comm.world_size(),
        "rank_devices": sorted({str(d) for d in devs}) if not comm.is_up() else None,
        "device_kind": kinds,
        "blocks_per_device": blocks_per_dev,
        "rounds": rounds,
        "reps_per_round": reps,
        "t_1dev_median_s": float(np.median(t1s)),
        "t_ndev_median_s": float(np.median(tns)),
        "flops_1": fl1,
        "flops_n": fln,
        "weak_scaling_efficiency_median": float(q50),
        "efficiency_iqr": [float(q25), float(q75)],
        "efficiency_rounds": [float(e) for e in effs],
        "launches_n": launched,
        "product_digest": digest,
        # ranks that share a device time-share it: the efficiency then
        # measures orchestration only (perfect time-sharing = 1/n), so the
        # xn-normalised view stands beside it; the >= 80% BASELINE target
        # applies to ranks on cards of their own
        "shared_device": bool(shared),
    }
    if shared:
        out["efficiency_x_n_median"] = float(q50) * n
        out["efficiency_x_n_iqr"] = [float(q25) * n, float(q75) * n]
        out["note"] = "ranks share a device: orchestration only, not scaling"
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("blocks_per_device", type=int, nargs="?", default=64)
    ap.add_argument("rounds", type=int, nargs="?", default=7)
    ap.add_argument("reps", type=int, nargs="?", default=3)
    ap.add_argument("--devices", default=None,
                    help="comma-separated rank devices (default: every CUDA device)")
    ap.add_argument("--ranks", type=int, default=None,
                    help="virtual ranks on the first device")
    ap.add_argument("--nprocs", type=int, default=None,
                    help="processes under init_lib(distributed=True), one rank each")
    ap.add_argument("--backend", default="gloo", help="gloo or nccl (with --nprocs)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: every card, or one a process) or cpu")
    args = ap.parse_args(argv)
    sizes = (args.blocks_per_device, args.rounds, args.reps)
    if args.nprocs:
        out = spawn(run, args.nprocs, args.device, args.backend, *sizes)
    else:
        devices = (args.devices.split(",") if args.devices
                   else None if args.device == "cuda" else [args.device])
        out = run(*sizes, devices=devices, ranks=args.ranks)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
