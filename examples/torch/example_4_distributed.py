"""Example 4 (PyTorch port): the distributed multiply across processes.

The counterpart of ``examples/example_4_distributed.py`` in its
multi-process form: ``--nprocs`` processes, started here with
``torch.multiprocessing``, each bring the world up with
``init_lib(distributed=True)`` over ``torch.distributed``. A grid made
afterwards deals its ranks over the processes: Cannon's ring shifts on a
square grid (with a 2.5D layer axis) and SUMMA's panel gathers on any grid
then cross process boundaries, and every process gets the whole product,
bit for bit the product of one process driving every rank.

    python examples/torch/example_4_distributed.py --nprocs 2 --device cpu
    python examples/torch/example_4_distributed.py --nprocs 2 --device cuda

``--device cuda`` puts process i on card i modulo the card count;
several processes on one card need ``--backend gloo`` (the default: pieces
travel through pinned host memory), one process a card may take ``nccl``.
"""
import argparse
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))


def run(pid: int, nprocs: int, url: str, device: str, backend: str) -> None:
    import dbcsr_tpu_torch as dt
    from dbcsr_tpu_torch.core.logging import get_logger
    from dbcsr_tpu_torch.dist import ProcessGrid, comm, tile_aligned_dist

    torch.set_num_threads(1)
    dt.init_lib(distributed=True, coordinator_address=url, num_processes=nprocs,
                process_id=pid, backend=backend, device=None if device == "cuda" else device)
    dt.set_config(tile_size=32)
    dev = comm.device()
    say = get_logger().note  # prints on the I/O process (rank 0) only

    # the same operands on every process (one seed), as the JAX battery does
    rng = np.random.default_rng(0)
    rbs = dt.random_block_sizes(2000, [5, 13, 23], rng)
    a = dt.random_matrix(rbs, rbs, 0.1, rng, name="A", device=dev)
    b = dt.random_matrix(rbs, rbs, 0.1, rng, name="B", device=dev)
    ref = a.to_dense().double().cpu().numpy() @ b.to_dense().double().cpu().numpy()
    scale = max(1.0, float(np.abs(ref).max()))

    def check(what, c):
        err = float(np.abs(c.to_dense().double().cpu().numpy() - ref).max())
        say(f"{what}: C blocks={c.nblks}, max err={err:.2e}")
        assert err < 1e-4 * scale, (what, err)

    # square grid -> Cannon: A shifts left, B up, between the processes
    grid = ProcessGrid.make(2, 2)
    say(f"{nprocs} processes, grid 2x2 held by processes {grid.owner_list()}")
    dist = tile_aligned_dist(grid, rbs, rbs, a.tile)
    check("Cannon on 2x2", dt.multiply("N", "N", 1.0, a, b, dist=dist))

    # 2.5D: two layers, the layer partials summed in layer order
    dist3 = tile_aligned_dist(ProcessGrid.make(2, 2, 2), rbs, rbs, a.tile)
    check("2.5D Cannon on 2x2x2", dt.multiply("N", "N", 1.0, a, b, dist=dist3))

    # the plan-once executor: each process runs its own ranks' ticks
    fn, c_index, flops = dt.build_distributed_executor("N", "N", a, b, dist)
    comm.reset_transfer_counts()
    c = dt.BCSRMatrix(name="C", index=c_index, data=fn(a.data, b.data))
    moved = comm.transfer_counts()
    check(f"executor ({fn.plan.launches} kernel launches on this process, "
          f"{moved.bytes_sent / 1e6:.2f} MB sent a call)", c)

    # non-square grid -> SUMMA (row and column panels gathered)
    dist2 = tile_aligned_dist(ProcessGrid.make(4, 2), rbs, rbs, a.tile)
    check("SUMMA on 4x2", dt.multiply("N", "N", 1.0, a, b, dist=dist2))
    say("OK — every process holds the product")
    dt.finalize_lib()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--backend", default="gloo", help="gloo or nccl")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as d:
        torch.multiprocessing.start_processes(
            run, args=(args.nprocs, f"file://{d}/rendezvous", args.device, args.backend),
            nprocs=args.nprocs, start_method="spawn")


if __name__ == "__main__":
    main()
