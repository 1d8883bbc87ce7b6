"""Example 7 (PyTorch port): sharded at-rest storage across processes.

The counterpart of ``examples/example_7_sharded_storage.py`` in its
multi-process form: ``--nprocs`` processes (``torch.multiprocessing``),
each brought up with ``init_lib(distributed=True)``. ``shard_matrix``
materializes on each process only the shards of its own ranks;
``sharded_multiply``, ``sharded_add``, ``sharded_filter`` and the
reductions consume and produce that form, the reductions adding the ranks'
partials in rank order on every process; a checkpoint is written by each
process for its own shards. Nothing gathers a matrix until the check at
the end.

    python examples/torch/example_7_sharded_storage.py --nprocs 2 --device cpu
    python examples/torch/example_7_sharded_storage.py --nprocs 2 --device cuda
"""
import argparse
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))


def run(pid: int, nprocs: int, url: str, device: str, backend: str, work: str) -> None:
    import dbcsr_tpu_torch as dt
    from dbcsr_tpu_torch.core.logging import get_logger
    from dbcsr_tpu_torch.dist import (
        ProcessGrid, comm, shard_matrix, sharded_add, sharded_checkpoint_read,
        sharded_checkpoint_write, sharded_filter, sharded_frobenius, sharded_multiply,
        sharded_trace, tile_aligned_dist,
    )

    torch.set_num_threads(1)
    dt.init_lib(distributed=True, coordinator_address=url, num_processes=nprocs,
                process_id=pid, backend=backend, device=None if device == "cuda" else device)
    dt.set_config(tile_size=32)
    dev = comm.device()
    say = get_logger().note  # prints on the I/O process (rank 0) only

    grid = ProcessGrid.make(2, 2)
    rng = np.random.default_rng(0)
    rbs = dt.random_block_sizes(1500, [5, 13], rng)
    dist = tile_aligned_dist(grid, rbs, rbs, 32)

    # a random symmetric-ish sparse matrix, sharded by owner
    h = dt.random_matrix(rbs, rbs, 0.05, rng, name="H", device=dev)
    h = dt.add(0.5, h, 0.5, dt.transpose(h))
    sh = shard_matrix(h, dist)
    held = sum(x is not None for x in sh.data)
    say(f"H: {sh.nblks} blocks in {sh.shard.ndev} shards of [{sh.shard.n_max}, 32, 32]; "
        f"processes of the shards {grid.plane().owner_list()}")
    print(f"process {pid}: holds {held} of {sh.shard.ndev} shards", flush=True)

    # a damped matrix-polynomial iteration, fully sharded:
    #   X <- 0.5 * (X·H + X),  filtered each step
    x = sh
    for it in range(3):
        x = sharded_filter(sharded_add(0.5, sharded_multiply("N", "N", 1.0, x, sh), 0.5, x),
                           1e-6)
        say(f"  iter {it}: {x.nblks} blocks, trace {sharded_trace(x):+.4f}, "
            f"||X||_F {sharded_frobenius(x):.4f}")

    # each process writes its own shards; every process reads its own back
    ckpt = os.path.join(work, "x")
    sharded_checkpoint_write(x, ckpt)
    back = sharded_checkpoint_read(ckpt, grid)
    resid = sharded_frobenius(sharded_add(1.0, back, -1.0, x))
    say(f"checkpoint round trip: residual {resid:.1e}")
    assert resid == 0.0

    # verify against the local pipeline, which every process can run alone
    y = h
    for _ in range(3):
        y = dt.filter_blocks(dt.add(0.5, dt.multiply("N", "N", 1.0, y, h), 0.5, y), 1e-6)
    yd = y.to_dense().double().cpu().numpy()
    err = float(np.abs(x.to_local().to_dense().double().cpu().numpy() - yd).max())
    scale = max(1.0, float(np.abs(yd).max()))
    say(f"max |sharded - local| = {err:.2e} (rel {err / scale:.2e})")
    assert err < 1e-5 * scale
    say("OK — the sharded loop matches the local one")
    dt.finalize_lib()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--backend", default="gloo", help="gloo or nccl")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as d:
        torch.multiprocessing.start_processes(
            run, args=(args.nprocs, f"file://{d}/rendezvous", args.device, args.backend, d),
            nprocs=args.nprocs, start_method="spawn")


if __name__ == "__main__":
    main()
