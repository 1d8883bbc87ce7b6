"""Example 9 (PyTorch port): line-for-line port of the reference's C-API
worked example ``dbcsr_example_3.cpp``.

The counterpart of ``examples/example_9_reference_example_3.py``, with
the port's names. The migration story — every step of the original maps
to one step here:

| reference (C API + MPI)                      | dbcsr_tpu_torch                |
|----------------------------------------------|--------------------------------|
| ``MPI_Init`` + ``c_dbcsr_init_lib``          | ``dt.init_lib()`` (``distributed=True`` across processes) |
| MPI_Cart_create 2-D grid                     | ``ProcessGrid.make(2, 2, devices=...)`` |
| ``random_dist`` round-robin ``i % nbins``    | same vectors, ``Distribution`` |
| ``c_dbcsr_create_new`` + reserve + iterator fill | ``BCSRBuilder(..., device=dev).put_block`` |
| ``c_dbcsr_finalize``                         | ``builder.finalize()``         |
| ``c_dbcsr_multiply_d('N','N',3,A,B,2,C)``    | ``dt.multiply('N','N',3,A,B,2,C, dist=dist)`` |
| ``c_dbcsr_print``                            | ``dt.print_matrix``            |

Same shapes, same block sizes, same non-zero block lists as the original.
The JAX example goes local with fewer than four devices; the port always
multiplies over a 2x2 grid: four virtual ranks on the one card (or on
``--device cpu``), Cannon's ticks on the float64 stack kernel. With
``--nprocs N`` the same program runs in N processes brought up with
``init_lib(distributed=True)`` over ``torch.distributed`` (``--backend``
gloo, the default, or nccl with one card a process), the grid's ranks
dealt over them; every process gets the whole product, bit for bit the
one-process product. Validated against a dense oracle: the script fails
loudly if the port ever diverges from the reference semantics.

    python examples/torch/example_9_reference_example_3.py              # on the card
    python examples/torch/example_9_reference_example_3.py --device cpu
    python examples/torch/example_9_reference_example_3.py --device cpu --nprocs 2
"""
import hashlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from _common import parser, session, spawn  # noqa: E402


def random_dist(dist_size: int, nbins: int) -> np.ndarray:
    """The reference's round-robin block distribution (example_3.cpp:24)."""
    return np.arange(dist_size, dtype=np.int64) % nbins


def fill_matrix(name, row_sizes, col_sizes, irblks, icblks, rng, dev):
    """create_new + reserve_blocks + iterator fill (example_3.cpp:94-130):
    every listed block exists and is filled with uniform [0,1) randoms."""
    import dbcsr_tpu_torch as dt

    b = dt.BCSRBuilder(row_sizes, col_sizes, name=name, dtype=np.float64, device=dev)
    for i, j in zip(irblks, icblks):
        b.put_block(i, j, rng.random((row_sizes[i], col_sizes[j])))
    return b.finalize()


def reference_example_3(dev, devices, say) -> dict:
    """The reference program on a 2x2 grid over ``devices`` (None: the
    processes of a distributed run); returns the product's readings."""
    import dbcsr_tpu_torch as dt
    from dbcsr_tpu_torch.dist import Distribution, ProcessGrid
    from dbcsr_tpu_torch.mm import kernel_launches, launches_since

    # block sizes (example_3.cpp:72-75)
    row_blk_1 = np.array([2, 3, 5, 2], dtype=np.int32)
    col_blk_1 = np.array([3, 3, 4, 6, 2], dtype=np.int32)
    row_blk_2 = col_blk_1
    col_blk_2 = np.array([5, 2, 5, 3], dtype=np.int32)

    # non-zero block lists (example_3.cpp:146-153)
    irblks_1 = [0, 0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3]
    icblks_1 = [0, 1, 2, 4, 0, 2, 3, 1, 3, 4, 0, 1, 2]
    irblks_2 = [0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 4]
    icblks_2 = [0, 2, 3, 0, 1, 2, 3, 0, 2, 3, 1, 2, 3, 0, 1, 2, 3]
    irblks_3 = [0, 0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3]
    icblks_3 = [0, 1, 2, 3, 0, 2, 3, 1, 2, 3, 0, 1, 2, 3]

    rng = np.random.default_rng(42)
    a = fill_matrix("matrix a", row_blk_1, col_blk_1, irblks_1, icblks_1, rng, dev)
    b = fill_matrix("matrix b", row_blk_2, col_blk_2, irblks_2, icblks_2, rng, dev)
    c = fill_matrix("matrix c", row_blk_1, col_blk_2, irblks_3, icblks_3, rng, dev)

    # oracle BEFORE the multiply (dense copies of the assembled inputs)
    da, db, dc = (m.to_dense().cpu().numpy() for m in (a, b, c))

    # 2-D grid + round-robin distributions (example_3.cpp:44-91): the MPI
    # cart grid becomes four ranks, virtual on one device or dealt over
    # the processes of a distributed run
    grid = ProcessGrid.make(2, 2, devices=devices)
    dist = Distribution(grid=grid, row_dist=random_dist(len(row_blk_1), 2),
                        col_dist=random_dist(len(col_blk_2), 2))
    say(f"grid: 2x2 over {', '.join(sorted({str(d) for d in grid.devices.flat}))}, "
        f"held by processes {grid.owner_list()}")

    # C = 3.0 * A * B + 2.0 * C   (example_3.cpp:163)
    before = kernel_launches()
    c = dt.multiply("N", "N", 3.0, a, b, 2.0, c, dist=dist)
    launched = launches_since(before)

    ref = 3.0 * (da @ db) + 2.0 * dc
    got = c.to_dense().cpu().numpy()
    err = float(np.abs(got - ref).max())
    scale = float(np.abs(ref).max())
    cs = dt.checksum(c)
    digest = hashlib.sha256(c.data.cpu().numpy().tobytes()).hexdigest()
    say(f"C = 3*A*B + 2*C: {c.nblks} blocks, max err {err:.2e}")
    say(f"checksum(C) = {cs:.15e}; sha256 of C's store {digest}")

    # expected-output checks (the c_dbcsr_print analog, made assertive)
    assert err <= 1e-12 * scale, "result diverges from the dense oracle"
    # the product adds blocks beyond C's initial 14 (no retain_sparsity)
    assert c.nblks >= 14, "product lost preexisting C blocks"
    assert c.index.nblkrows == 4 and c.index.nblkcols == 4
    return {"c": c, "checksum": cs, "max_err": err, "blocks": c.nblks, "digest": digest,
            "route": "cannon 2x2", "launches": launched}


def distributed() -> dict:
    """One process of a ``--nprocs`` run; process 0 prints and returns the
    readings."""
    import dbcsr_tpu_torch as dt
    from dbcsr_tpu_torch.dist import comm

    first = comm.rank() == 0
    out = reference_example_3(comm.device(), None, print if first else (lambda *_: None))
    c = out.pop("c")
    if first:
        dt.print_matrix(c, values=False)
        print("OK — reference example 3 semantics reproduced")
    return out


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--nprocs", type=int, default=1,
                    help="processes (1: four virtual ranks in this process)")
    ap.add_argument("--backend", default="gloo", help="gloo or nccl (with --nprocs)")
    args = ap.parse_args(argv)
    if args.nprocs > 1:
        return spawn(distributed, args.nprocs, args.device, args.backend)

    import dbcsr_tpu_torch as dt

    with session(args) as dev:
        out = reference_example_3(dev, [dev] * 4, print)
        dt.print_matrix(out.pop("c"), values=False)
        print("OK — reference example 3 semantics reproduced")
    dt.finalize_lib()
    return out


if __name__ == "__main__":
    main()
