"""Example 1 (PyTorch port): assemble two block-sparse matrices and multiply them.

The counterpart of ``examples/example_1_create_multiply.py``: init the
library, build matrices block by block, multiply with epsilon filtering,
inspect the result and the statistics report. The same seed gives the
same blocks as the JAX example, so the block list and the checksum agree.

    python examples/torch/example_1_create_multiply.py              # on the card
    python examples/torch/example_1_create_multiply.py --device cpu
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from _common import parser, routes, session  # noqa: E402


def main(argv=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    import dbcsr_tpu_torch as dt

    with session(args) as dev:
        # block structure: 4 block rows/cols of mixed sizes
        sizes = np.array([2, 3, 5, 2], dtype=np.int32)

        rng = np.random.default_rng(0)
        a_builder = dt.BCSRBuilder(sizes, sizes, name="A", dtype=np.float64, device=dev)
        b_builder = dt.BCSRBuilder(sizes, sizes, name="B", dtype=np.float64, device=dev)
        for i in range(4):
            for j in range(4):
                if rng.random() < 0.5:
                    a_builder.put_block(i, j, rng.standard_normal((sizes[i], sizes[j])))
                if rng.random() < 0.5:
                    b_builder.put_block(i, j, rng.standard_normal((sizes[i], sizes[j])))
        a = a_builder.finalize()
        b = b_builder.finalize()

        c = dt.multiply("N", "N", 1.0, a, b, filter_eps=1e-10)

        dt.print_matrix(c, values=False)
        cs = dt.checksum(c)
        print(f"checksum(C) = {cs:.12e}")
        print(dt.print_statistics())
        out = {"checksum": cs, "blocks": [(r, k) for r, k, _ in c.iter_blocks()],
               "routes": routes(), "device": str(c.device)}
    dt.finalize_lib()
    return out


if __name__ == "__main__":
    main()
