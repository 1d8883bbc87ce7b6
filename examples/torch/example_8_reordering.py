"""Example 8 (PyTorch port): locality-aware block renumbering.

The counterpart of ``examples/example_8_reordering.py``. Real
linear-scaling-SCF matrices are near-sighted (blocks couple only to
spatial neighbours), but the atom numbering handed to the library rarely
shows it, and the tile store packs ~T/avg_block consecutive block rows per
hardware tile: a clustered but scrambled numbering shatters tile packing.
``locality_block_permutation`` runs Reverse-Cuthill-McKee on the block
graph to recover the hidden locality axis, ``permute_blocks`` renumbers
the matrix, and every later multiply gets compact tiles. The inverse
permutation restores the caller's order for export. float32, as the JAX
example; the tile counts come from the same host numpy and so equal its.

    python examples/torch/example_8_reordering.py              # on the card
    python examples/torch/example_8_reordering.py --device cpu
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from _common import parser, routes, session  # noqa: E402


def main(argv=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    import dbcsr_tpu_torch as dt

    with session(args) as dev:
        rng = np.random.default_rng(0)

        # hidden 1-D chain with exponential-decay coupling ...
        n = 600
        sizes = rng.choice([5, 13], size=n).astype(np.int32)
        dmax = 8
        i = np.repeat(np.arange(n, dtype=np.int64), 2 * dmax + 1)
        off = np.tile(np.arange(-dmax, dmax + 1, dtype=np.int64), n)
        j = i + off
        keep = (j >= 0) & (j < n) & (rng.random(len(j)) < np.exp(-np.abs(off) / 3.0))
        # ... then SCRAMBLE the block numbering (atom order hides the chain)
        sig = rng.permutation(n).astype(np.int64)
        rows, cols = sig[i[keep]], sig[j[keep]]
        rbs = np.empty(n, np.int32)
        rbs[sig] = sizes

        blocks = [rng.standard_normal((rbs[r], rbs[c])).astype(np.float32)
                  for r, c in zip(rows, cols)]
        a = dt.BCSRMatrix.from_blocks(rows, cols, blocks, rbs, rbs, name="A", device=dev)
        tiles_scrambled = a.layout.n_tiles
        print(f"scrambled numbering: {a.index.nblks} blocks -> "
              f"{tiles_scrambled} hardware tiles")

        # recover the locality axis and renumber
        pm, pk, pn = dt.locality_block_permutation(a.index)
        ar = dt.permute_blocks(a, pm, pn)
        tiles_ordered = ar.layout.n_tiles
        print(f"RCM-recovered:       {ar.index.nblks} blocks -> "
              f"{tiles_ordered} hardware tiles "
              f"({tiles_scrambled / tiles_ordered:.1f}x denser)")

        # the product of renumbered operands IS the renumbered product
        c_scr = dt.multiply("N", "N", 1.0, a, a)
        c_ord = dt.multiply("N", "N", 1.0, ar, ar)
        want = dt.permute_blocks(c_scr, pm, pn).to_dense()
        err = float((c_ord.to_dense() - want).abs().max())
        largest = float(want.abs().max())
        print(f"renumbered product matches: max err {err:.2e} "
              f"({err / largest:.2e} of the largest entry {largest:.4e})")
        assert err <= 1e-4 * largest, "the renumbered product differs"

        # undo for export: inverse permutation restores the caller's order
        back = dt.permute_blocks(ar, np.argsort(pm), np.argsort(pn))
        assert torch.equal(back.to_dense(), a.to_dense())
        print("inverse permutation restores the original numbering")
        out = {"blocks": a.index.nblks, "tiles_scrambled": tiles_scrambled,
               "tiles_ordered": tiles_ordered, "max_err": err, "largest": largest,
               "routes": routes()}
    dt.finalize_lib()
    return out


if __name__ == "__main__":
    main()
