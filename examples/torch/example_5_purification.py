"""Example 5 (PyTorch port): McWeeny density-matrix purification.

The counterpart of ``examples/example_5_purification.py``, the canonical
linear-scaling-SCF workload DBCSR exists for: iterates P <- 3P² − 2P³ with
on-the-fly epsilon filtering until P is idempotent, in float64; block
sparsity is kept by the filter throughout, and the trace stays at the
electron count. Exercises multiply, add, filtering, trace and the
statistics report in a realistic loop. ``--rows`` sizes the Hamiltonian
(600 rows of 5- and 13-blocks, as in the JAX example).

    python examples/torch/example_5_purification.py              # on the card
    python examples/torch/example_5_purification.py --device cpu
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from _common import parser, routes, session  # noqa: E402


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--rows", type=int, default=600, help="rows of the Hamiltonian")
    args = ap.parse_args(argv)
    import dbcsr_tpu_torch as dt

    with session(args) as dev:
        rng = np.random.default_rng(0)

        # banded symmetric "Hamiltonian-like" matrix, mixed chemistry block sizes
        sizes = dt.random_block_sizes(args.rows, [5, 13], rng)
        n = len(sizes)
        builder = dt.BCSRBuilder(sizes, sizes, name="H", dtype=np.float64, sym="S",
                                 device=dev)
        for i in range(n):
            for j in range(i, min(n, i + 3)):
                blk = 0.1 * rng.standard_normal((sizes[i], sizes[j]))
                if i == j:
                    blk = 0.5 * (blk + blk.T) + np.diag(np.linspace(-1, 1, sizes[i]))
                builder.put_block(i, j, blk)
        h = builder.finalize()

        # initial guess P0 = (I - (H - mu)/s)/2, s = max(hi-mu, mu-lo): maps the
        # spectrum into [0, 1] with occupied states above 1/2 (standard init)
        dh = dt.desymmetrize(h).to_dense().cpu().numpy()
        evals = np.linalg.eigvalsh(dh)
        lo, hi = evals[0], evals[-1]
        mu = 0.0
        s = max(hi - mu, mu - lo)
        p0 = dt.add_on_diag(dt.scale(dt.desymmetrize(h), -0.5 / s), 0.5 + 0.5 * mu / s)

        ne_target = int((evals < mu).sum())
        p = p0
        eps = 1e-8
        traces, occs = [], []
        for it in range(30):
            p2 = dt.multiply("N", "N", 1.0, p, p, filter_eps=eps)
            p3 = dt.multiply("N", "N", 1.0, p2, p, filter_eps=eps)
            p_next = dt.add(3.0, p2, -2.0, p3)
            delta = dt.norm_frobenius(dt.add(1.0, p_next, -1.0, p))
            p = dt.filter_blocks(p_next, eps)
            traces.append(dt.trace(p))
            occs.append(p.occupation())
            print(f" iter {it:2d}: trace={traces[-1]:9.4f} occ={occs[-1]:.3f}"
                  f" |dP|={delta:.2e}")
            if delta < 1e-10:
                break

        # converged P must be idempotent: P² == P
        p2 = dt.multiply("N", "N", 1.0, p, p)
        idem = dt.norm_frobenius(dt.add(1.0, p2, -1.0, p))
        electrons = dt.trace(p)
        print(f"idempotency |P² − P| = {idem:.3e}; electrons (trace) = "
              f"{electrons:.4f} (target {ne_target})")
        print(dt.print_statistics())
        assert idem <= 1e-12, "P did not converge to an idempotent projector"
        assert round(electrons) == ne_target, "the trace left the electron count"
        out = {"iterations": len(traces), "traces": traces, "occupations": occs,
               "idempotency": idem, "electrons": electrons, "target": ne_target,
               "routes": routes()}
    dt.finalize_lib()
    return out


if __name__ == "__main__":
    main()
