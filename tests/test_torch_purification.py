"""Port parity, the slice as a whole: the McWeeny purification loop of
``tests/test_purification.py`` (the canonical DBCSR application: iterated
float64 eps-filtered multiplies converging to an idempotent projector whose
trace is the electron count) through the port, against the same loop
through dbcsr_tpu on the same Hamiltonian.

The port passes the reference test's own assertions (idempotency < 1e-8,
trace equal to the electron count within 1e-6), takes the same number of
iterations as the JAX run and ends on the same block pattern; the two
projectors agree to 1e-10 relative (float64 sums in another order, over
~20 filtered products whose eps = 1e-9 decisions agree).
"""
import numpy as np
import torch

import dbcsr_tpu as djax
from dbcsr_tpu.core.config import config_override as jax_override

import dbcsr_tpu_torch as dtt
from dbcsr_tpu_torch.testing import matrix_from_arrays

torch.set_num_threads(1)


def hamiltonian(rng):
    """The symmetric banded Hamiltonian of tests/test_purification.py."""
    sizes = djax.random_block_sizes(80, [3, 5], rng)
    n = len(sizes)
    builder = djax.BCSRBuilder(sizes, sizes, name="H", dtype=np.float64, sym="S")
    for i in range(n):
        for j in range(i, min(n, i + 3)):
            blk = 0.1 * rng.standard_normal((int(sizes[i]), int(sizes[j])))
            if i == j:
                blk = 0.5 * (blk + blk.T) + np.diag(np.linspace(-1, 1, int(sizes[i])))
            builder.put_block(i, j, blk)
    return builder.finalize()


def mcweeny(pkg, h, eps=1e-9):
    """The reference test's loop, written once for either package."""
    dh = np.asarray(pkg.desymmetrize(h).to_dense())
    evals = np.linalg.eigvalsh(dh)
    lo, hi = evals[0], evals[-1]
    mid = len(evals) // 2
    gaps = np.diff(evals[mid - 20: mid + 20])
    g = int(np.argmax(gaps))
    mu = 0.5 * (evals[mid - 20 + g] + evals[mid - 20 + g + 1])
    s = max(hi - mu, mu - lo)
    p = pkg.add_on_diag(pkg.scale(pkg.desymmetrize(h), -0.5 / s), 0.5 + 0.5 * mu / s)
    ne_target = int((evals < mu).sum())
    iters = 0
    for _ in range(40):
        iters += 1
        p2 = pkg.multiply("N", "N", 1.0, p, p, filter_eps=eps)
        p3 = pkg.multiply("N", "N", 1.0, p2, p, filter_eps=eps)
        p_next = pkg.add(3.0, p2, -2.0, p3)
        delta = pkg.norm_frobenius(pkg.add(1.0, p_next, -1.0, p))
        p = pkg.filter_blocks(p_next, eps)
        if delta < 1e-11:
            break
    p2 = pkg.multiply("N", "N", 1.0, p, p)
    idem = pkg.norm_frobenius(pkg.add(1.0, p2, -1.0, p))
    return p, iters, idem, pkg.trace(p), ne_target


def test_mcweeny_purification_matches_jax():
    with jax_override(f64_method="native"):
        hj = hamiltonian(np.random.default_rng(42))
        pj, it_j, idem_j, tr_j, ne = mcweeny(djax, hj)
    ht = matrix_from_arrays(hj.row_block_sizes, hj.col_block_sizes, hj.index.blk_rows,
                            hj.index.col_idx, np.asarray(hj.data), device="cpu",
                            sym=hj.sym)
    assert ht.sym == "S" and ht.dtype == torch.float64
    pt, it_t, idem_t, tr_t, ne_t = mcweeny(dtt, ht)
    # the reference test's assertions, for the port
    assert idem_t < 1e-8
    assert abs(tr_t - ne_t) < 1e-6
    # the same run as the JAX package's
    assert ne_t == ne and it_t == it_j and idem_j < 1e-8
    np.testing.assert_array_equal(pt.index.row_ptr, pj.index.row_ptr)
    np.testing.assert_array_equal(pt.index.col_idx, pj.index.col_idx)
    ref = np.asarray(pj.to_dense())
    assert np.abs(pt.to_dense().numpy() - ref).max() <= 1e-10 * np.abs(ref).max()
