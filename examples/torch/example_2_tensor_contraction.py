"""Example 2 (PyTorch port): 3-index block-sparse tensor contraction.

The counterpart of ``examples/example_2_tensor_contraction.py``: contract
a rank-3 tensor with a rank-2 tensor over one index, validated against a
dense ``einsum``. The same seed gives the same blocks as the JAX example.

    python examples/torch/example_2_tensor_contraction.py              # on the card
    python examples/torch/example_2_tensor_contraction.py --device cpu
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
    from dbcsr_tpu_torch.tensors import NDMapping, TensorBuilder, contract

    with session(args) as dev:
        rng = np.random.default_rng(0)

        bs_i = np.array([3, 2], dtype=np.int32)
        bs_j = np.array([2, 2], dtype=np.int32)
        bs_k = np.array([4, 3], dtype=np.int32)
        bs_l = np.array([5], dtype=np.int32)

        # T[i,j,k], 60% occupied; folded with (i,j) as matrix rows
        tb = TensorBuilder([bs_i, bs_j, bs_k], NDMapping(3, (0, 1), (2,)),
                           name="T", dtype=np.float64, device=dev)
        for bi in np.ndindex(2, 2, 2):
            if rng.random() < 0.6:
                shp = (bs_i[bi[0]], bs_j[bi[1]], bs_k[bi[2]])
                tb.put_block(bi, rng.standard_normal(shp))
        t = tb.finalize()

        mb = TensorBuilder([bs_k, bs_l], name="M", dtype=np.float64, device=dev)
        for bi in np.ndindex(2, 1):
            mb.put_block(bi, rng.standard_normal((bs_k[bi[0]], bs_l[bi[1]])))
        m = mb.finalize()

        # C[i,j,l] = sum_k T[i,j,k] M[k,l]
        c = contract(
            1.0, t, m,
            contract_1=(2,), notcontract_1=(0, 1),
            contract_2=(0,), notcontract_2=(1,),
        )
        ref = torch.einsum("ijk,kl->ijl", t.to_dense(), m.to_dense())
        err = float((c.to_dense() - ref).abs().max())
        print(f"contraction C[i,j,l]: shape={c.shape} blocks={c.nblks} "
              f"max_err={err:.2e}")
        assert err <= 1e-12, "the contraction diverges from the einsum oracle"
        out = {"shape": tuple(c.shape), "blocks": c.nblks, "max_err": err,
               "routes": routes()}
    dt.finalize_lib()
    return out


if __name__ == "__main__":
    main()
