"""Example 10 (PyTorch port): line-for-line port of the reference's tensor
C-API worked example ``dbcsr_tensor_example_2.cpp``: the contraction
**(13|2) x (54|21) = (3|45)**

    T3[k,l,m] = 0.2 * sum_{i,j} T1[i,j,k] * T2[i,j,l,m] + 0.8 * T3[k,l,m]

The counterpart of ``examples/example_10_reference_tensor_example_2.py``,
with the original's exact block sizes, non-zero block lists, layout maps
and scaling factors. The migration map:

| reference (tensor C API + MPI)                   | dbcsr_tpu_torch                |
|--------------------------------------------------|--------------------------------|
| ``c_dbcsr_t_pgrid_create`` 3-D/4-D pgrids        | implicit (one device; ``TensorPGrid`` for ranks) |
| ``c_dbcsr_t_create_new(map1, map2)``             | ``TensorBuilder(..., NDMapping(ndim, map1, map2), device=dev)`` |
| ``c_dbcsr_t_reserve_blocks`` + iterator fill     | ``builder.put_block``          |
| ``c_dbcsr_t_contract_r_dp(0.2, t1, t2, 0.8, t3, c1, nonc1, c2, nonc2, map1, map2)`` | ``contract(0.2, t1, t2, 0.8, t3, contract_1=c1, notcontract_1=nonc1, contract_2=c2, notcontract_2=nonc2, map_1=map1, map_2=map2)`` |

Validated against a dense ``einsum`` oracle at 1e-12: fails loudly if the
port diverges from the reference semantics.

    python examples/torch/example_10_reference_tensor_example_2.py              # on the card
    python examples/torch/example_10_reference_tensor_example_2.py --device cpu
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from _common import parser, routes, session  # noqa: E402


def build_tensor(name, block_sizes, mapping, nz_lists, rng, dev):
    """create_new + reserve + iterator fill (tensor_example_2.cpp:85-120):
    each listed nd block exists, filled with uniform [0,1) randoms."""
    from dbcsr_tpu_torch.tensors import TensorBuilder

    bld = TensorBuilder([np.asarray(s, dtype=np.int32) for s in block_sizes],
                        mapping, name=name, dtype=np.float64, device=dev)
    for bi in zip(*nz_lists):
        shp = tuple(int(block_sizes[d][bi[d]]) for d in range(len(bi)))
        bld.put_block(bi, rng.random(shp))
    return bld.finalize()


def main(argv=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    import dbcsr_tpu_torch as dt
    from dbcsr_tpu_torch.tensors import NDMapping, contract

    with session(args) as dev:
        rng = np.random.default_rng(42)

        # block sizes (tensor_example_2.cpp:151-155)
        blk1 = [3, 9, 12, 1]
        blk2 = [4, 2, 3, 1, 9, 2, 32, 10, 5, 8, 7]
        blk3 = [7, 3, 8, 7, 9, 5, 10, 23, 2]
        blk4 = [8, 1, 4, 13, 6]
        blk5 = [4, 2, 22]

        # non-zero block index lists (tensor_example_2.cpp:157-173)
        nz11 = [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1,
                2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3]
        nz12 = [2, 4, 4, 4, 5, 5, 6, 7, 9, 10, 10, 0, 0, 3, 6, 6, 8, 9,
                1, 1, 4, 5, 7, 7, 8, 10, 10, 1, 3, 4, 4, 7]
        nz13 = [6, 2, 4, 8, 5, 7, 1, 7, 2, 1, 2, 0, 3, 5, 1, 6, 4, 7,
                2, 6, 0, 3, 2, 6, 7, 4, 7, 8, 5, 0, 1, 6]

        nz21 = [0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3]
        nz22 = [0, 2, 3, 5, 9, 1, 1, 3, 4, 4, 5, 5, 5, 6, 6, 8, 8, 8,
                9, 10, 0, 2, 2, 3, 4, 5, 7, 8, 10, 10, 0, 2, 3, 5, 9, 10]
        nz24 = [2, 4, 1, 2, 1, 2, 4, 0, 0, 3, 1, 2, 3, 0, 3, 2, 3, 3,
                1, 0, 2, 0, 0, 2, 3, 2, 3, 1, 1, 2, 0, 0, 2, 1, 4, 4]
        nz25 = [0, 2, 1, 0, 0, 1, 2, 0, 2, 0, 1, 2, 1, 0, 2, 1, 2, 1,
                0, 1, 2, 0, 1, 2, 1, 1, 1, 2, 0, 1, 0, 2, 1, 0, 2, 1]

        nz33 = [1, 3, 4, 4, 4, 5, 5, 7]
        nz34 = [2, 1, 0, 0, 2, 1, 3, 4]
        nz35 = [2, 1, 0, 1, 2, 1, 0, 0]

        # layout maps (tensor_example_2.cpp:227-232): (13|2), (54|21), (3|45)
        # (0-based dim groups of each tensor's 2-D fold)
        t1 = build_tensor("(13|2)", [blk1, blk2, blk3], NDMapping(3, (0, 2), (1,)),
                          (nz11, nz12, nz13), rng, dev)
        t2 = build_tensor("(54|21)", [blk1, blk2, blk4, blk5], NDMapping(4, (3, 2), (1, 0)),
                          (nz21, nz22, nz24, nz25), rng, dev)
        t3 = build_tensor("(3|45)", [blk3, blk4, blk5], NDMapping(3, (0,), (1, 2)),
                          (nz33, nz34, nz35), rng, dev)

        # dense oracle BEFORE the contraction
        d1, d2, d3 = (t.to_dense() for t in (t1, t2, t3))

        # tensor_3 := 0.2 * t1(nonc1|c1) * t2(c2|nonc2) + 0.8 * tensor_3
        # (tensor_example_2.cpp:286-303)
        out = contract(
            0.2, t1, t2, 0.8, t3,
            contract_1=(0, 1), notcontract_1=(2,),
            contract_2=(0, 1), notcontract_2=(2, 3),
            map_1=(0,), map_2=(1, 2),
        )

        ref = 0.2 * torch.einsum("ijk,ijlm->klm", d1, d2) + 0.8 * d3
        got = out.to_dense()
        err = float((got - ref).abs().max())
        scale = max(float(ref.abs().max()), 1.0)
        cs = float((got.double() ** 2).sum())
        print(f"(13|2)x(54|21)=(3|45): out blocks={out.nblks} "
              f"shape={tuple(int(s) for s in got.shape)} max_err={err:.2e}")
        print(f"checksum(T3) = {cs:.15e}")

        # expected-output checks
        assert tuple(got.shape) == (sum(blk3), sum(blk4), sum(blk5))
        assert err <= 1e-12 * scale, "diverges from the dense einsum oracle"
        # beta=0.8 keeps t3's preexisting blocks; the product adds more
        assert out.nblks >= len(nz33)
        print("OK — reference tensor example 2 semantics reproduced")
        result = {"blocks": out.nblks, "shape": tuple(got.shape), "max_err": err,
                  "checksum": cs, "routes": routes()}
    dt.finalize_lib()
    return result


if __name__ == "__main__":
    main()
