"""Example 3 (PyTorch port): the reference's canonical workload.

The counterpart of ``examples/example_3_sparse_1000.py``: 1000x1000
matrices with uniform 5x5 blocks at ~10% occupancy
(``examples/dbcsr_example_3.F:89-167``), multiplied with filtering; then
the plan-once executor for iterative reuse, timed as the median of 10
calls (CUDA events on the card, the host clock on the CPU; the
line says which), with the route it took and its kernel launches.

    python examples/torch/example_3_sparse_1000.py              # on the card
    python examples/torch/example_3_sparse_1000.py --device cpu
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from _common import parser, routes, session  # noqa: E402

REPS = 10  # timed executor calls


def main(argv=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    import dbcsr_tpu_torch as dt
    from dbcsr_tpu_torch.autotune import steady_state_time
    from dbcsr_tpu_torch.mm import kernel_launches, launches_since

    with session(args) as dev:
        rng = np.random.default_rng(0)
        sizes = np.full(200, 5, dtype=np.int32)  # 200 x 5 = 1000

        a = dt.random_matrix(sizes, sizes, 0.10, rng, dtype=np.float64, name="A", device=dev)
        b = dt.random_matrix(sizes, sizes, 0.10, rng, dtype=np.float64, name="B", device=dev)

        c, flops = dt.multiply("N", "N", 1.0, a, b, filter_eps=1e-12, return_flops=True)
        print(f"C: {c.nblks} blocks, occupation {c.occupation():.3f}, "
              f"effective flops {flops:.3e}")
        one_shot = routes()

        # iterative callers plan once and execute many times
        fn, c_index, _ = dt.build_multiply_executor("N", "N", a, b)
        before = kernel_launches()
        fn(a.data, b.data)
        launched = launches_since(before)
        ms = steady_state_time(fn, (a.data, b.data), reps=REPS, warmup=1) * 1e3
        clock = "CUDA events" if dev.type == "cuda" else "host perf_counter, CPU"
        print(f"steady-state multiply: {ms:.2f} ms ({flops / ms / 1e6:.1f} effective "
              f"GFLOP/s; median of {REPS} calls, {clock})")
        print(f"executor route {fn.plan.route}, kernel launches a call {launched or 'none'}")
        out = {"c_blocks": c.nblks, "occupation": c.occupation(), "eff_flops": flops,
               "ms": ms, "clock": clock, "route": fn.plan.route, "routes": one_shot,
               "launches": launched}
    dt.finalize_lib()
    return out


if __name__ == "__main__":
    main()
