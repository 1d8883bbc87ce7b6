"""``build_filtered_executor("N", "N", A, B, eps).step`` on new A data each
step: the superset product, block norms and the keep mask; C in mask form
(C's superset index, dropped blocks zero)."""
from benchmark import products

COMPARED = products.COMPARED


class Program:
    def __init__(self, cfg, ops, grid=None):
        import dbcsr_tpu_torch as dt

        a, b = products.matrices(cfg, ops)
        ex = dt.build_filtered_executor("N", "N", a, b, float(cfg["eps"]))
        self.b, self.fn = ops.b, ex.step
        self.c_blocks = products.blocks_of(ex.c_index, ops.pattern)

    def __call__(self, a_data):
        return self.fn(a_data, self.b)[0]

    def output(self, out):
        return self.c_blocks, out

    def release(self) -> None:
        self.fn = None


def judge(cfg, ops):
    return products.judge(cfg, ops, filtered=True)


def Control(cfg, ops):
    return products.Control(cfg, ops, filtered=True, compact=False)
