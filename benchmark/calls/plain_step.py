"""``build_multiply_executor("N", "N", A, B)`` on new A data each step, no
filter: C over its superset index."""
from benchmark import products

COMPARED = products.COMPARED


class Program:
    def __init__(self, cfg, ops, grid=None):
        import dbcsr_tpu_torch as dt

        a, b = products.matrices(cfg, ops)
        self.fn, c_index, _ = dt.build_multiply_executor("N", "N", a, b)
        self.b = ops.b
        self.c_blocks = products.blocks_of(c_index, ops.pattern)

    def __call__(self, a_data):
        return self.fn(a_data, self.b)

    def output(self, out):
        return self.c_blocks, out

    def release(self) -> None:
        self.fn = None


def judge(cfg, ops):
    return products.judge(cfg, ops, filtered=False)


def Control(cfg, ops):
    return products.Control(cfg, ops, filtered=False, compact=False)
