"""``multiply("N", "N", 1.0, A_k, B, filter_eps=eps)`` with ``A_k =
A.with_data(new data)``, as CP2K calls it every step: host norms, the
filtered symbolic product, the product and the final ``filter_blocks``; C
compacted to the kept blocks. The first call, which plans the pattern,
belongs to set-up."""
from benchmark import products

COMPARED = products.COMPARED


class Program:
    def __init__(self, cfg, ops, grid=None):
        self.a, self.b = products.matrices(cfg, ops)
        self.eps = float(cfg["eps"])
        self.like = ops.pattern

    def __call__(self, a_data):
        import dbcsr_tpu_torch as dt

        return dt.multiply("N", "N", 1.0, self.a.with_data(a_data), self.b,
                           filter_eps=self.eps)

    def output(self, out):
        return products.blocks_of(out.index, self.like), out.data

    def release(self) -> None:
        self.a = self.b = None


def judge(cfg, ops):
    return products.judge(cfg, ops, filtered=True)


def Control(cfg, ops):
    return products.Control(cfg, ops, filtered=True, compact=True)
