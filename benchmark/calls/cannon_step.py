"""``build_distributed_executor(..., algo="cannon")`` over the
configuration's process grid with a tile-aligned distribution, on new A
data each step; every process calls it and gets the whole C, no filter."""
from benchmark import products

COMPARED = products.COMPARED


class Program:
    def __init__(self, cfg, ops, grid=None):
        import dbcsr_tpu_torch as dt
        from dbcsr_tpu_torch.dist import tile_aligned_dist

        a, b = products.matrices(cfg, ops)
        dist = tile_aligned_dist(grid, a.row_block_sizes, a.row_block_sizes, int(cfg["tile"]))
        self.fn, c_index, _ = dt.build_distributed_executor("N", "N", a, b, dist,
                                                            algo="cannon")
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
