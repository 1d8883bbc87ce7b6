"""Large-scale check (PyTorch port): a banded BCSR multiply at production
scale, exercising the native host planners, the store layout, the engine
and the kernels, with each phase's time.

The counterpart of ``tools/large_scale_check.py``. ``nrows`` counts ROWS:
``random_block_sizes`` splits them into blocks of 5, 13 and 23 rows (about
``nrows / 13.7`` block rows), and each block pair within ``bandwidth``
blocks of the diagonal is stored with probability 1/2, from seed 0 — the
JAX tool's pattern, draw for draw, so the two agree on every count. The
data is drawn in store form from a seeded ``torch.Generator`` on the
device, times the store's validity mask; B = A·0.5.

Readings: set-up s (pattern and index, as the JAX tool counts it),
``store_layout`` s, tiles, store MB, ``operands_s`` (the whole set-up: the
pattern, the index, the layout and both operands' data on the device,
synchronised), the first one-shot ``multiply`` s (planning included), the
executor's build s (``build_multiply_executor`` alone, the plan cache
cleared first), its first call s,
and its steady-state median over 10 calls (CUDA events on the card; the
host clock on the CPU, and the result says which), effective
TFLOP/s, the route and the kernel launches of one executor call, the tuned
class the card's parameter table matched (and its distance), host peak RSS
(sampled while the tool runs) and peak device memory.

    python tools/torch/large_scale_check.py [nrows] [bandwidth] [--device cuda|cpu]
        [--dtype float32|float64]
"""
import argparse
import os
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

TILE = 128
REPS = 10  # timed executor calls of the steady-state median


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def banded_pattern(nrows: int, bandwidth: int, seed: int = 0):
    """(block sizes, block rows, block cols) of the JAX tool's pattern: the
    same generator draws in the same order (row-major over the band)."""
    import dbcsr_tpu_torch as dt

    rng = np.random.default_rng(seed)
    rbs = dt.random_block_sizes(nrows, [5, 13, 23], rng)
    n = len(rbs)
    i = np.arange(n, dtype=np.int64)
    lo = np.maximum(0, i - bandwidth)
    width = np.minimum(n, i + bandwidth + 1) - lo
    rows = np.repeat(i, width)
    cols = np.arange(len(rows), dtype=np.int64) - np.repeat(np.cumsum(width) - width, width)
    cols += np.repeat(lo, width)
    keep = rng.random(len(rows)) < 0.5
    return rbs, rows[keep], cols[keep]


def build(nrows: int, bandwidth: int, device, dtype=torch.float32, seed: int = 0):
    """(A, B, readings): the operands on ``device`` and the set-up readings."""
    from dbcsr_tpu_torch.block.bcsr import BCSRMatrix
    from dbcsr_tpu_torch.block.index import build_index
    from dbcsr_tpu_torch.block.store import store_layout
    from dbcsr_tpu_torch.block.tileops import valid_mask
    from dbcsr_tpu_torch.core.machine import program_device
    from dbcsr_tpu_torch.native import native_available, native_grid_cap

    dev = program_device(device)
    out = {"nrows": nrows, "bandwidth": bandwidth, "device": str(dev),
           "dtype": str(dtype).replace("torch.", "")}
    t0 = t_all = time.perf_counter()
    rbs, rows, cols = banded_pattern(nrows, bandwidth, seed)
    idx, _ = build_index(rows, cols, rbs, rbs)
    out["setup_s"] = time.perf_counter() - t0
    out["blocks"] = idx.nblks
    # the native planner lays the store out up to its grid cap, past it
    # the numpy path does (and the element map's temporaries grow)
    grid = -(-idx.nfullrows // TILE)
    out["tile_grid"] = [grid, grid]
    out["native_layout"] = native_available() and grid * grid <= native_grid_cap(idx)

    t0 = time.perf_counter()
    lay = store_layout(idx, TILE)
    out["store_layout_s"] = time.perf_counter() - t0
    out["n_tiles"] = lay.n_tiles
    out["store_mb"] = round(lay.n_tiles * TILE * TILE * 4 / 1e6)  # the JAX tool's float32 MB

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    data = torch.randn((lay.n_tiles, TILE, TILE), generator=gen, device=dev, dtype=dtype)
    data *= valid_mask(idx, TILE, dev).to(dtype)
    a = BCSRMatrix(name="A", index=idx, data=data)
    b = BCSRMatrix(name="B", index=idx, data=data * 0.5)
    _sync(dev)
    out["operands_s"] = time.perf_counter() - t_all
    return a, b, out


def measure(a, b, driver: str = "auto"):
    """One leg: the one-shot multiply, then the plan-once executor under
    ``mm_driver=driver`` ("auto": the library's default, tuned on a card
    with a parameter table). Returns (readings, the executor, C's index, the
    executor's C store)."""
    import dbcsr_tpu_torch as dt
    from dbcsr_tpu_torch import autotune
    from dbcsr_tpu_torch.mm import kernel_launches, launches_since
    from dbcsr_tpu_torch.mm.plancache import get_plan_cache

    dev = a.device
    out = {"driver": driver}
    hit = autotune.tuned_class(a.index, b.index, dev) if driver == "auto" else None
    out["tuned_class"] = None if hit is None else {"class": hit[0], "distance": hit[1]}
    # "auto" stays at its default provenance, so that the card's tuned
    # table may choose the driver (an explicit setting overrides the table)
    with dt.config_override(**({} if driver == "auto" else {"mm_driver": driver})):
        t0 = time.perf_counter()
        c, fl = dt.multiply("N", "N", 1.0, a, b, return_flops=True)
        _sync(dev)
        out["first_multiply_s"] = time.perf_counter() - t0
        out["eff_flops"] = fl
        out["c_blocks"] = c.nblks
        del c

        get_plan_cache().clear()  # a cold build, as for a new pattern
        t0 = time.perf_counter()
        fn, c_index, _ = dt.build_multiply_executor("N", "N", a, b)
        out["executor_build_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        before = kernel_launches()
        prod = fn(a.data, b.data)
        _sync(dev)
        out["executor_first_call_s"] = time.perf_counter() - t0
    out["route"] = fn.plan.route
    out["launches"] = launches_since(before)
    ms = autotune.steady_state_time(fn, (a.data, b.data), reps=REPS, warmup=1) * 1e3
    out["executor_median_ms"] = ms
    out["clock"] = "CUDA events" if dev.type == "cuda" else "host perf_counter"
    out["eff_tflops"] = fl / (ms * 1e-3) / 1e12
    return out, fn, c_index, prod


class PeakRSS:
    """The largest resident set of this process while the block runs,
    sampled from ``/proc`` every 10 ms (``m_memory``). The process
    high-water mark (``m_peak_memory``) is no substitute where ``/proc``
    has no VmHWM: getrusage's maxrss then also counts the peak of the
    process that spawned this one."""

    def __enter__(self):
        from dbcsr_tpu_torch.core.machine import m_memory

        self.peak, self._stop = m_memory(), threading.Event()

        def sample():
            while not self._stop.wait(0.01):
                self.peak = max(self.peak, m_memory())

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        from dbcsr_tpu_torch.core.machine import m_memory

        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, m_memory())


def run(nrows: int = 100000, bandwidth: int = 8, *, device="cuda",
        dtype=torch.float32) -> dict:
    import dbcsr_tpu_torch as dt
    from dbcsr_tpu_torch.core.machine import m_peak_memory, program_device

    dt.init_lib()
    dev = program_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with PeakRSS() as rss:
        a, b, out = build(nrows, bandwidth, dev, dtype)
        leg, _, _, _ = measure(a, b)
    out.update(leg)
    out["host_peak_rss_mb"] = rss.peak / 1e6
    out["host_hwm_mb"] = m_peak_memory() / 1e6
    out["device_peak_mb"] = (torch.cuda.max_memory_allocated(dev) / 1e6
                             if dev.type == "cuda" else None)
    print(out)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("nrows", type=int, nargs="?", default=100000)
    ap.add_argument("bandwidth", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda", help="cuda (the default), cuda:N or cpu")
    ap.add_argument("--dtype", default="float32", choices=("float32", "float64"))
    args = ap.parse_args(argv)
    return run(args.nrows, args.bandwidth, device=args.device,
               dtype=getattr(torch, args.dtype))


if __name__ == "__main__":
    main()
