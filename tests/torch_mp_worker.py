"""Worker of the multi-process battery of the PyTorch port
(``tests/test_torch_multiprocess.py``), the counterpart of
``tests/mp_worker.py``: the ten scenarios of the JAX package's battery
(cannon, summa, cannon25d, summa25d, tas, sharded, sharded_elementwise,
checkpoint, tensor, complex), the self-test ``testing.test_dist``, unit
checks of the transport (``comm``) and of the logger, and the filtered step
over a grid (``filtered_cannon``, held against the benchmark's plain
reference), over ``torch.distributed`` (``gloo``) on the CPU.

Each process first runs every named scenario alone, with no world up (the
port's single-process virtual ranks on the same grids), then brings the
world up with ``init_lib(distributed=True)`` and runs them again across
the processes. A scenario's result must be bitwise equal to the
single-process one (every entry this process holds) and within the stated
tolerance of the JAX package's product, which the parent computed from the
same numpy inputs (``inputs_<name>.npz``, ``ref_<name>.npz``). Plan hashes
are written for the parent to compare across processes. The worker imports
no jax and nothing of ``dbcsr_tpu/``.

Usage: python torch_mp_worker.py <init_url> <process_id> <num_processes>
       <data_dir> <out_dir> <scenario,...>
"""
import hashlib
import io
import json
import os
import sys
import traceback

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import dbcsr_tpu_torch as dt  # noqa: E402
from dbcsr_tpu_torch.core.config import config_override  # noqa: E402
from dbcsr_tpu_torch.dist import comm  # noqa: E402
from dbcsr_tpu_torch.testing import matrix_from_arrays, tensor_from_arrays  # noqa: E402

TILE = 8
CPU = torch.device("cpu")
#: the bound against the JAX package's product, by the result's type
RTOL = {torch.float32: 1e-5, torch.float64: 1e-12, torch.complex128: 1e-12}


def grid(*shape):
    from dbcsr_tpu_torch.dist import ProcessGrid

    return ProcessGrid.make(*shape, devices=[CPU] * int(np.prod(shape)))


def matrix(z, prefix: str, name: str):
    return matrix_from_arrays(z[f"{prefix}_rbs"], z[f"{prefix}_cbs"], z[f"{prefix}_rows"],
                              z[f"{prefix}_cols"], z[f"{prefix}_data"], device=CPU,
                              name=name)


def plan_hash(*arrays) -> str:
    h = hashlib.blake2b(digest_size=16)
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# scenarios: each returns (exact, dense, extra) — ``exact`` the results to
# hold bitwise against the single-process run, ``dense`` {name: array} to
# hold against the JAX package's reference of that name, ``extra`` facts
# for the parent (plan hashes)
# ---------------------------------------------------------------------------

def _multiply_over(z, shape, algo):
    from dbcsr_tpu_torch.dist import tile_aligned_dist
    from dbcsr_tpu_torch.mm.engine import build_distributed_executor

    a, b = matrix(z, "a", "A"), matrix(z, "b", "B")
    rbs = a.row_block_sizes
    dist = tile_aligned_dist(grid(*shape), rbs, rbs, TILE)
    with config_override(mm_dist_algo=algo):
        c = dt.multiply("N", "N", 1.0, a, b, dist=dist)
    fn, c_index, _ = build_distributed_executor("N", "N", a, b, dist, algo=algo)
    store = fn(a.data, b.data)
    hp = fn.host_plan
    exact = {"multiply": c.data, "executor": store}
    dense = {"c": c.to_dense().numpy(),
             "c_exec": dt.BCSRMatrix(name="c", index=c_index, data=store).to_dense().numpy()}
    return exact, dense, {"plan_hash": plan_hash(hp.stacks, hp.a_pack, hp.b_pack,
                                                 hp.c_unpack)}


def scenario_cannon(z, ctx):
    return _multiply_over(z, (2, 2), "cannon")


def scenario_summa(z, ctx):
    return _multiply_over(z, (4, 2), "summa")


def scenario_cannon25d(z, ctx):
    return _multiply_over(z, (2, 2, 2), "cannon")


def scenario_summa25d(z, ctx):
    return _multiply_over(z, (2, 2, 2), "summa")


def scenario_tas(z, ctx):
    """TAS groups over the world's processes: the m (auto) and k splits over
    eight groups, and two groups of 2×2 SUMMA sub-grids."""
    from dbcsr_tpu_torch.tas import tas_multiply_parallel, tas_multiply_subgrid

    a, b = matrix(z, "a", "A"), matrix(z, "b", "B")
    cm = tas_multiply_parallel(a, b, long_dim="auto", nsplit=8, devices=[CPU] * 8)
    ck = tas_multiply_parallel(a, b, long_dim="k", nsplit=8, devices=[CPU] * 8)
    cs = tas_multiply_subgrid(a, b, long_dim="m", nsplit=2, subgrid=(2, 2),
                              devices=[CPU] * 8)
    exact = {"m": cm.data, "k": ck.data, "subgrid": cs.data}
    dense = {"c": cm.to_dense().numpy(), "c_k": ck.to_dense().numpy(),
             "c_subgrid": cs.to_dense().numpy()}
    return exact, dense, {}


def scenario_sharded(z, ctx):
    """The sharded executor: this process's shards of C (bitwise), the
    gathered C against the JAX product, and the plan hash."""
    from dbcsr_tpu_torch.dist import tile_aligned_dist
    from dbcsr_tpu_torch.dist.sharded import shard_store_with_layout, unshard_store_with_layout
    from dbcsr_tpu_torch.mm.engine import build_distributed_executor

    a, b = matrix(z, "a", "A"), matrix(z, "b", "B")
    g = grid(2, 4)
    dist = tile_aligned_dist(g, a.row_block_sizes, a.row_block_sizes, TILE)
    fn, c_index, _ = build_distributed_executor("N", "N", a, b, dist, algo="summa",
                                                sharded=True)
    a_sh = shard_store_with_layout(a, fn.shard_a, g)
    b_sh = shard_store_with_layout(b, fn.shard_b, g)
    held = [x is not None for x in a_sh]
    out = fn(a_sh, b_sh)
    store = unshard_store_with_layout(out, fn.shard_c, TILE, CPU, grid=g, dtype=a.dtype)
    hp = fn.host_plan
    exact = {"shards": out, "store": store}
    dense = {"c": dt.BCSRMatrix(name="c", index=c_index, data=store).to_dense().numpy()}
    return exact, dense, {"plan_hash": plan_hash(hp.stacks, hp.a_pack, hp.b_pack,
                                                 hp.c_unpack),
                          "held_shards": held}


def scenario_sharded_elementwise(z, ctx):
    from dbcsr_tpu_torch.dist import tile_aligned_dist
    from dbcsr_tpu_torch.dist.sharded_ops import (
        shard_matrix, sharded_add, sharded_block_norms, sharded_filter, sharded_frobenius,
        sharded_hadamard, sharded_maxabs, sharded_trace,
    )

    a, b = matrix(z, "a", "A"), matrix(z, "b", "B")
    dist = tile_aligned_dist(grid(2, 2), a.row_block_sizes, a.row_block_sizes, TILE)
    sa, sb = shard_matrix(a, dist), shard_matrix(b, dist)
    sc = sharded_filter(sharded_add(1.0, sa, -0.5, sa), 1e-8)
    sh = sharded_hadamard(sa, sb)
    half, had = sc.to_local(), sh.to_local()
    fro, tr, mx = sharded_frobenius(sa), sharded_trace(sa), sharded_maxabs(sa)
    exact = {"half": half.data, "hadamard": had.data, "shards": sh.data,
             "norms": torch.from_numpy(sharded_block_norms(sa)),
             "scalars": torch.tensor([fro, tr, mx], dtype=torch.float64)}
    dense = {"half": half.to_dense().numpy(), "hadamard": had.to_dense().numpy(),
             "fro_trace": np.array([fro, tr])}
    return exact, dense, {}


def scenario_checkpoint(z, ctx):
    """Each process writes its shards (the holder of shard 0 the index),
    then reads its shards back: bitwise, and a zero residual."""
    from dbcsr_tpu_torch.dist import (
        sharded_checkpoint_read, sharded_checkpoint_write, tile_aligned_dist,
    )
    from dbcsr_tpu_torch.dist.sharded_ops import shard_matrix, sharded_add, sharded_frobenius

    a = matrix(z, "a", "A")
    g = grid(2, 4)
    dist = tile_aligned_dist(g, a.row_block_sizes, a.row_block_sizes, TILE)
    sm = shard_matrix(a, dist)
    ckdir = os.path.join(ctx["out"], f"ckpt_{ctx['mode']}")
    sharded_checkpoint_write(sm, ckdir)
    back = sharded_checkpoint_read(ckdir, g)
    same = all((x is None and y is None) or torch.equal(x, y)
               for x, y in zip(back.data, sm.data))
    resid = sharded_frobenius(sharded_add(1.0, back, -1.0, sm))
    assert same and resid == 0.0, (same, resid)
    local = back.to_local()
    exact = {"shards": back.data, "store": local.data}
    return exact, {"a": local.to_dense().numpy()}, {}


def scenario_tensor(z, ctx):
    """contract -> TAS -> the distributed multiply over a 2×2 grid that spans
    the processes (folded dims distributed)."""
    from dbcsr_tpu_torch.dist import tile_aligned_dist
    from dbcsr_tpu_torch.tensors import contract

    def tensor(p):
        nd = int(z[f"{p}_ndim"])
        return tensor_from_arrays([z[f"{p}_bs{d}"] for d in range(nd)], z[f"{p}_map1"],
                                  z[f"{p}_map2"], z[f"{p}_rows"], z[f"{p}_cols"],
                                  z[f"{p}_flat"], dtype=np.float64, device=CPU, tile=TILE)

    t, m = tensor("t"), tensor("m")
    dist = tile_aligned_dist(grid(2, 2), t.matrix.index.row_block_sizes, z["m_bs1"], TILE)
    out = contract(1.0, t, m, contract_1=(2,), notcontract_1=(0, 1), contract_2=(0,),
                   notcontract_2=(1,), dist=dist, nsplit=1)
    return {"out": out.matrix.data}, {"out": out.to_dense().numpy()}, {}


def scenario_complex(z, ctx):
    """complex128 sharded ops across processes: ``sharded_multiply('C', 'N')``
    with a complex alpha (the port holds complex natively: KC2's job)."""
    from dbcsr_tpu_torch.dist import tile_aligned_dist
    from dbcsr_tpu_torch.dist.sharded_ops import shard_matrix, sharded_frobenius, sharded_multiply

    a, b = matrix(z, "a", "A"), matrix(z, "b", "B")
    dist = tile_aligned_dist(grid(2, 2), a.row_block_sizes, a.row_block_sizes, TILE)
    sa, sb = shard_matrix(a, dist), shard_matrix(b, dist)
    sc = sharded_multiply("C", "N", 1.0 + 0.5j, sa, sb)
    c = sc.to_local()
    fro = sharded_frobenius(sa)
    exact = {"shards": sc.data, "store": c.data,
             "fro": torch.tensor([fro], dtype=torch.float64)}
    return exact, {"c": c.to_dense().numpy(), "fro": np.array([fro])}, {}


def water_case(replicas, tile: int, seed: int, drop: float = 0.4):
    """The benchmark's water pattern at a small box (blocks to 4.6 Å, so a
    single 32-molecule cell is admitted), its float64 operands on the CPU,
    and an eps between two reference block norms² at the ``drop`` quantile
    of C's superset (no block near a tie). Returns (cfg, ops, A, B, eps,
    reference product)."""
    import json

    from benchmark import products
    from benchmark.operands import make_operands, pattern_of
    from benchmark.reference.product import Product, sq

    with open(os.path.join(REPO, "benchmark", "configs", "water_2048.json")) as f:
        cfg = json.load(f)
    cfg.update(replicas=list(replicas), decay_per_angstrom=2.5, tile=tile)
    pat = pattern_of(cfg)
    ops = make_operands(cfg, pat, seed, 1, CPU)
    a, b = products.matrices(cfg, ops)
    ref = Product(ops.pattern, ops.keys, ops.b, torch.float64)
    acc = torch.zeros((ref.nb + 1, ref.nb + 1), dtype=torch.float64)
    for t0, r in ref.rows(ops.a[0]):
        acc += ref.sums(sq(r), t0)
    sup = ref.bound(ops.a[0]) > 0
    nsq = np.sort(acc[:-1, :-1][sup].numpy())
    k = int(drop * len(nsq))
    eps = float(np.sqrt(np.sqrt(nsq[k - 1] * nsq[k])))
    return cfg, ops, a, b, eps, ref


def scenario_filtered_cannon(z, ctx):
    """``build_filtered_executor(..., dist=)`` over a 2×2 grid on a water
    box: this process's C shards, keep and norms² (bitwise against the
    single-process virtual ranks), and its held tiles within the per-shard
    judge's limit of the plain reference."""
    from dbcsr_tpu_torch.dist import tile_aligned_dist
    from dbcsr_tpu_torch.dist.sharded import shard_store_with_layout

    from benchmark import products
    from benchmark.reference.layout import tile_keys
    from benchmark.reference.shards import Held, RowsProduct, held_block_err

    cfg, ops, a, b, eps, _ = water_case((2, 1, 1), 32, 17)
    g = grid(2, 2)
    ex = dt.build_filtered_executor("N", "N", a, b, eps,
                                    dist=tile_aligned_dist(g, a.row_block_sizes,
                                                           a.row_block_sizes, 32))
    c, keep, nsq = ex.step(shard_store_with_layout(a, ex.shard_a, g))
    sl = ex.shard_c
    keys = tile_keys(products.blocks_of(ex.c_index, ops.pattern), 32)
    counts = np.bincount(sl.owner_of_slot, minlength=sl.ndev)
    ref = RowsProduct(ops.pattern, ops.keys, ops.b, torch.float64)
    for d, x in enumerate(c):
        if x is not None:
            held = Held(keys=keys[sl.slot_of_pos[d * sl.n_max:d * sl.n_max + counts[d]]])
            err = held_block_err(ref, ops.a[0], held, x[:counts[d]], eps,
                                 cfg["norm_tie_rel"])
            assert err <= 1e-10, (d, err)
    return {"c": c, "keep": keep, "nsq": nsq}, {}, {"spanning": ex.spanning}


def scenario_selftest(z, ctx):
    """``testing.test_dist`` as it is: every process takes part, every
    process checks."""
    from dbcsr_tpu_torch.testing import test_dist

    assert test_dist(CPU), "test_dist failed"
    return {}, {}, {}


def scenario_comm(z, ctx):
    """The transport's steps against their single-process results: a ring
    shift of two piece lists, SUMMA's gathers and the ordered layer sum
    with absent partials, on a 2×2×2 grid; scalars in rank order."""
    g = grid(2, 2, 2)
    ranks = g.ranks()
    gen = torch.Generator().manual_seed(5)
    full = [torch.randn((3, TILE, TILE), generator=gen, dtype=torch.float64)
            for _ in ranks]
    cfull = [torch.randn((2, TILE, TILE), generator=gen, dtype=torch.complex128)
             for _ in ranks]
    pieces = [x if g.is_local(*rk) else None for x, rk in zip(full, ranks)]
    cpieces = [x if g.is_local(*rk) else None for x, rk in zip(cfull, ranks)]

    def rk(i, j, l):
        return (i * 2 + j) * 2 + l

    src_a = [rk(i, (j + 1) % 2, l) for (i, j, l) in ranks]
    src_b = [rk((i + 1) % 2, j, l) for (i, j, l) in ranks]
    sa, sb = comm.shift(g, [(pieces, src_a, (3, TILE, TILE), torch.float64),
                            (cpieces, src_b, (2, TILE, TILE), torch.complex128)])
    rows = comm.gather_along(g, pieces, [[rk(i, k, l) for k in range(2)]
                                         for (i, j, l) in ranks], (3, TILE, TILE),
                             torch.float64)
    present = [r % 3 != 1 for r in range(len(ranks))]
    parts = [None if not (present[r] and g.is_local(*ranks[r])) else x.clone()
             for r, x in enumerate(full)]
    sums = [(rk(i, j, 0), [rk(i, j, l) for l in range(2)]) for i in range(2)
            for j in range(2)]
    summed = comm.ordered_sum(g, parts, present, sums, (3, TILE, TILE), torch.float64)
    owners = g.owner_list()
    vals = [float(x.sum()) if g.is_local(*r_) else None for x, r_ in zip(full, ranks)]
    scal = comm.gather_scalars(vals, owners, False)
    exact = {"shift_a": sa, "shift_b": sb, "rows": rows, "summed": summed,
             "scalars": torch.tensor(scal, dtype=torch.float64)}
    return exact, {}, {}


def scenario_logger(z, ctx):
    """The logger prints on its I/O process only."""
    from dbcsr_tpu_torch.core.logging import Logger

    outs = []
    for io_process in range(2):
        buf = io.StringIO()
        Logger(stream=buf, io_process=io_process).note("hello")
        outs.append(buf.getvalue())
    me = comm.rank()
    for io_process, text in enumerate(outs):
        assert ("hello" in text) == (io_process == me), (me, io_process, text)
    return {}, {}, {"printed": ["hello" in t for t in outs]}


SCENARIOS = {
    "cannon": scenario_cannon,
    "summa": scenario_summa,
    "cannon25d": scenario_cannon25d,
    "summa25d": scenario_summa25d,
    "tas": scenario_tas,
    "sharded": scenario_sharded,
    "sharded_elementwise": scenario_sharded_elementwise,
    "checkpoint": scenario_checkpoint,
    "tensor": scenario_tensor,
    "complex": scenario_complex,
    "filtered_cannon": scenario_filtered_cannon,
    "selftest": scenario_selftest,
    "comm": scenario_comm,
    "logger": scenario_logger,
}


def _flat(x, prefix=""):
    """(name, tensor or None) pairs of a result (lists flattened)."""
    if isinstance(x, dict):
        for k, v in x.items():
            yield from _flat(v, f"{prefix}{k}/")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from _flat(v, f"{prefix}{i}/")
    else:
        yield prefix, x


def bitwise_same(single: dict, multi: dict) -> list:
    """Names of the entries this process holds that differ from the
    single-process run (an entry None here belongs to another process)."""
    ref = dict(_flat(single))
    bad = []
    for name, x in _flat(multi):
        y = ref.get(name)
        if x is None:
            continue
        if y is None or x.dtype != y.dtype or x.shape != y.shape or not torch.equal(x, y):
            bad.append(name)
    return bad


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    if ref.size == 0:
        return 0.0
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def main() -> int:
    url, pid, nprocs = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    data_dir, out_dir = sys.argv[4], sys.argv[5]
    names = sys.argv[6].split(",")
    torch.set_num_threads(1)
    dt.set_config(tile_size=TILE)
    report = {}

    def load(name):
        path = os.path.join(data_dir, f"inputs_{name}.npz")
        return np.load(path) if os.path.exists(path) else None

    def write():
        with open(os.path.join(out_dir, f"report_{pid}.json"), "w") as f:
            json.dump(report, f)

    try:
        single = {}
        for name in names:  # the single-process run: no world up
            single[name] = SCENARIOS[name](load(name), {"out": out_dir,
                                                        "mode": f"single_{pid}"})[0]
        dt.init_lib(distributed=True, coordinator_address=url, num_processes=nprocs,
                    process_id=pid, backend="gloo", device="cpu")
        assert comm.world_size() == nprocs and comm.rank() == pid
        for name in names:
            comm.barrier()  # lockstep: no process runs ahead into the next scenario
            comm.reset_transfer_counts()
            exact, dense, extra = SCENARIOS[name](load(name), {"out": out_dir, "mode": "mp"})
            entry = dict(extra)
            moved = comm.transfer_counts()
            entry["moved"] = [moved.messages, moved.bytes_sent, moved.bytes_received]
            entry["not_bitwise"] = bitwise_same(single[name], exact)
            refs = (np.load(os.path.join(data_dir, f"ref_{name}.npz"))
                    if dense else {})
            errs = {}
            for k, v in dense.items():
                bound = RTOL[torch.from_numpy(np.asarray(refs[k])).dtype]
                errs[k] = (rel_err(v, refs[k]), bound)
            entry["errors"] = errs
            entry["ok"] = (not entry["not_bitwise"]
                           and all(e <= b for e, b in errs.values()))
            report[name] = entry
            print(f"scenario {name} {'ok' if entry['ok'] else 'FAILED'}", flush=True)
        dt.finalize_lib()
        import torch.distributed as tdist

        report["_finalized"] = not tdist.is_initialized() and not comm.is_up()
    except Exception:
        report["_error"] = traceback.format_exc()
        write()
        raise
    write()
    print(f"worker {pid} ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
