"""The harness is driven by data: a configuration, a pattern kind, a
traffic mix with a call of its own (program call, reference and control)
and a metric dropped into a copy of the folders are found by their names
with no edit to a file that is there; and the roofline's work count reads
the same whatever tile edge or driver the program takes."""
import hashlib
import json
import os

import numpy as np
import pytest

from conftest import BIG_SEED, REPO, TINY, tiny_copy

from benchmark.harness import run
from benchmark.operands import pattern_of
from benchmark.workcount import product_work

WORK_READER = '''"""Work of the product the inputs need (GFLOP)."""


def read(ctx):
    return ctx.work.flops / 1e9
'''
BYTES_READER = WORK_READER.replace("flops / 1e9", "bytes / 1e9").replace("GFLOP", "GB")

#: a pattern kind: a chain of equal blocks, each coupled to its neighbours
CHAIN = '''"""A chain of ``blocks`` blocks of ``size`` rows, block i coupled to
i-1, i and i+1, scaled by 0.5 off the diagonal."""
import numpy as np

from benchmark.operands import Pattern
from benchmark.reference.layout import Blocks


def make(cfg):
    n, size = int(cfg["blocks"]), int(cfg["size"])
    i = np.repeat(np.arange(n, dtype=np.int64), 3)
    j = i + np.tile(np.array([-1, 0, 1]), n)
    ok = (j >= 0) & (j < n)
    i, j = i[ok], j[ok]
    sizes = np.full(n, size, dtype=np.int64)
    return Pattern(blocks=Blocks(rows=i, cols=j, row_sizes=sizes, col_sizes=sizes),
                   scale=np.where(i == j, 1.0, 0.5))
'''

#: a call with a reference of its own: C = 2·A·B by the one-shot multiply,
#: judged by the largest element gap against a dense float64 product
DOUBLED = '''"""``multiply("N", "N", 2.0, A, B)``, C compacted, judged elementwise."""
import torch

from benchmark import products
from benchmark.reference.layout import dense_rows, tile_keys

COMPARED = "max_gap"


def _dense(blocks, store, tile):
    keys = tile_keys(blocks, tile)
    n = int(blocks.row_sizes.sum())
    nt = -(-n // tile)
    return dense_rows(store, keys, nt, 0, nt)[:n, :n]


class Program:
    def __init__(self, cfg, ops, grid=None):
        self.a, self.b = products.matrices(cfg, ops)
        self.like = ops.pattern

    def __call__(self, a_data):
        import dbcsr_tpu_torch as dt

        return dt.multiply("N", "N", 2.0, self.a.with_data(a_data), self.b)

    def output(self, out):
        return products.blocks_of(out.index, self.like), out.data

    def release(self):
        self.a = self.b = None


def judge(cfg, ops):
    tile = int(cfg["tile"])
    b = _dense(ops.pattern, ops.b, tile)

    def err(a_store, blocks, store):
        want = 2.0 * (_dense(ops.pattern, a_store, tile) @ b)
        return float((_dense(blocks, store, tile) - want).abs().max())

    return err


class Control(Program):
    def __init__(self, cfg, ops, grid=None):
        self.like, self.tile, self.b = ops.pattern, int(cfg["tile"]), ops.b

    def __call__(self, a_data):
        from benchmark.reference.layout import write_rows

        p, t = self.like, self.tile
        c = 2.0 * (_dense(p, a_data, t).float() @ _dense(p, self.b, t).float())
        keys = tile_keys(p, t)
        n = c.shape[0]
        nt = -(-n // t)
        pad = torch.zeros((nt * t, nt * t), dtype=torch.float64)
        pad[:n, :n] = c
        store = torch.zeros((len(keys), t, t), dtype=torch.float64)
        write_rows(store, keys, nt, 0, pad)
        return p, store

    def output(self, out):
        return out
'''


def digests(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def add_cell(root: str, here: str, *, config: str, cfg: dict, traffic: str, mix: dict,
             cell: str, metrics: dict, files: dict = (), e2e: str = "step_ms") -> None:
    """New files and new entries only: ``files`` maps a path under the
    folder to its text."""
    with open(os.path.join(here, "configs", f"{config}.json"), "w") as f:
        json.dump(dict(cfg, name=config), f)
    with open(os.path.join(here, "traffic", f"{traffic}.json"), "w") as f:
        json.dump(mix, f)
    for path, text in dict(files).items():
        with open(os.path.join(here, path), "w") as f:
            f.write(text)
    for name, text in metrics.items():
        with open(os.path.join(here, "metrics", f"{name}.py"), "w") as f:
            f.write(text)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": config, "source": "test", "file": f"bm/configs/{config}.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": cell, "config": config, "traffic": traffic,
                               "chips": 1, "why": "test"})
    for name in metrics:
        bench["per_layer"].append({"name": name, "unit": "GFLOP", "better": "lower",
                                   "source": "program_counter", "layer": "Kernels",
                                   "moves": e2e, "workloads": [cell]})
    for m in bench["end_to_end"]:
        if m["name"] == e2e:
            m["workloads"].append(cell)
    with open(path, "w") as f:
        json.dump(bench, f)


def water(here: str, **changes) -> dict:
    with open(os.path.join(here, "configs", "water_2048.json")) as f:
        return dict(json.load(f), **changes)


def test_new_config_traffic_metric_found_by_name(tmp_path):
    root, here = tiny_copy(str(tmp_path))
    before = digests(here)
    add_cell(root, here, config="tiny_t64", cfg=water(here, tile=64, decay_per_angstrom=3.0),
             traffic="plain_two", mix={"call": "plain_step", "variants": 2, "trace_calls": 3},
             cell="tiny.plain_two", metrics={"work.gflop": WORK_READER})
    after = digests(here)
    assert all(after[k] == v for k, v in before.items())  # nothing that was there changed
    out = run("tiny.plain_two", BIG_SEED, 0.2, True, root=root, here=here, device="cpu")
    assert out["correct"] is True and out["attempted"] == 3
    assert out["metrics"]["work.gflop"]["value"] > 0


def test_new_pattern_and_call_with_own_reference(tmp_path):
    """A pattern kind and a call that brings its own program call, judge,
    compared number and control: new files and entries only."""
    root, here = tiny_copy(str(tmp_path))
    before = digests(here)
    cfg = {"pattern": "chain", "blocks": 40, "size": 7, "tile": 32, "dtype": "float64",
           "control_dtype": "float32", "eps": 1e-5, "limits": {"max_gap": 1e-9}}
    add_cell(root, here, config="chain_40", cfg=cfg, traffic="doubled",
             mix={"call": "doubled", "variants": 2, "trace_calls": 2}, cell="chain.doubled",
             metrics={}, files={"patterns/chain.py": CHAIN, "calls/doubled.py": DOUBLED})
    after = digests(here)
    assert all(after[k] == v for k, v in before.items())
    out = run("chain.doubled", BIG_SEED, 0.2, False, root=root, here=here, device="cpu")
    assert out["correct"] is True, out["compared"]
    assert set(out["compared"]) == {"max_gap"}
    out = run("chain.doubled", BIG_SEED, 0.1, False, root=root, here=here, device="cpu",
              program="control")
    assert out["correct"] is False
    out = run("chain.doubled", BIG_SEED, 0.2, False, root=root, here=here, device="cpu",
              fault="half")
    assert out["correct"] is False


def _work_reading(tmp_path, tile: int, driver: str) -> tuple:
    from dbcsr_tpu_torch import config_override

    root, here = tiny_copy(str(tmp_path / f"{tile}_{driver}"))
    add_cell(root, here, config="tiny_w", cfg=water(here, tile=tile), traffic="plain_w",
             mix={"call": "plain_step", "variants": 1, "trace_calls": 1}, cell="tiny.work",
             metrics={"work.gflop": WORK_READER, "work.gb": BYTES_READER})
    with config_override(mm_driver=driver):
        out = run("tiny.work", BIG_SEED, 0.2, True, root=root, here=here, device="cpu")
    assert out["correct"] is True
    return out["metrics"]["work.gflop"]["value"], out["metrics"]["work.gb"]["value"]


def test_work_count_is_the_inputs_not_the_tiles(tmp_path):
    readings = {(t, d): _work_reading(tmp_path, t, d)
                for t in (64, 128) for d in ("stack", "auto")}
    assert len(set(readings.values())) == 1, readings


def test_work_count_equals_block_triples():
    with open(os.path.join(REPO, "benchmark", "configs", "water_2048.json")) as f:
        cfg = dict(json.load(f), **TINY)
    p = pattern_of(cfg).blocks
    ptr = np.searchsorted(p.rows, np.arange(len(p.row_sizes) + 1))
    flops = elems_c = 0.0
    c = set()
    for i in range(len(p.row_sizes)):
        for a in range(ptr[i], ptr[i + 1]):
            k = p.cols[a]
            for b in range(ptr[k], ptr[k + 1]):
                flops += 2.0 * p.row_sizes[i] * p.col_sizes[k] * p.col_sizes[p.cols[b]]
                c.add((i, int(p.cols[b])))
    elems_c = float(sum(p.row_sizes[i] * p.col_sizes[j] for i, j in c))
    elems = 2 * float((p.m * p.k).sum()) + elems_c
    w = product_work(p, "float64")
    assert w.flops == pytest.approx(flops, rel=1e-12)
    assert w.bytes == pytest.approx(8 * elems, rel=1e-12)
