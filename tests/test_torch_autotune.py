"""The port's autotuning (``dbcsr_tpu_torch/autotune.py``) on the CPU: the
sweep, the table's I/O and merge, the class lookup the engine reads, and
parity with ``dbcsr_tpu/autotune.py`` — the same workload builders give the
same indices from one seed, and the features and nearest class agree on
the same indices against the JAX package's own table (passed to both as a
dict, so the port reads no file of the JAX package). The committed H100
table is checked for its classes and a holdout lookup.

Sweeps here run on CPU tensors (``device="cpu"``, the kernels' plain
versions): their rates say nothing of the card. A CPU device has no table,
so the engine's lookups are driven through a monkeypatched ``_cached_table``.
"""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from dbcsr_tpu import autotune as jat
from dbcsr_tpu.block.index import build_index as jax_build_index

import dbcsr_tpu_torch as dtt
from dbcsr_tpu_torch import autotune as tat
from dbcsr_tpu_torch.core.config import config_override, get_config, reset_config
from dbcsr_tpu_torch.core.errors import DbcsrError
from dbcsr_tpu_torch.mm import engine
from dbcsr_tpu_torch.mm.plancache import get_plan_cache

torch.set_num_threads(1)
CPU = torch.device("cpu")
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def _fresh_config():
    yield
    reset_config()


def _tiny_workload(seed, device):
    rng = np.random.default_rng(seed)
    rbs = dtt.random_block_sizes(80, [5, 13], rng)
    a = dtt.random_matrix(rbs, rbs, 0.3, rng, device=device, name="A")
    b = dtt.random_matrix(rbs, rbs, 0.3, rng, device=device, name="B")
    return a, b


def _banded_index(build, nrows, bandwidth, fill, seed):
    """A banded block pattern (blocks of 5/13/23) built by ``build``
    (either package's ``build_index``) from one numpy draw."""
    rng = np.random.default_rng(seed)
    rbs = dtt.random_block_sizes(nrows, [5, 13, 23], rng)
    n = len(rbs)
    i = np.repeat(np.arange(n, dtype=np.int64), 2 * bandwidth + 1)
    j = i + np.tile(np.arange(-bandwidth, bandwidth + 1, dtype=np.int64), n)
    keep = (j >= 0) & (j < n) & (rng.random(len(j)) < fill)
    return build(i[keep], j[keep], rbs, rbs)[0]


def _random_index(build, nrows, sizes, occ, seed):
    rng = np.random.default_rng(seed)
    rbs = dtt.random_block_sizes(nrows, sizes, rng)
    rows, cols = np.nonzero(rng.random((len(rbs), len(rbs))) < occ)
    return build(rows, cols, rbs, rbs)[0]


def _table(best):
    """A one-class table: its class is the nearest to every product."""
    return {"results": {"banded_fine": {"best": best, "features": [0.0] * 5}}}


def _fake_tables(monkeypatch, *tables):
    """Serve ``tables`` in turn as the table of every device (a CPU device
    has none of its own); returns the index of the next one to serve."""
    served = {"i": 0}

    def fake(device):
        return tables[min(served["i"], len(tables) - 1)]

    monkeypatch.setattr(tat, "_cached_table", fake)
    return served


# --- the sweep and the table ------------------------------------------------

@pytest.mark.parametrize("dense_fits", [True, False])
def test_sweep_save_and_apply(tmp_path, monkeypatch, dense_fits):
    """A sweep on the CPU records each combo's route and rate; a dense combo
    whose panels would not fit is declined (no row); the saved table loads
    back and ``apply_tuned`` adopts the winner's knobs, not its results."""
    monkeypatch.setitem(tat.WORKLOADS, "tiny", _tiny_workload)
    monkeypatch.setattr(tat, "_dense_fits", lambda *a: dense_fits)
    table = tat.sweep(
        grid={"mm_driver": ["dense", "stack"], "tile_size": [64]},
        workloads=["tiny"], device="cpu", verbose=False,
    )
    assert table["device_kind"] == "cpu"
    res = table["results"]["tiny"]
    assert [r["mm_driver"] for r in sorted(res["all"], key=lambda r: r["mm_driver"])] == (
        ["dense", "stack"] if dense_fits else ["stack"])
    assert all(r["route"] == r["mm_driver"] and r["gflops"] > 0 for r in res["all"])
    assert len(res["features"]) == len(tat._FEATURES)
    best = res["best"]

    path = tat.save_params(table, str(tmp_path / "params.json"))
    with open(path) as f:
        loaded = json.load(f)
    assert loaded == table
    assert tat.apply_tuned("tiny", table=loaded)
    cfg = get_config()
    assert (cfg.mm_driver, cfg.tile_size) == (best["mm_driver"], best["tile_size"])
    assert cfg.provenance("mm_driver") == "U"


class _FakePlan:
    """Plan-shaped object for the fingerprint (it reads attributes)."""

    def __init__(self, chunk=16, a_cap=32, b_cap=32, c_win=16, n_groups=4,
                 loaded_tiles=100):
        self.chunk, self.a_cap, self.b_cap = chunk, a_cap, b_cap
        self.c_win, self.n_groups = c_win, n_groups
        self.loaded_tiles = loaded_tiles


def test_sweep_panel_cache_axis_dedup(monkeypatch):
    """Each realised panel launch is measured once per cache-free knob key:
    equal fingerprints across the cache axis collapse to one measurement,
    a differing one (a halved chunk at a small cap) is measured."""
    monkeypatch.setitem(tat.WORKLOADS, "tiny", _tiny_workload)
    plans = {48: _FakePlan(chunk=8), 96: _FakePlan(chunk=16), 320: _FakePlan(chunk=16)}
    measured = []

    class _Exec:
        def __init__(self, plan):
            self.plan = type("LocalPlan", (), {"route": "panel", "panel": type(
                "DevicePanelPlan", (), {"plan": plan})()})()

        def __call__(self, a, b):
            return a

    def fake_build(ta, tb, a, b, driver=None):
        return _Exec(plans[get_config().panel_cache]), None, 1e9

    def fake_time(fn, args, **kw):
        measured.append(get_config().panel_cache)
        return 1e-3

    monkeypatch.setattr(engine, "build_multiply_executor", fake_build)
    monkeypatch.setattr(tat, "steady_state_time", fake_time)
    table = tat.sweep(
        grid={"mm_driver": ["panel"], "panel_cache": [320, 48, 96]},
        workloads=["tiny"], device="cpu", verbose=False,
    )
    assert measured == [48, 96]
    assert len(table["results"]["tiny"]["all"]) == 2


def test_sweep_records_a_declined_panel_combo_as_failed(monkeypatch, capsys):
    """An explicit panel combo the port declines raises DbcsrError inside
    the sweep: no row, a "failed" line, and the sweep goes on."""
    monkeypatch.setitem(tat.WORKLOADS, "tiny", _tiny_workload)

    def refuse(*a, **kw):
        raise DbcsrError("pattern not panel-admissible (see mm/panel.py)")

    monkeypatch.setattr(engine, "build_multiply_executor", refuse)
    table = tat.sweep(grid={"mm_driver": ["panel"]}, workloads=["tiny"], device="cpu")
    assert table["results"]["tiny"]["best"] is None
    assert table["results"]["tiny"]["all"] == []
    assert "failed (DbcsrError: pattern not panel-admissible" in capsys.readouterr().out


def test_sweep_needs_a_card_unless_the_cpu_is_asked_for(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DbcsrError, match="--device cpu"):
        tat.sweep(workloads=["banded_fine"])
    assert tat.main(["--workloads", "banded_fine"]) == 2
    assert "no" in capsys.readouterr().err


def test_merge_keeps_measured_entry_over_empty_sweep(tmp_path, monkeypatch):
    """--merge keeps a measured class over a sweep that measured nothing,
    and takes a freshly measured class."""
    good = {"best": {"mm_driver": "stack", "gflops": 962.0}, "all": []}
    fresh = {"best": {"mm_driver": "panel", "gflops": 1500.0}, "all": []}
    monkeypatch.setattr(tat, "sweep", lambda **kw: {"device_kind": "k", "results": {
        "banded_fine_large": {"best": None, "all": []}, "banded_fine": fresh}})
    monkeypatch.setattr(tat, "load_params", lambda kind=None: {
        "device_kind": "k", "results": {"banded_fine_large": good}})
    out = str(tmp_path / "t.json")
    assert tat.main(["--merge", "--out", out]) == 0
    with open(out) as f:
        merged = json.load(f)["results"]
    assert merged["banded_fine_large"] == good
    assert merged["banded_fine"] == fresh


@pytest.mark.parametrize("sizes,occ,cls", [
    ([23], 1.0, "block23_dense"),
    ([5], 0.1, "block5_sparse10"),
    ([5, 13, 23], 0.2, "mixed_5_13_23_sparse20"),
    ([5, 13, 23], 0.001, "banded_fine"),
])
def test_workload_class_buckets(sizes, occ, cls):
    assert tat.workload_class(sizes, occ) == jat.workload_class(sizes, occ) == cls


@pytest.mark.parametrize("table,cls", [({"results": {}}, "nope"),
                                       ({"results": {"x": {"best": None}}}, "x")])
def test_apply_tuned_missing_class_returns_false(table, cls):
    assert not tat.apply_tuned(cls, table=table)
    assert get_config().provenance("mm_driver") == "D"


# --- the lookup the engine reads --------------------------------------------

def _banded_pair(rows=3000, seed=1, tile=32):
    a_idx = _banded_index(dtt.build_index, rows, 3, 0.6, seed)
    gen = torch.Generator().manual_seed(seed)
    from dbcsr_tpu_torch.block.store import store_layout
    from dbcsr_tpu_torch.block.tileops import valid_mask

    data = torch.randn((store_layout(a_idx, tile).n_tiles, tile, tile),
                       generator=gen) * valid_mask(a_idx, tile, CPU)
    a = dtt.BCSRMatrix(name="A", index=a_idx, data=data)
    return a, dtt.BCSRMatrix(name="B", index=a_idx, data=data * 0.5)


def test_tuned_stack_params_defer_and_user_wins(monkeypatch):
    """Default-provenance knobs take the tuned row; user-set knobs win; the
    driver preference applies only while mm_driver is at its default."""
    with config_override(tile_size=32):
        a, b = _banded_pair()
    _fake_tables(monkeypatch, _table({
        "mm_driver": "panel", "panel_c_win": 32, "panel_cache": 96,
        "panel_chunk": 16, "panel_runlen": 3}))
    cfg = get_config()
    assert engine._panel_knobs(cfg, a.index, b.index, CPU) == (32, 96, 16, 3)
    assert engine._tuned_driver(cfg, a.index, b.index, CPU) == "panel"
    with config_override(panel_c_win=8, mm_driver="auto") as cfg2:
        assert engine._panel_knobs(cfg2, a.index, b.index, CPU) == (8, 96, 16, 3)
        assert engine._tuned_driver(cfg2, a.index, b.index, CPU) is None


def test_plan_cache_follows_the_table(monkeypatch):
    """Two tables in one process give two panel plans under one config: the
    plan cache is keyed by the resolved panel knobs; and a tuned driver
    takes the route under "auto", its product equal to the explicit
    driver's and to the dense reference."""
    get_plan_cache().clear()
    with config_override(tile_size=32):
        a, b = _banded_pair()
    row = {"mm_driver": "panel", "panel_cache": 320, "panel_chunk": 8, "panel_runlen": 0}
    tables = [_table({**row, "panel_c_win": c}) for c in (8, 32)]
    served = _fake_tables(monkeypatch, *tables)
    wins = []
    for k in range(2):
        served["i"] = k
        fn, _, _ = dtt.build_multiply_executor("N", "N", a, b)
        assert fn.plan.route == "panel"
        wins.append(fn.plan.panel.plan.c_win)
    assert wins == [8, 32]

    ref = a.to_dense().double() @ b.to_dense().double()
    planned = []
    plan_local = engine._plan_local

    def counting(*args, **kw):  # the one-shot's local plans, by route
        lp = plan_local(*args, **kw)
        planned.append(lp.route)
        return lp

    monkeypatch.setattr(engine, "_plan_local", counting)
    for drv in ("grouped", "band", "stack"):
        _fake_tables(monkeypatch, _table({"mm_driver": drv}))
        fn, c_index, _ = dtt.build_multiply_executor("N", "N", a, b)
        assert fn.plan.route == drv
        with config_override(mm_driver=drv):
            fx, _, _ = dtt.build_multiply_executor("N", "N", a, b)
        out = fn(a.data, b.data)
        assert torch.equal(out, fx(a.data, b.data))
        c = dtt.BCSRMatrix(name="C", index=c_index, data=out)
        got = dtt.multiply("N", "N", 1.0, a, b).to_dense().double()
        np.testing.assert_allclose(c.to_dense().double(), ref, atol=1e-4 * float(ref.abs().max()))
        np.testing.assert_allclose(got, ref, atol=1e-4 * float(ref.abs().max()))
    # build_multiply_executor plans through _plan_local too: each table's
    # one-shot plans anew (its cached local plan is keyed by the tuned row)
    assert planned == ["grouped", "grouped", "grouped", "band", "band", "band",
                       "stack", "stack", "stack"]
    get_plan_cache().clear()


def test_a_cpu_product_has_no_table(monkeypatch):
    """A CPU product gets None from the lookup in both packages (the JAX
    package on its CPU backend files tables under "cpu", and has none)."""
    rng = np.random.default_rng(3)
    rbs = dtt.random_block_sizes(300, [5, 13], rng)
    rows, cols = np.nonzero(rng.random((len(rbs), len(rbs))) < 0.05)
    t_idx = dtt.build_index(rows, cols, rbs, rbs)[0]
    j_idx = jax_build_index(rows, cols, rbs, rbs)[0]
    monkeypatch.setitem(jat._TABLE_CACHE, "kind", None)
    assert jat.tuned_stack_params(j_idx, j_idx) is None
    assert tat.tuned_stack_params(t_idx, t_idx, CPU) is None
    assert tat.tuned_stack_params(t_idx, t_idx) is None
    assert tat.load_params("cpu") is None


# --- parity with dbcsr_tpu --------------------------------------------------

def _holdouts(build):
    """The JAX package's holdout shapes (``tests/test_autotune.py``), at
    the patterns' own scale, plus its five swept classes' patterns."""
    return [
        _banded_index(build, 30000, 8, 0.6, 11),
        _random_index(build, 1000, [27], 1.0, 12),
        _random_index(build, 2500, [4], 0.05, 13),
        _random_index(build, 2000, [5, 13, 23], 0.30, 14),
        _banded_index(build, 12000, 12, 0.5, 0),
        _random_index(build, 1500, [5], 0.10, 15),
    ]


def test_features_and_nearest_class_match_jax():
    """``workload_features`` and ``nearest_class`` agree with the JAX
    package's on the same indices, against the JAX package's own table."""
    table = jat.load_params("TPU v5 lite")
    assert table is not None
    for t_idx, j_idx in zip(_holdouts(dtt.build_index), _holdouts(jax_build_index)):
        ft = tat.workload_features(t_idx, t_idx)
        fj = jat.workload_features(j_idx, j_idx)
        np.testing.assert_array_equal(ft, fj)
        assert tat.nearest_class(ft, table) == jat.nearest_class(fj, table)
    assert tat.nearest_class(ft, {"results": {"x": {"features": None}}}) is None


@pytest.mark.parametrize("name,jax_build,torch_build", [
    pytest.param(n, jat.WORKLOADS[n], tat.WORKLOADS[n], id=n)
    for n in ("block23_dense", "block5_sparse10", "mixed_5_13_23_sparse20")
] + [pytest.param("banded", jat._mk_banded(600), tat._mk_banded(600), id="banded_600"),
     pytest.param("banded", jat._mk_banded(900, 5), tat._mk_banded(900, 5), id="banded_900_w5")])
def test_workload_builders_match_jax(name, jax_build, torch_build):
    """Each builder gives the JAX twin's indices from one seed (and, where
    both draw the data from numpy, the same data); the names and sizes of
    the JAX classes carry over."""
    ja, jb = jax_build(np.random.default_rng(5))
    ta, tb = torch_build(5, CPU)
    for jm, tm in ((ja, ta), (jb, tb)):
        for f in ("row_block_sizes", "col_block_sizes", "row_ptr", "col_idx"):
            np.testing.assert_array_equal(getattr(tm.index, f), getattr(jm.index, f))
    if not name.startswith("banded"):
        np.testing.assert_array_equal(ta.to_dense().numpy(), np.asarray(ja.to_dense()))
    else:
        assert torch.equal(tb.data, ta.data * 0.5)
    assert set(jat.WORKLOADS) < set(tat.WORKLOADS)


def test_the_grids_hold_only_the_ports_knobs():
    """Every swept knob is a config parameter of the port; the JAX grids'
    TPU launch knobs are not; bf16 is swept only at "default"."""
    params = set(dtt.Config().params())
    for drv, grid in tat.DRIVER_GRIDS.items():
        assert set(grid) <= params, drv
        assert set(grid) <= set(jat.DRIVER_GRIDS[drv])
    assert not tat._combo_ok({"matmul_precision": "highest", "panel_bf16_inputs": True})
    assert tat._combo_ok({"matmul_precision": "default", "stack_bf16_inputs": True})


# --- the committed H100 table -----------------------------------------------

def test_committed_h100_table():
    """The table measured on the card: six classes with features and rows
    whose knobs are the port's own; the JAX package's banded holdout (30,000
    rows, bandwidth 8) maps to a banded class."""
    table = tat.load_params(H100)
    assert table is not None and table["device_kind"] == H100
    res = table["results"]
    assert set(res) == set(tat.WORKLOADS)
    params = set(dtt.Config().params())
    for cls, entry in res.items():
        assert len(entry["features"]) == len(tat._FEATURES), cls
        assert entry["best"] == entry["all"][0], cls
        for r in entry["all"]:
            assert set(r) - {"route", "gflops"} <= params, (cls, r)
            assert r["gflops"] > 0
    idx = _banded_index(dtt.build_index, 30000, 8, 0.6, 11)
    cls, _ = tat.nearest_class(tat.workload_features(idx, idx), table)
    assert cls.startswith("banded"), cls


def test_cli_on_the_cpu_imports_no_jax(tmp_path):
    """``python -m dbcsr_tpu_torch.autotune --device cpu`` writes a table
    with the swept class, and the module pulls in neither jax nor the JAX
    package."""
    out = tmp_path / "cpu.json"
    code = ("import sys; from dbcsr_tpu_torch import autotune; "
            f"rc = autotune.main(['--device', 'cpu', '--workloads', 'banded_fine', "
            f"'--drivers', 'band', '--out', {str(out)!r}]); "
            "assert 'jax' not in sys.modules and 'dbcsr_tpu' not in sys.modules; sys.exit(rc)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    with open(out) as f:
        table = json.load(f)
    assert table["device_kind"] == "cpu"
    assert [r["route"] for r in table["results"]["banded_fine"]["all"]] == ["band"] * 2
