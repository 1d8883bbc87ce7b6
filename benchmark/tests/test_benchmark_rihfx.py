"""The RI-HFX cell (``rihfx64.exchange_step``) on the CPU, on one 8-molecule
cell with the ranges cut under half of it: a sound run is correct, a run
with its timed path broken (a step that returns its state unchanged, half
of D left out, K altered where it is produced) and the control are not,
a program without the batched contraction's bounds fails at once, the
work count equals a count of the block triples, and the call and the
reference hold no JAX."""
import json
import math
import os
import sys

import numpy as np
import pytest

from conftest import BIG_SEED, REPO, tiny_copy
from test_benchmark_nojax import FORBIDDEN, imports

from benchmark.harness import run

CELL = "rihfx64.exchange_step"
#: one cell of 8 molecules at the configuration's density, D's range and
#: B's ranges cut under half of it
TINY_RI = {"cell_molecules": 8, "cell_angstrom": 6.207, "replicas": [1, 1, 1],
           "decay_per_angstrom": 1.44, "eps": math.exp(-1.44 * 3.0), "pair_angstrom": 3.0,
           "ri_angstrom": 1.5, "n_batches": 3}


@pytest.fixture
def tiny_ri(tmp_path):
    root, here = tiny_copy(str(tmp_path))
    path = os.path.join(here, "configs", "rihfx_water_64.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg.update(TINY_RI)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return root, here


def test_sound_run_is_correct(tiny_ri):
    root, here = tiny_ri
    out = run(CELL, BIG_SEED + 1, 0.3, False, root=root, here=here, device="cpu")
    assert out["correct"] is True and out["failed"] == 0
    assert out["compared"]["block_err"]["value"] < 1e-14
    assert set(out["metrics"]) == {"step_ms", "step_p95_ms", "setup_s"}


def test_traced_run_reads_the_program(tiny_ri):
    """The spans have no device time on the CPU, and no trace has a
    product kernel: the readers give nothing, and do not raise."""
    from dbcsr_tpu_torch.core.timing import timer_stats

    root, here = tiny_ri
    out = run(CELL, BIG_SEED, 0.3, True, root=root, here=here, device="cpu")
    assert out["correct"] is True and out["attempted"] == 20
    assert "kernel.tile_util" in out["metrics"]
    assert not {"tensor.refold.ms", "ri.kernel_roofline", "tensor.refold_roofline"} \
        & set(out["metrics"])
    st = timer_stats()
    assert st["tensor/refold"].calls == 20 * 3 and st["tensor/batch"].calls == 20 * 3 * 2


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_fault_is_not_correct(tiny_ri, fault):
    root, here = tiny_ri
    out = run(CELL, BIG_SEED, 0.3, False, root=root, here=here, device="cpu", fault=fault)
    assert out["correct"] is False and out["failed"] >= 1


def test_control_is_not_correct(tiny_ri):
    root, here = tiny_ri
    out = run(CELL, BIG_SEED, 0.1, False, root=root, here=here, device="cpu", program="control")
    assert out["correct"] is False
    assert out["compared"]["block_err"]["value"] > 100 * out["compared"]["block_err"]["limit"]


def test_program_without_bounds_fails_at_once(tiny_ri, monkeypatch):
    """A ``BatchedContract.contract`` without bounds or filter_eps (the
    signature before them) makes the run raise at its first call."""
    import dbcsr_tpu_torch.tensors.contract  # noqa: F401

    mod = sys.modules["dbcsr_tpu_torch.tensors.contract"]  # the module, not its function
    new = mod.BatchedContract.contract

    def old(self, a, b, *, contract_1, notcontract_1, contract_2, notcontract_2, map_1=None,
            map_2=None):
        return new(self, a, b, contract_1=contract_1, notcontract_1=notcontract_1,
                   contract_2=contract_2, notcontract_2=notcontract_2, map_1=map_1, map_2=map_2)

    monkeypatch.setattr(mod.BatchedContract, "contract", old)
    root, here = tiny_ri
    with pytest.raises(TypeError):
        run(CELL, BIG_SEED, 0.3, False, root=root, here=here, device="cpu")


def test_work_count_equals_block_triples(tiny_ri):
    """``ri_work``: the two contractions' 2·m·k·n summed over explicit block
    triples, and the elements of B, D and X's superset."""
    from benchmark import spec
    from benchmark.reference import ri_hfx as ri
    from benchmark.ri_work import ri_work

    _, here = tiny_ri
    cfg = spec.config("rihfx_water_64", here)
    pattern = spec.module("patterns", "water_box", here)
    pos, box, oxygen = pattern.geometry(cfg)
    pat = ri.pattern(cfg, pos, box, oxygen)
    d = pattern.make(cfg).blocks
    ao, rib = pat.ao, pat.ri
    d_of = {}
    for r, c in zip(d.rows, d.cols):
        d_of.setdefault(int(r), []).append(int(c))
    x = {}
    flops = 0.0
    for mu, lam, p in zip(pat.mu, pat.lam, pat.p):
        for sig in d_of.get(int(lam), []):
            flops += 2.0 * ao[mu] * ao[lam] * rib[p] * ao[sig]
            x[(int(mu), sig, int(p))] = True
    b_of = {}
    for mu, lam, p in zip(pat.mu, pat.lam, pat.p):
        b_of.setdefault((int(lam), int(p)), []).append(int(mu))
    for (mu, sig, p) in x:
        for nu in b_of.get((sig, p), []):
            flops += 2.0 * ao[mu] * ao[sig] * rib[p] * ao[nu]
    x_el = sum(float(ao[m] * ao[s] * rib[p]) for m, s, p in x)
    elems = float(np.sum(ao[pat.mu] * ao[pat.lam] * rib[pat.p])) + \
        float(np.sum(ao[d.rows] * ao[d.cols])) + x_el
    w = ri_work(cfg)
    assert w.step.flops == pytest.approx(flops, rel=1e-12)
    assert w.step.bytes == pytest.approx(8 * elems, rel=1e-12)
    assert w.refold_bytes == pytest.approx(16 * x_el, rel=1e-12)


def test_call_and_reference_hold_no_jax():
    call = os.path.join(REPO, "benchmark", "calls", "rihfx_step.py")
    names = imports(call)
    assert "dbcsr_tpu_torch" in names and not names & FORBIDDEN
    for f in ("benchmark/reference/ri_hfx.py", "tools/torch/ri_hfx_reference.py",
              "benchmark/ri_work.py"):
        names = imports(os.path.join(REPO, f))
        assert not names & (FORBIDDEN | {"dbcsr_tpu_torch"}), f
