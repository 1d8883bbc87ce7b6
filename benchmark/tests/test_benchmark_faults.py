"""A run with its timed path broken underneath comes out not correct: the
look for a card skipped, the rest of a run driven, one fault at a time —
a step that returns its state unchanged, half of the inputs left out, an
answer altered where it is produced, the exchange between processes left
out — and the control (the reference in float32 in the program's place)."""
import json
import os

import pytest

from conftest import BIG_SEED

from benchmark.harness import run

ONE_CARD = ("water2048.filtered_step", "water2048.plain_step", "water2048.oneshot")


def add_grid_cell(root: str, here: str) -> str:
    """The 2x2 Cannon cell of the tiny configuration: new files and entries."""
    with open(os.path.join(here, "configs", "water_2048.json")) as f:
        cfg = json.load(f)
    cfg.update(name="water_2x2", grid=[2, 2])
    with open(os.path.join(here, "configs", "water_2x2.json"), "w") as f:
        json.dump(cfg, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "water_2x2", "source": "test",
                             "file": "bm/configs/water_2x2.json", "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "water2x2.cannon_step", "config": "water_2x2",
                               "traffic": "cannon_step", "chips": 4, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "step_ms":
            m["workloads"].append("water2x2.cannon_step")
    with open(path, "w") as f:
        json.dump(bench, f)
    return "water2x2.cannon_step"


@pytest.mark.parametrize("cell", ONE_CARD)
@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_fault_is_not_correct(tiny, cell, fault):
    root, here = tiny
    out = run(cell, BIG_SEED, 0.3, False, root=root, here=here, device="cpu", fault=fault)
    assert out["correct"] is False
    assert out["failed"] >= 1


@pytest.mark.parametrize("cell", ONE_CARD)
def test_sound_run_is_correct(tiny, cell):
    root, here = tiny
    out = run(cell, BIG_SEED + 1, 0.3, False, root=root, here=here, device="cpu")
    assert out["correct"] is True


@pytest.mark.parametrize("cell", ONE_CARD)
def test_control_is_not_correct(tiny, cell):
    root, here = tiny
    out = run(cell, BIG_SEED, 0.1, False, root=root, here=here, device="cpu",
              program="control")
    assert out["correct"] is False
    assert out["compared"]["block_err"]["value"] > 100 * out["compared"]["block_err"]["limit"]


@pytest.mark.parametrize("fault", [None, "exchange", "stale"])
def test_four_processes(tiny, fault):
    """The 2x2 cell over four gloo processes on the CPU: sound, then with
    the exchange between processes or the state's update left out."""
    root, here = tiny
    cell = add_grid_cell(root, here)
    out = run(cell, BIG_SEED, 0.5, False, root=root, here=here, device="cpu", fault=fault)
    assert out["device"]["count"] == 4
    assert out["correct"] is (fault is None)
