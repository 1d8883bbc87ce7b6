"""Fixtures of the benchmark's CPU tests: a copy of ``BENCHMARK.json`` and
of the cell folders in a temporary directory, cut to a tiny size, that the
harness runs through its test-only ``device="cpu"`` argument on the
program's plain (CPU) kernels."""
import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

#: the tiny configurations: 2x2x1 cells of 32 water molecules (384 atom
#: blocks, 2,944 rows, a 23² tile grid at T = 128), blocks to 4.6 Å
TINY = {"replicas": [2, 2, 1], "decay_per_angstrom": 2.5}
BIG_SEED = 2**31 + 977
#: the one-shot cell, whose call, traffic and readers are ready but which
#: ``BENCHMARK.json`` does not list yet (a call of 31.7 s on the card)
ONESHOT = "water2048.oneshot"


def add_oneshot(root: str) -> None:
    """The one-shot cell and its metrics, as entries of a copy's
    ``BENCHMARK.json``."""
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": ONESHOT, "config": "water_2048", "traffic": "oneshot",
                               "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "oneshot_ms", "unit": "ms", "better": "lower",
                                "bound": 0.25, "source": "host_clock", "workloads": [ONESHOT]})
    for name, src in (("host_plan.ms", "program_span"), ("host_exec.ms", "program_span"),
                      ("device.idle_pct.oneshot", "device_trace")):
        bench["per_layer"].append({"name": name, "unit": "ms", "better": "lower",
                                   "source": src, "layer": "Entry and host planning",
                                   "moves": "oneshot_ms", "workloads": [ONESHOT]})
    with open(path, "w") as f:
        json.dump(bench, f)


def tiny_copy(dst: str, **changes) -> tuple:
    """(root, here) of a copy of the benchmark with every configuration
    cut to ``TINY`` (and ``changes`` applied)."""
    root = os.path.join(dst, "root")
    here = os.path.join(root, "bm")
    os.makedirs(here)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    for d in ("configs", "traffic", "metrics", "calls", "patterns"):
        shutil.copytree(os.path.join(REPO, "benchmark", d), os.path.join(here, d))
    cdir = os.path.join(here, "configs")
    for name in os.listdir(cdir):
        path = os.path.join(cdir, name)
        with open(path) as f:
            cfg = json.load(f)
        cfg.update(TINY, **changes)
        with open(path, "w") as f:
            json.dump(cfg, f)
    add_oneshot(root)
    return root, here


@pytest.fixture
def tiny(tmp_path):
    return tiny_copy(str(tmp_path))


@pytest.fixture(autouse=True)
def _one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
