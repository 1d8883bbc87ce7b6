"""Finding the pieces of a cell by name: the cell and its metrics in
``BENCHMARK.json``; its configuration in ``configs/<name>.json``, whose
``pattern`` names a pattern kind in ``patterns/<kind>.py``; its traffic mix
in ``traffic/<name>.json``, whose ``call`` names a call in
``calls/<call>.py`` (the program's call, its judge and its control); and
each metric's reader in ``metrics/<name>.py`` (``read(ctx)`` returning a
number, or None where it finds nothing to read). Adding any of them takes
new files and new entries only."""
from __future__ import annotations

import importlib.util
import json
import os
import re
import sys
from types import ModuleType
from typing import Callable, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, here: str = HERE) -> dict:
    return load_json(os.path.join(here, "configs", f"{name}.json"))


def traffic(name: str, here: str = HERE) -> dict:
    return load_json(os.path.join(here, "traffic", f"{name}.json"))


def metrics_of(bench: dict, cell: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def module(folder: str, name: str, here: str = HERE) -> ModuleType:
    """``<here>/<folder>/<name>.py``, loaded once a process."""
    mod_name = f"benchmark_{folder}_" + re.sub(r"\W", "_", name)
    if mod_name in sys.modules and sys.modules[mod_name].__file__ == os.path.join(
            here, folder, f"{name}.py"):
        return sys.modules[mod_name]
    path = os.path.join(here, folder, f"{name}.py")
    sp = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(sp)
    sys.modules[mod_name] = mod
    sp.loader.exec_module(mod)
    return mod


def reader(name: str, here: str = HERE) -> Callable:
    return module("metrics", name, here).read
