"""The benchmark's operands, made without the program: a pattern kind
(``patterns/<kind>.py``, named by the configuration's ``pattern``) gives
the block pattern and a scale for each block; the data is N(0, 1) times
that scale, made on the device from the run's ``--seed`` with one
``torch.Generator`` in a few large calls: B (the overlap-like operand that
stays) and ``variants`` A stores that the traffic cycles through. Stores
follow ``reference/layout.py``."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from . import spec
from .reference.layout import Blocks, positions, tile_keys


def dtype_of(name: str) -> torch.dtype:
    """``"float64"`` -> ``torch.float64``, for any floating or complex type."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"no torch dtype {name!r}")
    return dt


@dataclass
class Pattern:
    """A block pattern (the same for A and B) and each block's data scale."""

    blocks: Blocks
    scale: np.ndarray  # float64, one a block


def pattern_of(cfg: dict, here: str = spec.HERE) -> Pattern:
    p = spec.module("patterns", cfg["pattern"], here).make(cfg)
    b = p.blocks
    if b.n and not np.all(np.diff(b.keys) > 0):
        raise ValueError("a pattern's blocks have to be in row-major order, each once")
    return p


@dataclass
class Operands:
    """B and the A variants, as tile stores on the device."""

    pattern: Blocks
    keys: np.ndarray  # the stores' row-major tile ids
    b: torch.Tensor
    a: List[torch.Tensor]


def make_operands(cfg: dict, pattern: Pattern, seed: int, variants: int, device) -> Operands:
    tile = int(cfg["tile"])
    dtype = dtype_of(cfg["dtype"])
    real = torch.empty(0, dtype=dtype).real.dtype
    blocks = pattern.blocks
    keys = tile_keys(blocks, tile)
    scale = torch.zeros(len(keys) * tile * tile, dtype=real, device=device)
    for shape, ids in blocks.classes().items():
        pos = positions(blocks, ids, shape, keys, tile, device)
        s = torch.as_tensor(pattern.scale[ids], dtype=real, device=device)
        scale[pos] = s[:, None, None].expand(pos.shape)
        del pos
    scale = scale.view(len(keys), tile, tile)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def draw():
        return torch.randn(scale.shape, generator=gen, device=device, dtype=dtype) * scale

    b = draw()
    a = [draw() for _ in range(variants)]
    return Operands(pattern=blocks, keys=keys, b=b, a=a)
