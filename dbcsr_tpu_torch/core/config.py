"""Typed configuration with environment overrides and provenance.

The port's subset of ``dbcsr_tpu/core/config.py``: only the fields the
local multiply (filtered or not) reads. Every parameter carries a Default/Environment/User
provenance tag and can be overridden by an environment variable
``DBCSR_<NAME>`` read on first use (reference:
``src/core/dbcsr_config.F:100-246``). Provenance matters: knobs left at
their defaults defer to a tuned per-class table (``mm/engine.py``
``_panel_knobs``), knobs the user set do not.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Iterator, Optional

__all__ = [
    "Config",
    "get_config",
    "set_config",
    "reset_config",
    "print_config",
    "config_override",
    "config_fingerprint",
]

_PROVENANCE_DEFAULT = "D"
_PROVENANCE_ENV = "E"
_PROVENANCE_USER = "U"


@dataclasses.dataclass
class Config:
    """Global configuration (analog of ``dbcsr_config_type``)."""

    #: tile edge of the tile stores (the CUDA kernels take 16, 32, 64, 128)
    tile_size: int = 128
    #: local driver: "auto" | "dense" | "stack" | "panel" | "band" |
    #: "grouped"; "xla" is the JAX package's XLA twin and is not ported
    mm_driver: str = "auto"
    #: tile-level occupancy at or above which "auto" takes the dense path
    dense_threshold: float = 0.30
    #: "highest" = IEEE f32; "high" = TF32 on the dense path;
    #: "default" = bf16 inputs with f32 accumulation
    matmul_precision: str = "highest"
    #: at "default" precision, feed bf16 tiles to the flat stack kernel
    stack_bf16_inputs: bool = True
    #: panel plan: output tiles per group, A/B slab span cap in tiles, slab
    #: chunk in tiles, and the traffic ratio "auto" admission requires
    panel_c_win: int = 16
    panel_cache: int = 48
    panel_chunk: int = 8
    panel_admit: float = 0.85
    #: k-run fusion length R of the panel plan (0 = off): runs of R
    #: consecutive (A slot, column-major B slot) pairs become one entry of
    #: the run-fused panel kernel (``mm/panel.py``)
    panel_runlen: int = 0
    #: at "default" precision, feed bf16 tiles to the panel kernel
    panel_bf16_inputs: bool = False
    #: locality tile-reordering pre-pass (``mm/reorder.py``): "auto" tries
    #: an RCM tile renumbering when the panel plan is otherwise
    #: inadmissible (plan-once executor only); "off" disables it
    reorder: str = "auto"
    #: band driver admission under "auto": the most Wa·Wb diagonal products,
    #: and how far the padded band work (Wa·Wb·Mt tile products) may exceed
    #: the stack's tile-triple count
    band_max_products: int = 128
    band_flop_factor: float = 0.75
    #: on-the-fly filtering with per-row thresholds (eps/row_count)²
    #: like dbcsr_mm_cannon.F:1100-1113 (else a flat eps² block filter)
    per_row_eps: bool = True
    #: filtering rule of the symbolic product (read by ``mm/plan.py``):
    #: "sum" keeps a C block when the sum of its contributions' norm
    #: products clears the threshold, "exact" when any single one does
    filter_mode: str = "sum"
    #: float64 compute path of the JAX package ("auto" | "native" |
    #: "ozaki"), which chooses between XLA's float64 dot and bf16-slice
    #: emulations that exist because the TPU has no float64 unit. The port
    #: accepts every value and always runs float64 natively: sparse stacks
    #: through the float64 stack kernel (``mm/f64_stack.py``), the dense
    #: class through a float64 ``torch.mm``.
    f64_method: str = "auto"
    #: Ozaki slice count of the JAX package (0 = its full-accuracy default;
    #: N trades accuracy for speed). Native float64 has no slices, so any
    #: value other than 0 raises NotImplementedError.
    f64_slices: int = 0
    #: build the host stack plan with the native C++ planner when it builds
    use_native_planner: bool = True
    #: Cannon: partition work at tile granularity (block distributions
    #: honored as their nearest tile-aligned form); off = the
    #: element-granular plan (block-atomic placement)
    use_tiled_cannon: bool = True
    #: distributed algorithm: "auto" (Cannon on square grids, SUMMA
    #: otherwise), "cannon", "summa"
    mm_dist_algo: str = "auto"

    # provenance bookkeeping: name -> D/E/U
    _provenance: Dict[str, str] = dataclasses.field(
        default_factory=dict, repr=False
    )

    def provenance(self, name: str) -> str:
        return self._provenance.get(name, _PROVENANCE_DEFAULT)

    def params(self) -> Iterator[str]:
        for f in dataclasses.fields(self):
            if not f.name.startswith("_"):
                yield f.name


_cfg: Optional[Config] = None


def _coerce(value: str, like: Any) -> Any:
    if isinstance(like, bool):
        return value.strip().lower() in ("1", "true", "t", "yes", "on")
    if isinstance(like, int):
        return int(value)
    if isinstance(like, float):
        return float(value)
    return value


def _load_env(cfg: Config) -> None:
    """Read ``DBCSR_<NAME>`` env vars (reference: dbcsr_config.F:214-246)."""
    for name in cfg.params():
        env = os.environ.get("DBCSR_" + name.upper())
        if env is not None:
            setattr(cfg, name, _coerce(env, getattr(cfg, name)))
            cfg._provenance[name] = _PROVENANCE_ENV


def get_config() -> Config:
    global _cfg
    if _cfg is None:
        _cfg = Config()
        _load_env(_cfg)
    return _cfg


def config_fingerprint(cfg: Optional[Config] = None) -> str:
    """Stable fingerprint of the public fields AND their provenance, for
    plan cache keys: two value-identical configs with different provenance
    can resolve different plans."""
    if cfg is None:
        cfg = get_config()
    return repr(
        [(n, getattr(cfg, n), cfg.provenance(n)) for n in cfg.params()]
    )


def set_config(**kwargs: Any) -> None:
    """User-level override (analog of ``dbcsr_set_config``)."""
    cfg = get_config()
    for name, value in kwargs.items():
        if name not in set(cfg.params()):
            raise KeyError(f"unknown config parameter: {name!r}")
        setattr(cfg, name, value)
        cfg._provenance[name] = _PROVENANCE_USER


def reset_config() -> None:
    global _cfg
    _cfg = None


class config_override:
    """Context manager for scoped config changes."""

    def __init__(self, **kwargs: Any):
        self._kwargs = kwargs
        self._saved: Dict[str, Any] = {}

    def __enter__(self) -> Config:
        cfg = get_config()
        for name in self._kwargs:
            self._saved[name] = (getattr(cfg, name), cfg.provenance(name))
        set_config(**self._kwargs)
        return cfg

    def __exit__(self, *exc: Any) -> None:
        cfg = get_config()
        for name, (value, prov) in self._saved.items():
            setattr(cfg, name, value)
            cfg._provenance[name] = prov


def print_config(out=None) -> str:
    """Render the provenance-tagged parameter table."""
    cfg = get_config()
    lines = [f"{'parameter':<24} {'value':<16} src"]
    for name in cfg.params():
        lines.append(f"{name:<24} {getattr(cfg, name)!s:<16} {cfg.provenance(name)}")
    text = "\n".join(lines)
    if out is not None:
        print(text, file=out)
    return text
