from ..block.refold import apply_refold
from ..block.tileops import keep_blocks, tile_block_sumsq
from .band import BandPlan, band_matmul, band_matmul_plain, plan_band
from .c_stack import (
    tile_stack_matmul_c,
    tile_stack_matmul_c64,
    tile_stack_matmul_c128,
    tile_stack_matmul_c_plain,
)
from .engine import LocalPlan, build_multiply_executor, multiply
from .f64_stack import segment_sum_f64, tile_stack_matmul_f64, tile_stack_matmul_f64_plain
from .filtered import FilteredExecutor, ShardedFilteredExecutor, build_filtered_executor
from .kernels import (
    device_group_plan,
    tile_stack_matmul,
    tile_stack_matmul_grouped,
    tile_stack_matmul_grouped_plain,
    tile_stack_matmul_plain,
)
from .panel import (
    PanelPlan,
    PanelRunPlan,
    plan_panel_runs,
    plan_panel_stack,
    tile_stack_matmul_panel,
    tile_stack_matmul_panel_plain,
    tile_stack_matmul_panel_runs,
    tile_stack_matmul_panel_runs_plain,
)
from .reorder import (
    ReorderPlan,
    locality_block_permutation,
    locality_reorder_plan,
    permute_blocks,
)
from .tileplan import TileStackPlan, plan_tile_stacks_stores

#: every hand-written kernel's wrapper, by kernel (K6: the float64 stack
#: kernel that ports it; S1: its fix-up of split runs, ``mm/f64_stack.py``;
#: F1, F2: the eps filter's block norms² and keep-zeroing,
#: ``block/tileops.py``; R1: the tensor refold, ``block/refold.py``); each
#: counts its own launches in ``.launches``
KERNEL_WRAPPERS = {
    "K1": tile_stack_matmul, "K2": tile_stack_matmul_panel,
    "K3": tile_stack_matmul_panel_runs, "K4": tile_stack_matmul_grouped,
    "K5": band_matmul, "K6": tile_stack_matmul_f64, "S1": segment_sum_f64,
    "KC1": tile_stack_matmul_c64, "KC2": tile_stack_matmul_c128,
    "F1": tile_block_sumsq, "F2": keep_blocks, "R1": apply_refold,
}


def kernel_launches() -> dict:
    """Launches of each hand-written kernel since its count was last reset
    (a kernel's plain version on CPU tensors launches nothing)."""
    return {name: k.launches for name, k in KERNEL_WRAPPERS.items()}


def launches_since(before: dict) -> dict:
    """The kernels launched since ``before`` (a ``kernel_launches()``
    reading), each with its count; the others left out."""
    return {k: n - before[k] for k, n in kernel_launches().items() if n > before[k]}


def reset_kernel_launches() -> None:
    for k in KERNEL_WRAPPERS.values():
        k.launches = 0

__all__ = [
    "BandPlan", "band_matmul", "band_matmul_plain", "plan_band",
    "tile_stack_matmul_c", "tile_stack_matmul_c64", "tile_stack_matmul_c128",
    "tile_stack_matmul_c_plain",
    "LocalPlan", "build_multiply_executor", "multiply",
    "segment_sum_f64", "tile_stack_matmul_f64", "tile_stack_matmul_f64_plain",
    "FilteredExecutor", "ShardedFilteredExecutor", "build_filtered_executor",
    "device_group_plan", "tile_stack_matmul", "tile_stack_matmul_grouped",
    "tile_stack_matmul_grouped_plain", "tile_stack_matmul_plain",
    "PanelPlan", "PanelRunPlan", "plan_panel_runs", "plan_panel_stack",
    "tile_stack_matmul_panel", "tile_stack_matmul_panel_plain",
    "tile_stack_matmul_panel_runs", "tile_stack_matmul_panel_runs_plain",
    "ReorderPlan", "locality_block_permutation", "locality_reorder_plan",
    "permute_blocks", "TileStackPlan", "plan_tile_stacks_stores",
    "KERNEL_WRAPPERS", "kernel_launches", "launches_since", "reset_kernel_launches",
]
