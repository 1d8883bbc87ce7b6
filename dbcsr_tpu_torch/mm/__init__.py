from .engine import LocalPlan, build_multiply_executor, multiply
from .f64_stack import tile_stack_matmul_f64, tile_stack_matmul_f64_plain
from .filtered import FilteredExecutor, build_filtered_executor
from .kernels import tile_stack_matmul, tile_stack_matmul_plain
from .panel import (
    PanelPlan,
    plan_panel_stack,
    tile_stack_matmul_panel,
    tile_stack_matmul_panel_plain,
)
from .tileplan import TileStackPlan, plan_tile_stacks_stores

__all__ = [
    "LocalPlan", "build_multiply_executor", "multiply",
    "tile_stack_matmul_f64", "tile_stack_matmul_f64_plain",
    "FilteredExecutor", "build_filtered_executor",
    "tile_stack_matmul", "tile_stack_matmul_plain",
    "PanelPlan", "plan_panel_stack", "tile_stack_matmul_panel",
    "tile_stack_matmul_panel_plain", "TileStackPlan", "plan_tile_stacks_stores",
]
