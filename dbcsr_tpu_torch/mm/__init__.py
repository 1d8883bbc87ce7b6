from .engine import LocalPlan, build_multiply_executor, multiply
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
    "tile_stack_matmul", "tile_stack_matmul_plain",
    "PanelPlan", "plan_panel_stack", "tile_stack_matmul_panel",
    "tile_stack_matmul_panel_plain", "TileStackPlan", "plan_tile_stacks_stores",
]
