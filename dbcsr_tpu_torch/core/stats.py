"""Multiplication statistics counters.

Port of ``dbcsr_tpu/core/stats.py``: effective flops
are counted at user-block granularity (2·m·n·k per contributing block
triple), padded flops at tile granularity (2·T³ per stack entry, or the
full dense grid), hardware flops as the kernels issue them: the padded
figure, less the mma depths that the float64 stack kernel skips
(``mm/f64_stack.py``). effective / hardware is the tile packing
efficiency, 1 − hardware / padded the share of the tile work skipped. The
distributed executors count their messages (``record_comm``), the eps
filter's kernels their bytes (``filter_bytes``), the tensor refolds theirs
(``refold_bytes``), the batched contraction its batches
(``tensor_batches``) and the float64 stack kernel's launches their run
segments (``split_runs``, ``run_segments``). Reference:
``src/mm/dbcsr_mm_sched.F:392-663``, printed like
``dbcsr_print_statistics`` (``src/core/dbcsr_lib.F:348``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

__all__ = ["MMStats", "get_stats", "reset_stats", "print_statistics"]


@dataclass
class MMStats:
    num_multiplications: int = 0
    total_flops: float = 0.0  # effective, 2*m*n*k per contributing triple
    hardware_flops: float = 0.0  # flops the kernels issue
    padded_flops: float = 0.0  # tile-granular: 2·T³ a stack entry
    max_memory_bytes: int = 0  # peak device memory seen after a multiply
    #: (collective kind, size decade) -> (message count, total bytes): the
    #: reference's MPI message statistics with size buckets
    #: (``dbcsr_mpi_statistics_type``, ``dbcsr_types.F:578-589``)
    comm_msgs: Dict[Tuple[str, int], Tuple[int, float]] = field(default_factory=dict)
    #: route of a one-shot local product ("dense", "band", "stack", ...) ->
    #: the products that took it
    local_routes: Dict[str, int] = field(default_factory=dict)
    #: bytes the eps filter's kernels (``block/tileops.py``: block norms²,
    #: keep-zeroing) read and write, counted from the plan at each launch:
    #: the stored blocks' elements, the cells' block ids and sums, the
    #: norms² and keep vectors; the zeros written depend on the data and
    #: are not counted. 0 where no launch ran (the plain versions)
    filter_bytes: float = 0.0
    #: bytes the tensor refolds (``block/refold.py``) read and write: each
    #: moved block element read once and written once
    refold_bytes: float = 0.0
    #: contractions run by ``tensors.BatchedContract``, one a batch
    tensor_batches: int = 0
    #: runs of the float64 stack kernel's masked launches cut into more than
    #: one segment (``mm/f64_stack.py``), and the segments (thread blocks)
    #: those launches ran, one a run where none is cut
    split_runs: int = 0
    run_segments: int = 0

    def add_tile_flops(self, issued: float, padded: float) -> None:
        """Count one product's kernel work: the flops issued and the tile
        figure they come from."""
        self.hardware_flops += issued
        self.padded_flops += padded

    def add_segments(self, split_runs: int, run_segments: int) -> None:
        """Count one product's run segments (its plan's, every call)."""
        self.split_runs += split_runs
        self.run_segments += run_segments

    def record_comm(self, kind: str, count: int, msg_bytes: float) -> None:
        """Record ``count`` rank-to-rank messages of ``msg_bytes`` each
        (computed statically from the panel shapes, as the JAX package
        does; ranks that share a device hand tensors over without moving
        them, but the schedule's messages are counted all the same)."""
        if count <= 0 or msg_bytes <= 0:
            return
        bucket = 0
        b = msg_bytes
        while b >= 10:
            b /= 10
            bucket += 1
        cnt, tot = self.comm_msgs.get((kind, bucket), (0, 0.0))
        self.comm_msgs[(kind, bucket)] = (cnt + count, tot + count * msg_bytes)


_stats = MMStats()


def get_stats() -> MMStats:
    return _stats


def reset_stats() -> None:
    global _stats
    _stats = MMStats()


def print_statistics(out=None) -> str:
    s = _stats
    lines = ["-" * 72, " DBCSR-TORCH STATISTICS", "-" * 72]
    lines.append(f" multiplications          {s.num_multiplications}")
    lines.append(f" effective flops          {s.total_flops:.6E}")
    lines.append(f" hardware flops (issued)  {s.hardware_flops:.6E}")
    lines.append(f" padded (tile) flops      {s.padded_flops:.6E}")
    if s.hardware_flops > 0:
        lines.append(
            f" tile packing efficiency  {s.total_flops / s.hardware_flops:.3f}"
        )
    if s.padded_flops > 0:
        lines.append(
            f" tile work skipped        {1.0 - s.hardware_flops / s.padded_flops:.3f}"
        )
    if s.max_memory_bytes:
        lines.append(
            f" max device memory        {s.max_memory_bytes / 1e9:.3f} GB"
        )
    if s.filter_bytes:
        lines.append(f" filter kernel bytes      {s.filter_bytes:.6E}")
    if s.refold_bytes:
        lines.append(f" tensor refold bytes      {s.refold_bytes:.6E}")
    if s.tensor_batches:
        lines.append(f" tensor batches           {s.tensor_batches}")
    if s.run_segments:
        lines.append(f" run segments (split)     {s.run_segments} ({s.split_runs})")
    if s.local_routes:
        lines.append(" local routes             " + ", ".join(
            f"{r} {n}" for r, n in sorted(s.local_routes.items())))
    if s.comm_msgs:
        lines.append(" device communication (collective, message-size bucket)")
        lines.append(f" {'kind':<14} {'size bucket':>14} {'messages':>10} {'bytes':>14}")
        for (kind, bucket), (cnt, tot) in sorted(s.comm_msgs.items()):
            lines.append(
                f" {kind:<14} {'10^' + str(bucket) + ' B':>14} {cnt:>10} {tot:>14.4E}"
            )
    text = "\n".join(lines)
    if out is not None:
        print(text, file=out)
    return text
