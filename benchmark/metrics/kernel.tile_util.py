"""The share of the program's tile work that the blocks need (%): 100 ·
``total_flops`` / ``hardware_flops`` of ``dbcsr_tpu_torch.core.stats``,
the effective flops (2·m·n·k a block triple) over the tile-granular flops
the kernels issue, counted by the executor on each call."""


def read(ctx):
    from dbcsr_tpu_torch.core.stats import get_stats

    st = get_stats()
    if not st.total_flops or not st.hardware_flops:
        return None
    return 100.0 * st.total_flops / st.hardware_flops
