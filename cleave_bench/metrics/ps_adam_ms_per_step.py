"""ps_adam_ms_per_step (ms): device time of the kernels launched inside
the program's ``ps.adam`` range, per traced step."""


def read(ctx):
    t = ctx.trace
    if t is None or "ps.adam" not in t.range_kernel_s:
        return None
    return 1e3 * t.range_kernel_s["ps.adam"] / t.steps
