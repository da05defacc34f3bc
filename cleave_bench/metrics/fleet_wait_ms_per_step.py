"""fleet_wait_ms_per_step (ms): self time of the program's
``fleet.readback`` and ``fleet.sync`` spans a step: the host blocked on the
card, for each bucket's residuals and at the end of each fleet GEMM,
mean over the window's steps."""
from cbench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "fleet.readback", "fleet.sync")
