"""fleet_verify_ms_per_step (ms): self time of the program's
``fleet.verify`` span and of the ``fleet.oracle`` span inside it a step
(the host tolerance test of the residuals, the host oracle and the
recompute of flagged blocks), mean over the window's steps."""
from cbench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "fleet.verify", "fleet.oracle")
