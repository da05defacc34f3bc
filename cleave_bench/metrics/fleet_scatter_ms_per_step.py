"""fleet_scatter_ms_per_step (ms): self time of the program's
``fleet.scatter`` span a step (the output's allocation, slice writes and
partition checks, the cast to the caller's dtype), mean over the
window's steps."""
from cbench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "fleet.scatter")
