"""ps_sync_ms_per_step (ms): self time of the program's ``ps.sync`` span a
step, the wait for the step's queued tail at its end, mean over the
window's steps."""
from cbench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "ps.sync")
