"""fleet_stage_ms_per_step (ms): self time of the program's ``fleet.stage``
span and of the ``ops.stage_copy`` span inside it a step (the operands'
geometry, padding and casting, the cache lookups), mean over the
window's steps."""
from cbench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "fleet.stage", "ops.stage_copy")
