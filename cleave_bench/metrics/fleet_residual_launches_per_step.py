"""fleet_residual_launches_per_step (count): the program's
``fleet.residual_launches`` counter a step, the verified band buckets
whose Freivalds residuals ran the fused residual kernel, mean over the
window's steps.  A program that never counts it (one without the kernel)
gives nothing."""
from cbench.program_spans import count

NAME = "fleet.residual_launches"


def read(ctx):
    if not any(NAME in (getattr(r, "counters", None) or {})
               for r in ctx.reports):
        return None
    return count(ctx, NAME)
