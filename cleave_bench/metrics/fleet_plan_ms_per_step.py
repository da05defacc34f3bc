"""fleet_plan_ms_per_step (ms): self time of the program's ``fleet.plan``
span a step (plan lookup or solve, the task list, the plan's price), mean
over the window's steps."""
from cbench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "fleet.plan")
