"""fleet_oracle_checks_per_step (count): the program's ``fleet.flagged``
counter a step, the blocks whose device residuals missed the tolerance
and went to the host oracle, mean over the window's steps."""
from cbench.program_spans import count


def read(ctx):
    return count(ctx, "fleet.flagged")
