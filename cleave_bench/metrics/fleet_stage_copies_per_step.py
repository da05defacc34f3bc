"""fleet_stage_copies_per_step (count): the program's
``fleet.stage_copies`` counter a step, the padded operand copies built
(not found in the pad cache), mean over the window's steps."""
from cbench.program_spans import count


def read(ctx):
    return count(ctx, "fleet.stage_copies")
