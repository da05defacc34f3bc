"""ps_host_ms_per_step (ms): the PS's own host time a step outside the
fleet GEMMs: the self times of the program's ``ps.forward``,
``ps.backward`` and ``ps.adam`` spans and of the model's spans inside
them (``moe.*``, ``mla.*``, ``rwkv.*``, ``ssm.*``); the ``fleet.*`` and
``ops.*`` spans and ``ps.sync`` are left out.  Mean over the window's
steps."""
from cbench.program_spans import per_step


def _ps(name: str) -> bool:
    return not name.startswith(("fleet.", "ops.")) and name != "ps.sync"


def read(ctx):
    s = per_step(ctx, "spans", _ps)
    return None if s is None else 1e3 * s
