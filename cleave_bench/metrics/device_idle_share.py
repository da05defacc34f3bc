"""device_idle_share (%): the share of the traced stretch of whole steps
in which no kernel, copy or set ran on the card."""


def read(ctx):
    t = ctx.trace
    if t is None or t.stretch_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.stretch_s)
