"""step_mfu (%): the model FLOPs of the window's steps (the benchmark's
own count from the configuration's shapes, ``yardstick.step_flops``) over
the window's time at the card's dense bf16 peak."""
from cbench.yardstick import PEAK_BF16


def read(ctx):
    w = ctx.window
    return 100.0 * ctx.flops_per_step * w.steps / w.seconds / PEAK_BF16
