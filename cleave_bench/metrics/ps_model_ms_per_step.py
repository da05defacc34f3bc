"""ps_model_ms_per_step (ms): device time of the kernels launched outside
the ``fleet.fwd``, ``fleet.dA``, ``fleet.dW`` and ``ps.adam`` ranges
(the PS's model ops: attention, experts, WKV, norms, the loss), per
traced step."""

OTHERS = ("fleet.fwd", "fleet.dA", "fleet.dW", "ps.adam")


def read(ctx):
    t = ctx.trace
    if t is None or t.kernel_s <= 0:
        return None
    rest = t.kernel_s - sum(t.range_kernel_s.get(r, 0.0) for r in OTHERS)
    return 1e3 * rest / t.steps
