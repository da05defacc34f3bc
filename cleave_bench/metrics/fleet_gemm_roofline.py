"""fleet_gemm_roofline (%): the least time of the traced steps' fleet
GEMMs (from their shapes, ``yardstick.gemm_least_s``) over the device
time of every kernel launched inside the ``fleet.fwd``, ``fleet.dA`` and
``fleet.dW`` ranges."""
from cbench.yardstick import gemms_least_s

RANGES = ("fleet.fwd", "fleet.dA", "fleet.dW")


def read(ctx):
    t = ctx.trace
    if t is None or not t.records:
        return None
    device_s = sum(t.range_kernel_s.get(r, 0.0) for r in RANGES)
    if device_s <= 0:
        return None
    return 100.0 * gemms_least_s(t.records) / device_s
