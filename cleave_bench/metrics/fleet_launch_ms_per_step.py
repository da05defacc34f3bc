"""fleet_launch_ms_per_step (ms): self time of the program's
``fleet.launch`` span a step (issuing each bucket's band GEMM, the
Rademacher hash and the Freivalds residual contractions), mean over the
window's steps."""
from cbench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "fleet.launch")
