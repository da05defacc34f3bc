"""fleet_exec_ms_per_step (ms): the program's
``FleetStepReport.fleet_exec_time`` (the host clock around the fleet executors' work, which ends in a
synchronize), averaged over the window's steps."""


def read(ctx):
    reps = ctx.reports
    if not reps:
        return None
    return 1e3 * sum(r.fleet_exec_time for r in reps) / len(reps)
