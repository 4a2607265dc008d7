"""The whole step's (or request's) share of the peak, in %: the model
operations of the configuration's ``flops/<config>.py`` for every step or
request of the traced run's steady part (before the profiler starts),
over its wall seconds times the peak of ``peaks.json``."""
import work


def read(ctx):
    wall, ops = ctx.get("steady_wall_s"), ctx.get("steady_flops")
    if not wall or not ops:
        return None
    return 100.0 * ops / (wall * work.OPS_PER_S)
