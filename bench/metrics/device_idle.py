"""device_idle: the share of an untraced step in which the device runs no op (device).

1 - (device busy time a step, the union of the ops' intervals over the
profiled steps) / (the mean host time of a step over the window, which no
profiler slows).  The profiler's own window is not the denominator: its
record keeping stretches the gaps between a replayed graph's ~3,600 nodes
by more than the host leaves between steps.  Moves ``tokens_per_s``.
"""


def read(ctx):
    prof, w = ctx.get("profile"), ctx["window"]
    if prof is None or not w["steps"]:
        return None
    busy = prof["busy_s"] / ctx["profile_steps"]
    return 1 - busy / (w["seconds"] / w["steps"])
