"""busy_ms_per_step: device busy time a step of the replayed graph (model step).

The union of the device ops' intervals over the profiled steps, divided by
the steps.  Moves ``tokens_per_s``.
"""


def read(ctx):
    prof = ctx.get("profile")
    if prof is None:
        return None
    return prof["busy_s"] / ctx["profile_steps"] * 1e3
