"""replay_gap_ms: the mean device idle between a window's replays (serving engine).

From the program's own record (``engine.replay_record``): each replay's
start event less the previous replay's end event, on the device's clock,
no profiler running: the time the device waits on the host between
steps (the argmax back, the schedule's bookkeeping, the next token in).
Moves ``tokens_per_s``.
"""


def read(ctx):
    from bench import replays
    got = replays.window(ctx)
    return None if got is None or not len(got[1]) else float(got[1].mean())
