"""replay_ms: the mean device time of a window's replay (model step).

From the program's own record (``engine.replay_record``): CUDA events
before each step's token copy and after its graph replay, every step of
the window, no profiler running.  Minus ``busy_ms_per_step`` it is the
graph's own idle between nodes.  Moves ``tokens_per_s``.
"""


def read(ctx):
    from bench import replays
    got = replays.window(ctx)
    return None if got is None else float(got[0].mean())
