"""replay_ms_p95: the 95th percentile of a window's replay device times (model step).

The same record as ``replay_ms``; above it by ~0.9 ms in a granite cell
is the graph's slow mode inside the window.  Moves ``tokens_per_s``.
"""
import numpy as np


def read(ctx):
    from bench import replays
    got = replays.window(ctx)
    return None if got is None else float(np.percentile(got[0], 95))
