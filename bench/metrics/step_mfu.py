"""step_mfu: the whole step's share of the card's peaks, in % (whole step).

Over the window's unprofiled steps: the sum of each step's least time by
the published peaks (the larger of its FLOPs over 989e12 and its needed
bytes over 3.35e12: ``counts.step_counts``), divided by the window.  A
kernel taken off the path leaves its own roofline silent; this share still
bounds the step.  Moves ``tokens_per_s``.
"""


def read(ctx):
    w = ctx["window"]
    if not w["steps"] or not w["least_s"]:
        return None
    return w["least_s"] / w["seconds"] * 100
