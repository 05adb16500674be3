"""row_use: the share of row-steps that yield a generated token (serving engine).

Generated tokens over batch x steps run, counted from the window's
schedule: a lockstep batch spends a row-step on every teacher-forced
prompt token and on every row that has already finished.  Moves
``tokens_per_s``.
"""


def read(ctx):
    w = ctx["window"]
    if not w["steps"]:
        return None
    return w["generated"] / (w["batch"] * w["steps"])
