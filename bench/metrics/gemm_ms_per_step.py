"""gemm_ms_per_step: device time of the weight GEMMs a step (layers).

The matrix products of the projections, the MLP, the experts and the
unembedding run as cuBLAS kernels; their device time over the profiled
steps, by the name patterns below, divided by the steps.  Moves
``tokens_per_s``.
"""
import re

#: cuBLAS / CUTLASS kernel names on Hopper (gemm, gemv, nvjet, xmma, ...)
PATTERN = r"(?i)gemm|gemv|nvjet|cutlass|xmma|s16816|splitk"


def read(ctx):
    prof = ctx.get("profile")
    if prof is None:
        return None
    s = sum(sec for name, _, sec in prof["ops"] if re.search(PATTERN, name))
    return s / ctx["profile_steps"] * 1e3 if s > 0 else None
