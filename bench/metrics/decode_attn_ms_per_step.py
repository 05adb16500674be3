"""decode_attn_ms_per_step: device time of the fused decode attention a step (kernels).

``kv_decode_attention`` (``csrc/decode_attention*.cu``): its device time
over the profiled steps divided by the steps, read only where the profile
kept one record a layer and step and the wrappers counted the same
launches.  Moves ``tokens_per_s``.
"""
import re

KERNEL = r"decode_attention_kernel"


def read(ctx):
    prof = ctx.get("profile")
    if prof is None or not ctx.get("profile_launches_ok"):
        return None
    hits = [(c, s) for name, c, s in prof["ops"] if re.search(KERNEL, name)]
    if sum(c for c, _ in hits) != ctx["profile_attn_launches"]:
        return None
    return sum(s for _, s in hits) / ctx["profile_steps"] * 1e3
