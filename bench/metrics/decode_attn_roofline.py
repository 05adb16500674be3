"""decode_attn_roofline: the decode attention's share of its byte roofline, in % (kernels).

The bytes its inputs need (q, the codes and f32 scales of the valid slots
only, the positions, the f32 output: ``counts.decode_attention_bytes``)
over 3.35e12 B/s, divided by the kernel's device time, over the profiled
steps.  Its FLOPs (4 x valid slots x heads x hd) are under a tenth of a
percent of the bf16 peak's time, so bytes bound it.  Moves ``tokens_per_s``.
"""
import re

KERNEL = r"decode_attention_kernel"
HBM_BYTES_PER_S = 3.35e12


def read(ctx):
    prof = ctx.get("profile")
    if prof is None or not ctx.get("profile_launches_ok"):
        return None
    hits = [(c, s) for name, c, s in prof["ops"] if re.search(KERNEL, name)]
    if sum(c for c, _ in hits) != ctx["profile_attn_launches"]:
        return None
    seconds = sum(s for _, s in hits)
    return ctx["profile_attn_bytes"] / HBM_BYTES_PER_S / seconds * 100
