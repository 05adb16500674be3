"""The traced stretch: ``torch.profiler`` over a few steps of the schedule.

Copied from ``chip_smoke.py::device_profile``, which the port's bring-up
proved on the H100: the session opens ``PAD_S`` before the work and
closes ``PAD_S`` after the device is idle; sentinel spin kernels
(``torch.cuda._sleep``, which nothing measured launches) open and close it,
and their records are left out; a session that keeps fewer records of a
watched kernel than the launches made is taken again, the work run once
more, up to three sessions (the profiler has dropped records at a window's
edge).  The device's busy time is the union of its ops' intervals; its
window runs from the first op's start to the last op's end.

The idle gaps are labelled by the host's range open at the gap's middle:
the benchmark's ``record_function`` ranges around a step's replay and its
argmax copy, or ``schedule`` where none is open.
"""
from __future__ import annotations

import re
import time
from collections import defaultdict
from typing import Callable, Dict, Optional

import torch

PAD_S = 0.05
SENTINELS, SENTINEL_CYCLES = 2, 100_000
SENTINEL_KERNEL = r"\bspin_kernel\b"
TOP = 10


def _device_us(e) -> float:
    return getattr(e, "self_device_time_total", None) or \
        getattr(e, "self_cuda_time_total", 0)


def profile(fn: Callable[[], None], expect: Optional[Dict[str, int]] = None) -> dict:
    """Run ``fn`` under the profiler -> busy and window seconds, every
    device op by name (count, seconds), the longest idle gaps by label.

    ``expect`` maps a kernel-name pattern to the records ``fn`` must leave.
    Returns ``None`` where no session recorded a device op."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    def sentinels():
        for _ in range(SENTINELS):
            torch.cuda._sleep(SENTINEL_CYCLES)
        torch.cuda.synchronize()

    def measured(e) -> bool:
        # the device's copy of a host range (``bench.*``) spans its ops and
        # their gaps: not an op
        return (e.device_type == torch.autograd.DeviceType.CUDA
                and not re.search(SENTINEL_KERNEL, e.name)
                and not e.name.startswith("bench."))

    result = None
    for sessions in range(1, 4):
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            time.sleep(PAD_S)
            sentinels()
            fn()
            torch.cuda.synchronize()
            sentinels()
            time.sleep(PAD_S)
        events = prof.events()
        dev = [e for e in events if measured(e)
               and e.time_range.end > e.time_range.start]
        if not dev:
            continue
        by_name = defaultdict(lambda: [0, 0.0])
        for e in dev:
            by_name[e.name][0] += 1
            by_name[e.name][1] += (e.time_range.end - e.time_range.start) * 1e-6
        kept = {p: sum(c for n, (c, _) in by_name.items() if re.search(p, n))
                for p in (expect or {})}
        ranges = [(e.time_range.start, e.time_range.end, e.name) for e in events
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.name.startswith("bench.")]
        result = _summary(dev, by_name, ranges, sessions)
        if all(kept[p] >= n for p, n in (expect or {}).items()):
            break
    return result


def _summary(dev, by_name, ranges, sessions) -> dict:
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, gaps = 0.0, []
    cur_s, cur_e = spans[0]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s0))
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]

    def label(a, b) -> str:
        mid = (a + b) / 2
        inside = [r for r in ranges if r[0] <= mid <= r[1]]
        return min(inside, key=lambda r: r[1] - r[0])[2] if inside else "bench.schedule"
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    ops = sorted(((n, c, s) for n, (c, s) in by_name.items()),
                 key=lambda o: o[2], reverse=True)
    return {"busy_s": busy * 1e-6, "window_s": window * 1e-6,
            "ops": ops, "sessions": sessions,
            "idle_gaps": [[label(a, b), (b - a) * 1e-6] for a, b in gaps[:TOP]],
            "device_ops": [[n, s] for n, _, s in ops[:TOP]]}
