"""The window's replays, as the program recorded them on the device.

The program's ``serve.engine.replay_record()`` (``system.replay_record``)
holds every replay of a captured decode step in the process, by ordinal:
its device time (a CUDA event before the token copy to one after the
replay) and the gap from the previous replay's end, the device waiting on
the host.  ``run.py`` runs ``WARM_UP`` steps, then the window, so the
window's replays are ordinals ``[WARM_UP, WARM_UP + steps)``.  Those
replays and the gaps between them tile the window on the device's clock;
where they do not come within ``TILE`` of the host's window, they are not
the window's, and nothing is read.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

#: the steps ``run.py`` runs before the window
WARM_UP = 3
#: how far the window's replays and gaps may be from the host's window
TILE = 0.02


def window(ctx) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(device ms of each of the window's replays, ms of the gaps between
    them), or ``None``: no card, no record in the program, the window's
    ordinals not held or not yet resolved, or no tiling of the window."""
    try:
        import torch
        if not torch.cuda.is_available():
            return None
        from bench import system
        rec = system.replay_record()
    except (ImportError, AttributeError):
        return None
    steps, seconds = ctx["window"]["steps"], ctx["window"]["seconds"]
    lo = WARM_UP - rec["first"]
    if not steps or lo < 0 or lo + steps > len(rec["device_ms"]):
        return None
    device = rec["device_ms"][lo:lo + steps]
    gaps = rec["gap_ms"][lo + 1:lo + steps]
    if np.isnan(device).any() or np.isnan(gaps).any():
        return None
    tiled = (device.sum() + gaps.sum()) / 1e3
    if abs(tiled - seconds) > TILE * seconds:
        return None
    return device, gaps
