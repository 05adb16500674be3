"""The assigned (architecture x shape) grid: cells, skips, per-cell RunConfig
(port of ``repro.launch.cells``, over ``repro_torch.configs.base``).

40 cells total; skips (documented in DESIGN.md §5):
  * long_500k on pure full-attention archs — no sub-quadratic mechanism in
    the published configs (and whisper's decoder domain caps at 448);
  * runnable long_500k: mamba2 (SSM state), hymba (SSM + SWA ring cache),
    mixtral (SWA-4096 ring cache).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.configs import base

LONG_OK = {"mamba2-130m", "hymba-1.5b", "mixtral-8x7b"}

SKIPS: Dict[Tuple[str, str], str] = {}
for _a in base.ARCH_IDS:
    if _a not in LONG_OK:
        reason = ("decoder position domain caps at 448 (out-of-family shape)"
                  if _a == "whisper-tiny" else
                  "pure full attention: 512k dense KV per step is "
                  "quadratic-regime with no sub-quadratic mechanism in the "
                  "published config")
        SKIPS[(_a, "long_500k")] = reason


def all_cells() -> List[Tuple[str, str]]:
    return [(a, s) for a in base.ARCH_IDS for s in base.SHAPES]


def runnable_cells() -> List[Tuple[str, str]]:
    return [c for c in all_cells() if c not in SKIPS]


def resolve_run_config(arch: str, shape: str, **overrides) -> base.RunConfig:
    """Per-cell RunConfig: defaults + arch-specific adjustments."""
    cfg = base.load_arch(arch)
    kw: Dict = {}
    if arch == "whisper-tiny":
        # 6 heads / enc_seq 1500: TP/SP indivisible -> replicate those dims
        kw["seq_shard"] = False
    if base.SHAPES[shape][2] == "decode":
        kw["seq_shard"] = False        # no sequence dim at decode
    if arch == "mamba2-130m":
        # SSD chunk dual form: keep chunks at 256; seq shard off (the scan
        # carries state across the whole sequence; SP variant is a §Perf item)
        kw["seq_shard"] = False
    kw.update(overrides)
    return base.run_config_for(shape, cfg, **kw)
