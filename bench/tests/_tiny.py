"""A tiny cell for the harness's CPU tests: the real generator and checks,
a 2-layer model of the configuration's families."""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import contextlib  # noqa: E402

import torch  # noqa: E402

from bench import spec  # noqa: E402


@contextlib.contextmanager
def one_thread():
    """Tiny ops run ~6x faster on one thread than on the pool; the count is
    put back after, so the other tests of the process keep theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)

#: limits of the tiny cell, set from its readings on the CPU (dense, seeds
#: 1-6, with and without history, the first batch): sound runs read gap_max
#: <= 0.030 and gap_mean <= 0.0016; the int4 control at least 0.22 and 0.022
LIMITS = {"numbers": {"gap_max": {"limit": 0.1}, "gap_mean": {"limit": 0.008}}}


def config(family: str = "dense") -> dict:
    cfg = {"name": "tiny", "family": family, "arch": "llama", "n_layers": 2,
           "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16, "d_ff": 128,
           "vocab": 97, "mlp_act": "swiglu", "qkv_bias": False, "tie_embeddings": False,
           "rope_theta": 10000.0, "norm_eps": 1e-5, "dtype": "bfloat16"}
    if family == "moe":
        cfg.update(n_experts=4, topk=2, capacity_factor=2.0)
    return cfg


def mix(history: bool = True, bits: int = 8) -> dict:
    return {"generator": "sessions", "batch": 4, "seq_len": 48, "kv_bits": bits,
            "history": {"min": 20, "max": 30, "k_std": 3.0, "v_std": 1.0}
            if history else None,
            "prompt": {"dist": "uniform", "min": 2, "max": 4},
            "response": {"dist": "uniform", "min": 6, "max": 8},
            "turns": "same_sessions" if history else "fresh", "check_requests": 4,
            "profile_steps": 4}


def cell(family: str = "dense", history: bool = True) -> spec.Cell:
    cfg = config(family)
    arch, bridge = spec.architecture(cfg["arch"])
    return spec.Cell(name="tiny.cell", chips=1, config=cfg, arch=arch, bridge=bridge,
                     traffic=mix(history),
                     generator=spec.load_module(spec.BENCH / "traffic" / "sessions.py",
                                                "traffic_sessions"),
                     end_to_end=spec.benchmark(ROOT)["end_to_end"], per_layer=[],
                     readers={}, limits=LIMITS)
