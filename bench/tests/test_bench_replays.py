"""The readers of the program's replay record, on synthetic records: the
window's ordinals, and nothing read where the record does not tile the
window, does not hold it, or there is no card."""
import numpy as np
import pytest
import torch

from _tiny import ROOT
from bench import replays, spec
from repro_torch.serve import engine

READERS = ("replay_ms", "replay_ms_p95", "replay_gap_ms")
STEPS = 6


def _reader(name):
    return spec.load_module(ROOT / "bench" / "metrics" / f"{name}.py", f"metric_{name}")


def _record(first=0, n=STEPS + 5):
    """Replays ``first``..: warm-up ones of 50 ms and gaps of 9 ms, window
    ones of 10 + i ms with gaps of 0.5 + i / 10 ms (ordinals 3..8)."""
    o = np.arange(first, first + n)
    device = np.where((o >= 3) & (o < 3 + STEPS), 10.0 + o - 3, 50.0)
    gap = np.where((o > 3) & (o < 3 + STEPS), 0.5 + (o - 3) / 10, 9.0)
    gap[0] = np.nan if first == 0 else gap[0]
    return {"first": first, "device_ms": device, "gap_ms": gap,
            "host_ms": np.full(n, 0.1)}


WINDOW_MS = sum(10.0 + i for i in range(STEPS)) + sum(0.5 + i / 10 for i in range(1, STEPS))


@pytest.fixture
def record(monkeypatch):
    rec = {"now": _record()}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(engine, "replay_record", lambda: rec["now"])
    return rec


def _ctx(seconds=WINDOW_MS / 1e3, steps=STEPS):
    return {"window": {"steps": steps, "seconds": seconds}}


def test_readers_read_the_windows_replays(record):
    dev = 10.0 + np.arange(STEPS)
    got = {n: _reader(n).read(_ctx()) for n in READERS}
    assert got["replay_ms"] == pytest.approx(dev.mean())
    assert got["replay_ms_p95"] == pytest.approx(np.percentile(dev, 95))
    assert got["replay_gap_ms"] == pytest.approx(np.mean(0.5 + np.arange(1, STEPS) / 10))
    # 1.5% off the host's window still tiles it
    assert _reader("replay_ms").read(_ctx(seconds=WINDOW_MS * 1.015 / 1e3)) \
        == pytest.approx(dev.mean())
    record["now"] = _record(first=2, n=STEPS + 2)      # the record's first is 2
    assert _reader("replay_ms").read(_ctx()) == pytest.approx(dev.mean())


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("case", ["untiled", "not_held", "unresolved", "no_card"])
def test_readers_read_nothing_without_the_window(record, monkeypatch, name, case):
    ctx = _ctx()
    if case == "untiled":     # a window 5% longer than its replays and gaps
        ctx = _ctx(seconds=WINDOW_MS * 1.05 / 1e3)
    elif case == "not_held":
        record["now"] = _record(first=4)
    elif case == "unresolved":
        record["now"]["device_ms"][3 + STEPS - 1] = np.nan
    else:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert replays.window(ctx) is None
    assert _reader(name).read(ctx) is None


def test_readers_read_nothing_from_a_program_without_a_record(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.delattr(engine, "replay_record")
    assert all(_reader(n).read(_ctx()) is None for n in READERS)
