"""A run of the harness without a card: the tiny cell through the real
schedule, the program's eager decode step and the plain reference.  A sound
run is correct; the timed path broken underneath is not; and the control,
the program's int4 cache in the place of its int8 one, reads above the
tiny cell's limits."""
import numpy as np
import pytest
import torch

from _tiny import LIMITS, cell, one_thread
from bench import calibrate, check, run, system

SEED = 2**31 + 77


def run_tiny(family="dense", history=True, seed=SEED):
    with one_thread():
        out, shown, _ = run.run_cell(cell(family, history), seed, 0.5, False, "cpu")
    return out


def test_sound_run_is_correct_and_reports_every_metric():
    out = run_tiny()
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 4
    assert set(out["metrics"]) == {"tokens_per_s", "step_ms_p95", "ttft_ms_p95",
                                   "setup_s"}
    assert list(out)[-1] == "check"
    assert all(v["value"] <= v["limit"] for v in out["check"].values())


def _stuck(self, tokens):
    """A step that returns its state unchanged: the position never moves."""
    pos = self.state.pos.clone()
    logits, top = _sound(self, tokens)
    self.state.pos.copy_(pos)
    return logits, top


def _half(self, tokens):
    """Half of the batch left out: its rows take the mean of the rest."""
    logits, _ = _sound(self, tokens)
    n = logits.shape[0] // 2
    logits = logits.clone()
    logits[n:] = logits[:n].mean(dim=0)
    return logits, torch.argmax(logits, dim=-1)


def _altered(self, tokens):
    """A token altered where it is produced."""
    logits, top = _sound(self, tokens)
    return logits, (top + 1) % logits.shape[-1]


_sound = system.EagerStep.__call__


@pytest.mark.parametrize("fault", [_stuck, _half, _altered], ids=lambda f: f.__name__)
def test_broken_step_is_not_correct(monkeypatch, fault):
    monkeypatch.setattr(system.EagerStep, "__call__", fault)
    out = run_tiny()
    assert not out["correct"] and out["failed"] > 0


@pytest.mark.parametrize("seed", [2, 3])
def test_control_fails_the_limits_the_program_meets(seed):
    with one_thread():
        row = calibrate.readings(cell(), seed, 0.0, True, "cpu")   # the first batch
    lim = LIMITS["numbers"]
    assert row["control_bits"] == 4
    assert all(row["program"][n] <= lim[n]["limit"] for n in lim)
    assert any(row["control"][n] > lim[n]["limit"] for n in lim)


def test_sample_holds_the_longest_finished_request():
    reqs = []
    from bench.lockstep import Request
    for i, (h, n) in enumerate([(5, 3), (9, 4), (2, 2), (9, 1)]):
        r = Request(i, h, np.zeros(n, np.int64), new_tokens=2)
        r.served = [1, 2] if i != 1 else [1]
        reqs.append(r)
    got = check.sample(reqs, 2, 3)        # blocks of rows {0, 1} and {2, 3}
    assert got == [reqs[0], reqs[3]]      # row 1 unfinished; row 3 the longest
