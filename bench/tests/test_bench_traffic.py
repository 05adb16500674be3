"""The traffic generator: deterministic per seed, inside its ranges, the
same sizes for every seed."""
import numpy as np
import pytest

from _tiny import ROOT
from bench import spec

GEN = spec.load_module(spec.BENCH / "traffic" / "sessions.py", "traffic_sessions")
MIXES = ("chat.int8", "decode32k.int8")
SEEDS = (0, 7, 2**31 + 11, 2**33 + 5)


def steps_of(s):
    """Steps of every batch of ``s``: its longest prompt and response, less one."""
    return int((s.lengths + s.responses).max()) - 1


def mix(name):
    return spec.load_json(ROOT / "bench" / "traffic" / f"{name}.json")


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    a, b = GEN.make(mix(name), 49152, SEEDS[2]), GEN.make(mix(name), 49152, SEEDS[2])
    for i in range(3):
        pa, pb = a.batch(i).prompts, b.batch(i).prompts
        assert all(np.array_equal(x, y) for x, y in zip(pa, pb))
    assert np.array_equal(a.start_positions(), b.start_positions())
    c = GEN.make(mix(name), 49152, SEEDS[3])
    assert not all(np.array_equal(x, y) for x, y in zip(a.batch(0).prompts,
                                                       c.batch(0).prompts))


@pytest.mark.parametrize("name", MIXES)
def test_ranges_and_same_sizes_for_every_seed(name):
    m = mix(name)
    sizes = None
    for seed in SEEDS:
        s = GEN.make(m, 49152, seed)
        for i in range(2):
            b = s.batch(i)
            pairs = sorted(zip((len(p) for p in b.prompts), b.new_tokens.tolist()))
            assert len(pairs) == m["batch"]
            for key, lens in (("prompt", [p for p, _ in pairs]),
                              ("response", [r for _, r in pairs])):
                assert m[key]["min"] <= min(lens) and max(lens) <= m[key]["max"]
            assert all(0 <= p.min() and p.max() < 49152 for p in b.prompts)
            sizes = sizes or pairs
            assert pairs == sizes
        pos = s.start_positions()
        if m["history"] is None:
            assert not pos.any()
        else:
            assert m["history"]["min"] <= pos.min() and pos.max() <= m["history"]["max"]
        assert pos.max() + max(p + r for p, r in sizes) <= m["seq_len"]


def test_chat_lengths_follow_the_lognormal():
    """The quantiles of the lognormal fitted to the source's mean and sd:
    their mean lies near the published one (the cut at the cap and the
    rounding take a little off), their median below it (the tail)."""
    for name in MIXES:
        m = mix(name)
        grid = GEN.quantile_lengths(m["prompt"] | {"min": 1, "max": 10**9}, 4096)
        assert grid.mean() == pytest.approx(m["prompt"]["mean"], rel=0.03)
        assert np.std(grid) == pytest.approx(m["prompt"]["sd"], rel=0.25)
        s = GEN.make(m, 32000, 1)
        for key, got in (("prompt", s.lengths), ("response", s.responses)):
            assert np.median(got) < m[key]["mean"] < got.max()


def test_every_batch_runs_the_same_steps():
    s = GEN.make(mix("chat.int8"), 32000, 5)
    want = steps_of(s)
    for i in range(3):
        b = s.batch(i)
        assert max(len(p) + r for p, r in zip(b.prompts, b.new_tokens)) - 1 == want


class _Server:
    """Stands in for the program: every step's argmax is token 0."""

    def begin_batch(self):
        pass

    def __call__(self, cur):
        return np.zeros(len(cur), np.int64)


def _lockstep(seed=5):
    from _tiny import mix as tiny_mix
    from bench import lockstep
    traffic = GEN.make(tiny_mix(history=False), 97, seed)
    ticks = iter(range(10**6))
    return traffic, lockstep.Lockstep(_Server(), traffic, clock=lambda: next(ticks))


@pytest.mark.parametrize("deadline", [1, 30, 31, 100])
def test_window_is_whole_batches(deadline):
    traffic, ls = _lockstep()
    steps = ls.run_until(deadline)
    assert not ls.in_batch and ls.batches
    assert [b.steps for b in ls.batches] == [steps_of(traffic)] * len(ls.batches)
    assert len(steps) == steps_of(traffic) * len(ls.batches)
    assert all(r.finished for r in ls.requests)
    assert sum(b.generated for b in ls.batches) == \
        len(ls.batches) * int(traffic.responses.sum())


def test_traced_stretch_starts_mid_batch():
    traffic, ls = _lockstep()
    ls.run_until(1)
    ls.run_into_batch(0.5)
    assert ls.in_batch
    assert ls.next_positions()[0] == steps_of(traffic) // 2
