"""The decode step's own timing: the replay record, the device marks and
their span table, the capture's ``kernels/*`` counters added at each
replay, and the tracer's clock beside ``torch.profiler``'s.

No card here: CUDA events, streams and the graph are fakes.  A fake event
takes the fake device's clock when recorded, completes when the device
has run through it, and counts the waits on it; the fake graph's replay
does nothing (the step's buffers keep what the capture's eager run wrote).
"""
import contextlib
import json
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.analysis import obs_discipline
from repro_torch.configs import base
from repro_torch.kernels import ops
from repro_torch.models import model_zoo
from repro_torch.serve import engine

REPO = Path(__file__).resolve().parents[1]


class FakeDevice:
    def __init__(self):
        self.now = 0.0       # ms, what the next record reads
        self.records = 0     # events recorded so far
        self.done = 0        # the first this many have completed
        self.waits = 0


class FakeEvent:
    def __init__(self, dev, **_kw):
        self.dev, self.seq, self.t = dev, None, None

    def record(self, stream=None):
        self.seq, self.t = self.dev.records, self.dev.now
        self.dev.records += 1

    def query(self):
        return self.seq < self.dev.done

    def synchronize(self):
        self.dev.waits += 1
        self.dev.done = max(self.dev.done, self.seq + 1)

    def elapsed_time(self, other):
        assert self.query() and other.query(), "read before completion"
        return other.t - self.t


def _replay(rec, dev, ring, n, start, dur, complete=True, **kw):
    """One replay of ring slot ``n % len(ring)`` on the device from
    ``start`` for ``dur`` ms, as ``GraphedDecodeStep.__call__`` enters it."""
    s, e = ring[n % len(ring)]
    rec.resolve()
    rec.release(s, e)
    dev.now = start
    s.record()
    dev.now = start + dur
    e.record()
    out = rec.add("dev", s, e, 0.01 * n, **kw)
    if complete:
        dev.done = dev.records
    return out


def _ring(dev, n):
    return [(FakeEvent(dev), FakeEvent(dev)) for _ in range(n)]


def test_record_reads_device_and_gap_times_by_ordinal():
    dev, rec = FakeDevice(), engine.ReplayRecord(bound=16)
    ring = _ring(dev, 3)
    starts = [2.0, 12.0, 25.0, 31.0, 44.0]
    durs = [5.0, 6.0, 4.0, 7.0, 3.0]
    for n, (t, d) in enumerate(zip(starts, durs)):
        assert _replay(rec, dev, ring, n, t, d) == n
    rec.resolve()
    v = rec.view()
    assert v["first"] == 0 and dev.waits == 0
    np.testing.assert_allclose(v["device_ms"], durs)
    assert np.isnan(v["gap_ms"][0])     # no replay before the first
    np.testing.assert_allclose(v["gap_ms"][1:], [12 - 7, 25 - 18, 31 - 29, 44 - 38])
    np.testing.assert_allclose(v["host_ms"], [0.0, 0.01, 0.02, 0.03, 0.04])


def test_record_resolves_only_completed_pairs():
    dev, rec = FakeDevice(), engine.ReplayRecord(bound=16)
    ring = _ring(dev, 8)
    for n in range(3):
        _replay(rec, dev, ring, n, 10.0 * n, 4.0, complete=False)
    dev.done = 4                        # replays 0 and 1 have completed
    rec.resolve()
    v = rec.view()
    np.testing.assert_allclose(v["device_ms"][:2], [4.0, 4.0])
    assert np.isnan(v["device_ms"][2]) and np.isnan(v["gap_ms"][2])
    assert dev.waits == 0
    dev.done = dev.records
    rec.resolve()
    np.testing.assert_allclose(rec.view()["gap_ms"][1:], [6.0, 6.0])


def test_ring_wrap_waits_only_for_the_pair_it_overwrites():
    """A device that never catches up: the third replay reuses the first
    pair, which replays 0 (its pair) and 1 (its gap's start) still need;
    it waits on replay 1's end alone, and reads both."""
    dev, rec = FakeDevice(), engine.ReplayRecord(bound=16)
    ring = _ring(dev, 2)
    for n in range(2):
        _replay(rec, dev, ring, n, 10.0 * n, 4.0, complete=False)
    assert dev.waits == 0
    _replay(rec, dev, ring, 2, 20.0, 4.0, complete=False)
    assert dev.waits == 1 and dev.done == 4
    v = rec.view()
    np.testing.assert_allclose(v["device_ms"][:2], [4.0, 4.0])
    np.testing.assert_allclose(v["gap_ms"][1], 6.0)
    assert np.isnan(v["device_ms"][2])
    _replay(rec, dev, ring, 3, 30.0, 4.0, complete=False)
    assert dev.waits == 2


def test_record_keeps_the_last_bound_replays_and_resets():
    dev, rec = FakeDevice(), engine.ReplayRecord(bound=4)
    ring = _ring(dev, 3)
    for n in range(7):
        _replay(rec, dev, ring, n, 10.0 * n, 1.0 + n)
    rec.resolve()
    v = rec.view()
    assert v["first"] == 3 and len(v["device_ms"]) == 4
    np.testing.assert_allclose(v["device_ms"], [4.0, 5.0, 6.0, 7.0])
    rec.reset()
    assert rec.view()["first"] == 0 and len(rec.view()["device_ms"]) == 0
    _replay(rec, dev, ring, 0, 100.0, 2.0)
    rec.resolve()
    assert np.isnan(rec.view()["gap_ms"][0])


def test_record_publishes_to_obs_only_while_on():
    dev, rec = FakeDevice(), engine.ReplayRecord(bound=8)
    ring = _ring(dev, 2)
    live = obs.registry()
    before = len(live)
    with obs.disabled_scope():
        for n in range(3):
            _replay(rec, dev, ring, n, 10.0 * n, 4.0, registry=None)
        rec.resolve()
    assert len(live) == before
    with obs.enabled_scope() as (reg, _):
        for n in range(3, 6):
            _replay(rec, dev, ring, n, 10.0 * n, 4.0,
                    registry=obs.registry(), labels={"arch": "a"})
        rec.resolve()
    snap = reg.snapshot().histograms
    assert snap["serve/replay_ms{arch=a}"]["count"] == 3
    assert snap["serve/replay_gap_ms{arch=a}"]["mean"] == pytest.approx(6.0)
    assert snap["serve/step_host_ms{arch=a}"]["count"] == 3
    assert len(live) == before


# ---------------------------------------------------------------------------
# device marks
# ---------------------------------------------------------------------------

def test_span_table_adds_each_names_intervals():
    names = ["embed", "attn", "ffn", "attn", "ffn", "head"]
    got = obs.span_table(names, [1.0, 2.0, 3.0, 2.5, 3.5, 0.5])
    assert got == {"embed": 1.0, "attn": 4.5, "ffn": 6.5, "head": 0.5}
    with pytest.raises(ValueError, match="intervals"):
        obs.span_table(names, [1.0])


def test_device_marks_time_the_intervals_between_marks():
    dev = FakeDevice()
    with obs.device_marks(lambda: FakeEvent(dev)) as marks:
        for t, name in [(0.0, "a"), (1.5, "b"), (4.0, "a"), (4.25, "b")]:
            dev.now = t
            obs.device_mark(name)
        dev.now = 7.0
    dev.done = dev.records
    assert marks.names == ["a", "b", "a", "b"] and marks.end is not None
    assert marks.table() == {"a": 1.5 + 0.25, "b": 2.5 + 2.75}


def test_device_mark_is_a_no_op_outside_a_recorder():
    assert obs.instrument._marks is None
    obs.device_mark("embed")            # no event, no error without a card
    with obs.enabled_scope():
        obs.device_mark("embed")
    assert obs.instrument._marks is None


def _smoke(arch, bits=8):
    cfg = base.load_smoke(arch)
    rc = base.RunConfig(seq_len=32, global_batch=2, kind="decode",
                        param_dtype="float32", kv_cache_bits=bits)
    api = model_zoo.get_api(cfg, rc, "cpu")
    return cfg, api, api.init(0)


LAYER_MARKS = {"granite-8b": ["attn.norm", "attn.qkv", "attn.store", "attn.kernel",
                              "attn.out", "ffn"],
               "mixtral-8x7b": ["attn.norm", "attn.qkv", "attn.store", "attn.kernel",
                                "attn.out", "ffn", "moe.route", "moe.dispatch",
                                "moe.experts", "moe.combine"]}


@pytest.mark.parametrize("arch", list(LAYER_MARKS))
def test_decode_step_is_bitwise_the_same_with_marks(arch):
    cfg, api, params = _smoke(arch)
    tokens = torch.tensor([3, 7])
    plain, marked = api.init_decode_state(2), api.init_decode_state(2)
    dev = FakeDevice()
    for _ in range(2):
        lp, plain = api.decode_step(params, plain, tokens)
        with obs.enabled_scope(), obs.device_marks(lambda: FakeEvent(dev)) as m:
            lm, marked = api.decode_step(params, marked, tokens)
        assert torch.equal(lp, lm)
        for a, b in zip(api.cache_leaves(plain), api.cache_leaves(marked)):
            assert torch.equal(a, b)
        assert torch.equal(plain.pos, marked.pos)
    assert m.names == ["embed"] + LAYER_MARKS[arch] * cfg.n_layers + ["head"]


# ---------------------------------------------------------------------------
# the graphed step on fakes: the record, the marks, the kernels/* counters
# ---------------------------------------------------------------------------

class FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


class _Stream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def fake_cuda(monkeypatch):
    """torch.cuda's capture, streams and events as fakes on one device."""
    dev = FakeDevice()
    clock = iter(range(0, 10**9, 250_000))           # 0.25 ms a read
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", lambda d=None: _Stream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Event", lambda **kw: FakeEvent(dev, **kw))
    monkeypatch.setattr(engine, "perf_counter_ns", lambda: next(clock))
    monkeypatch.setattr(engine, "_RECORD", engine.ReplayRecord(bound=64))
    return dev


def _kernel_series(reg):
    return {k: v for k, v in reg.snapshot().counters.items()
            if k.startswith("kernels/")}


def test_graphed_step_records_each_replay(fake_cuda):
    cfg, api, params = _smoke("granite-8b")
    with obs.disabled_scope():
        step = engine.GraphedDecodeStep(api, params, 2, "cpu", cfg.name)
        assert step.marks is None
        for n in range(engine.RING + 2):
            fake_cuda.now += 3.0
            step(torch.tensor([1, 2]))
            fake_cuda.done = fake_cuda.records
        rec = engine.replay_record()
    assert step.graph.replays == engine.RING + 2 and fake_cuda.waits == 0
    assert rec["first"] == 0 and len(rec["device_ms"]) == engine.RING + 2
    np.testing.assert_allclose(rec["gap_ms"][1:], 3.0)
    np.testing.assert_allclose(rec["host_ms"], 0.25)  # two clock reads a call
    engine.reset_replay_record()
    assert len(engine.replay_record()["device_ms"]) == 0


def test_capture_counters_are_added_at_each_replay_while_obs_is_on(fake_cuda):
    cfg, api, params = _smoke("granite-8b")
    with obs.enabled_scope() as (reg, tracer):
        launches = ops.launch_counts()
        step = engine.GraphedDecodeStep(api, params, 2, "cpu", cfg.name)
        assert ops.launch_counts() == launches
        assert _kernel_series(reg) == {} and tracer.records == []
        counted = {(n, tuple(sorted(lb.items()))): v
                   for n, lb, v in step.kernel_counts}
        calls = [v for (n, lb), v in counted.items() if n == "kernels/calls"]
        # the packed store and the decode attention, one each a layer
        assert calls == [cfg.n_layers] * 2
        for _ in range(3):
            step(torch.tensor([1, 2]))
            fake_cuda.done = fake_cuda.records
        series = _kernel_series(reg)
        assert series == {obs.series_key(n, dict(lb)): 3 * v
                          for (n, lb), v in counted.items()}
        assert [r.name for r in tracer.records] == ["serve/step"] * 3
    with obs.disabled_scope():
        step(torch.tensor([1, 2]))
    assert _kernel_series(reg) == series


def test_graphed_step_with_obs_on_publishes_its_span_table(fake_cuda):
    cfg, api, params = _smoke("granite-8b")
    with obs.enabled_scope() as (reg, _):
        step = engine.GraphedDecodeStep(api, params, 2, "cpu", cfg.name)
        names = step.marks.names
        assert names == (["embed"] + LAYER_MARKS["granite-8b"] * cfg.n_layers
                         + ["head", "argmax"])
        # the marks fire at every replay: give each interval 0.5 ms
        for i, ev in enumerate(step.marks.events + [step.marks.end]):
            ev.t = 0.5 * i
        fake_cuda.done = fake_cuda.records
        step(torch.tensor([1, 2]))
        step(torch.tensor([1, 2]))      # the first replay is read before
        assert fake_cuda.waits == 1     # the marks fire again
    spans = {k: h for k, h in reg.snapshot().histograms.items()
             if k.startswith("decode/span_ms")}
    per = {k.split("span=")[1].rstrip("}"): h for k, h in spans.items()}
    assert per["attn.kernel"]["count"] == 1
    assert per["attn.kernel"]["sum"] == pytest.approx(0.5 * cfg.n_layers)
    assert per["embed"]["sum"] == pytest.approx(0.5)
    assert sum(h["sum"] for h in per.values()) == pytest.approx(0.5 * len(names))


# ---------------------------------------------------------------------------
# the tracer's clock and torch.profiler's
# ---------------------------------------------------------------------------

def test_tracer_and_profiler_share_one_timeline(tmp_path):
    from torch.profiler import ProfilerActivity, profile, record_function
    tracer = obs.Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm-up"):   # a first range takes ~0.3 ms
            pass
        with tracer.span("block"), record_function("block"):
            torch.ones(8).sum()
    path = tmp_path / "prof.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    theirs = [e["ts"] for e in doc["traceEvents"] if e.get("name") == "block"]
    ours = tracer.chrome_trace(base_ns=doc.get("baseTimeNanoseconds", 0))
    assert len(theirs) == 1 and len(ours["traceEvents"]) == 1
    assert abs(ours["traceEvents"][0]["ts"] - theirs[0]) < 100
    # the default base is the one the export took
    assert tracer.chrome_trace()["baseTimeNanoseconds"] == \
        doc.get("baseTimeNanoseconds", 0)


# ---------------------------------------------------------------------------
# the obs-discipline pass and the one call meant for captured code
# ---------------------------------------------------------------------------

def test_obs_pass_flags_a_counter_in_decode_step_and_not_its_marks():
    src = (REPO / "src/repro_torch/models/transformer.py").read_text()
    head = "    obs.device_mark(\"head\")\n"
    assert src.count(head) == 1 and "obs.device_mark(\"embed\")" in src
    src = src.replace(head, head + "    obs.counter_inc(\"bad/step\", 1)\n")
    src += textwrap.dedent("""

        def _captured(graph, *args):
            with torch.cuda.graph(graph):
                return decode_step(*args)
    """)
    fs = obs_discipline.run_pass(
        obs_discipline.scan_source(src, "repro_torch/models/transformer.py"))
    assert len(fs) == 1, [f.message for f in fs]
    assert "counter_inc" in fs[0].message and "decode_step" in fs[0].message
