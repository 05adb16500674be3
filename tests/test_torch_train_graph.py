"""The train step as a CUDA graph can capture it (CPU, smoke size).

``train.step.GraphedTrainStep`` captures the whole single-device step on
the card; a graph can only replay what reads and writes tensors at fixed
addresses, with no copy from the host and no value read back.  Here, for
one smoke config of each of the six families:

* under a ``TorchDispatchMode`` the step makes no tensor from host data
  (``aten.lift_fresh`` / ``lift_fresh_copy``) and reads no scalar
  (``aten._local_scalar_dense``), apart from the range check of
  ``F.one_hot`` on CPU tensors (two reads a call: its min and max; the
  CUDA op does not check, which is why mixtral's decode graph captures the
  same routing);
* the step returns the tensors it was given, at the same addresses, with
  ``opt.count`` and ``step`` advanced in place;
* the step's gradient half (the graph's warm-up) leaves the state as it
  was; the graph's static batch is what ``device_batch`` gives the step;
* ``train.loop.train`` restores a checkpoint, or a fresh state where there
  is none yet, into the tensors the step runs on, and resumes with the
  uninterrupted run's losses.

The graph itself runs only on the card (``chip_smoke.py``'s ``train_graph``
phase holds it to the eager step, ``tools/nccl_tp_check.py`` on an NCCL
mesh); on the CPU and on a gloo mesh it raises.  A capture's launches and
collective bytes are taken back and added again at each replay.
"""
import numpy as np
import pytest
import torch

from _torch_ops_seen import OpsSeen
from repro_torch.configs import base as tbase
from repro_torch.data import pipeline as tpipe
from repro_torch.models import model_zoo
from repro_torch.train import step as tstep_mod
from repro_torch.train.loop import LoopConfig, train

#: one smoke config of each family: dense, vlm, moe, ssm, hybrid, encdec
FAMILIES = ("tinyllama-1.1b", "internvl2-76b", "mixtral-8x7b", "mamba2-130m",
            "hymba-1.5b", "whisper-tiny")


def _setup(arch, remat=True):
    cfg = tbase.load_smoke(arch)
    rc = tbase.RunConfig(seq_len=32, global_batch=2, kind="train", q_block=16,
                         kv_block=16, lr=1e-3, remat=remat)
    api = model_zoo.get_api(cfg, rc, "cpu")
    state = tstep_mod.init_state(api, rc, 0)
    pipe = tpipe.SyntheticPipeline(cfg, rc)
    batch = tpipe.device_batch(pipe.next(), cfg, rc, "cpu")
    return cfg, rc, api, state, batch


#: ``F.one_hot`` calls in mixtral's smoke step: two in each of its two
#: layers (``assign``'s capacity slots and ``_aux``'s balance loss), in the
#: forward and again in remat's recompute
MIXTRAL_ONE_HOTS = 8


@pytest.mark.parametrize("arch", FAMILIES)
def test_step_makes_no_host_tensor_and_reads_no_scalar(arch, monkeypatch):
    cfg, rc, api, state, batch = _setup(arch)
    step = tstep_mod.make_train_step(api, cfg, rc)
    ops = OpsSeen().install(monkeypatch)
    with ops:
        step(state, batch)
    seen = ops.summary()
    assert "aten.mm.default" in seen["names"] and len(seen["names"]) > 1000  # backward too
    assert not seen["host_tensors"]
    assert not seen["reads_outside"], "a scalar read outside F.one_hot"
    # the CPU one_hot's range check reads its min and max
    assert seen["reads_inside"] == 2 * ops.calls
    want = MIXTRAL_ONE_HOTS if arch == "mixtral-8x7b" else 0
    assert ops.calls == want


@pytest.mark.parametrize("arch", FAMILIES)
def test_step_updates_the_state_in_place(arch):
    cfg, rc, api, state, batch = _setup(arch)
    tensors = tstep_mod.state_tensors(state)
    ptrs = [t.data_ptr() for t in tensors]
    before = [t.detach().clone() for t in tensors]
    step = tstep_mod.make_train_step(api, cfg, rc)
    for n in (1, 2):
        out, metrics = step(state, batch)
        got = tstep_mod.state_tensors(out)
        assert len(got) == len(tensors)
        assert all(a is b for a, b in zip(got, tensors))
        assert [t.data_ptr() for t in got] == ptrs
        assert int(state.opt.count) == n and int(state.step) == n
        assert state.step.dtype == state.opt.count.dtype == torch.int32
        assert metrics["loss"].dim() == metrics["grad_norm"].dim() == 0
        assert metrics["loss"].dtype == torch.float32
    # the step moved every parameter's moments and most parameters (a
    # bf16 norm weight of 1.0 may round back to 1.0)
    names = [n for n, _ in state.params.named_parameters()]
    assert all(state.opt.nu[n].any() for n in names)
    moved = sum(not torch.equal(a, b) for a, b in zip(tensors[:len(names)], before))
    assert moved > len(names) // 2
    assert all(p.grad is None for p in state.params.parameters())


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mixtral-8x7b", "whisper-tiny"])
def test_gradient_half_leaves_the_state_as_it_was(arch):
    """What the graph's warm-up runs: the loss, backward and the norm, and
    no change to any tensor of the state; its metrics are the full step's."""
    cfg, rc, api, state, batch = _setup(arch)
    before = [t.detach().clone() for t in tstep_mod.state_tensors(state)]
    step = tstep_mod.make_train_step(api, cfg, rc)
    grads, m = step.gradients(state, batch)
    assert set(grads) == {n for n, _ in state.params.named_parameters()}
    for a, b in zip(tstep_mod.state_tensors(state), before):
        assert torch.equal(a, b)
    for p in state.params.parameters():
        p.grad = None
    _, full = step(state, batch)
    assert torch.equal(m["loss"], full["loss"])
    assert torch.equal(m["grad_norm"], full["grad_norm"])


@pytest.mark.parametrize("arch", FAMILIES)
def test_static_batch_is_what_the_step_is_given(arch):
    cfg, rc, _, _, batch = _setup(arch)
    static = tstep_mod.static_batch(cfg, rc, "cpu")
    assert static.keys() == batch.keys()
    for k, t in static.items():
        assert t.shape == batch[k].shape and t.dtype == batch[k].dtype, k
        assert not t.any()


def test_copy_state_copies_every_tensor_in_place():
    cfg, rc, api, state, batch = _setup("hymba-1.5b")
    other = tstep_mod.init_state(api, rc, 7)
    tstep_mod.make_train_step(api, cfg, rc)(other, batch)
    ptrs = [t.data_ptr() for t in tstep_mod.state_tensors(state)]
    tstep_mod.copy_state(state, other)
    assert [t.data_ptr() for t in tstep_mod.state_tensors(state)] == ptrs
    for a, b in zip(tstep_mod.state_tensors(state),
                    tstep_mod.state_tensors(other), strict=True):
        assert torch.equal(a, b)
    assert int(state.step) == 1


def _launch_counter():
    from repro_torch.kernels import ops

    def bump(name, n):
        ops.KERNELS[name].launches += n
    return (ops.launch_counts, ops.reset_launch_counts, ops.take_back_launches,
            ops.add_launches, bump,
            ("flash_attention.flash_fwd", "flash_attention.flash_bwd_dq"))


def _byte_counter(first, second):
    from repro_torch.distributed import collectives as coll

    def reset():
        coll.reset_collective_bytes()
        coll.reset_wire_bytes()

    def bump(name, n):
        if name == "wire":     # what a gather of n bytes of words counts
            coll._gather_words([torch.zeros(n // 4, dtype=torch.int32)], None)
        else:
            coll._moved[name] += n
    return (coll.byte_counts, reset, coll.take_back_bytes, coll.add_bytes, bump,
            (first, second))


#: each host-side counter a replay advances as the eager step would: how
#: to read it, reset it, take back a capture's counts, add them at a
#: replay and raise one of its entries, and two of its entries
COUNTERS = {"launches": _launch_counter,
            "collective_bytes": lambda: _byte_counter("all_gather", "reduce_scatter"),
            "wire_bytes": lambda: _byte_counter("wire", "all_reduce")}


@pytest.mark.parametrize("counter", COUNTERS)
def test_capture_counts_are_taken_back_and_added_at_replay(counter, monkeypatch):
    """What a graph does with the wrappers' launches and the collectives'
    byte counters: a capture's counts are taken back (it launched and
    moved nothing) and added again at each replay."""
    read, reset, take_back, add, bump, (a, b) = COUNTERS[counter]()
    if counter == "wire_bytes":      # a gather of one rank: its own words
        from repro_torch.distributed import collectives as coll
        monkeypatch.setattr(coll, "all_gather", lambda t, group: t[None])
    reset()
    bump(a, 12)
    before = read()
    bump(a, 16)
    bump(b, 8)
    counted = take_back(before)
    assert counted == {a: 16, b: 8}
    assert read() == before
    for _ in range(3):
        add(counted)
    assert read() == dict(before, **{a: 60, b: 24})
    reset()
    assert not any(read().values())


@pytest.mark.parametrize("where", ["cpu", "gloo_mesh"])
def test_graphed_step_needs_a_cuda_device(where, tmp_path):
    """On the CPU the graph is refused for the device; on a mesh of gloo
    groups (one rank here) for the backend, which ``train()`` also reads
    to keep that mesh's step eager."""
    cfg, rc, api, state, _ = _setup("tinyllama-1.1b")
    if where == "cpu":
        with pytest.raises(ValueError, match="CUDA"):
            tstep_mod.GraphedTrainStep(api, cfg, rc, state)
        assert tstep_mod.graph_backend(None) is None
        return
    import torch.distributed as dist

    from repro_torch.launch import mesh as tmesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            rank=0, world_size=1)
    try:
        mesh = tmesh.make_mesh((1, 1), ("data", "model"), "cpu")
        assert tstep_mod.graph_backend(mesh) == "gloo"
        with pytest.raises(ValueError, match="NCCL.*gloo"):
            tstep_mod.GraphedTrainStep(api, cfg, rc, state, mesh)
    finally:
        dist.destroy_process_group()


LOOP_STEPS, LOOP_CKPT = 15, 5


def _loop_config():
    cfg = tbase.load_smoke("tinyllama-1.1b")
    rc = tbase.RunConfig(seq_len=64, global_batch=8, kind="train", remat=False,
                         q_block=32, kv_block=32, lr=1e-3)
    return cfg, rc


def _recording(make, seen):
    """``make_train_step`` whose steps record the state's tensors (id and
    address) at each call."""
    def build(*args, **kw):
        step = make(*args, **kw)

        def run(state, batch):
            seen.append([(id(t), t.data_ptr())
                         for t in tstep_mod.state_tensors(state)])
            return step(state, batch)
        return run
    return build


def _no_graph(*args, **kw):
    raise AssertionError("a graph on the CPU")


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """The run without a failure: its losses, and the tensors each step ran on."""
    cfg, rc = _loop_config()
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tstep_mod, "make_train_step",
                   _recording(tstep_mod.make_train_step, seen))
        mp.setattr(tstep_mod, "GraphedTrainStep", _no_graph)
        out = train(cfg, rc, LoopConfig(ckpt_dir=str(tmp_path_factory.mktemp("a")),
                                        total_steps=LOOP_STEPS, ckpt_every=LOOP_CKPT),
                    device="cpu", log_every=0)
    return out, seen


@pytest.mark.parametrize("fail_at", [2, 13])
def test_loop_restores_into_the_steps_tensors(fail_at, uninterrupted, tmp_path,
                                              monkeypatch):
    """A restart before the first checkpoint (a fresh state) and one after
    (the checkpoint at step 10) copy into the tensors every step runs on,
    and the run ends with the uninterrupted run's losses; the CPU run
    builds no graph."""
    cfg, rc = _loop_config()
    ref, ref_seen = uninterrupted
    assert len(ref_seen) == LOOP_STEPS and all(s == ref_seen[0] for s in ref_seen)
    seen = []
    make = tstep_mod.make_train_step
    monkeypatch.setattr(tstep_mod, "make_train_step", _recording(make, seen))
    monkeypatch.setattr(tstep_mod, "GraphedTrainStep", _no_graph)
    fired = []

    def hook(step):
        if step == fail_at and not fired:
            fired.append(1)
            raise RuntimeError("injected node failure")

    got = train(cfg, rc, LoopConfig(ckpt_dir=str(tmp_path / "b"),
                                    total_steps=LOOP_STEPS, ckpt_every=LOOP_CKPT),
                device="cpu", failure_hook=hook, log_every=0)
    assert got["restarts"] == 1
    assert len(seen) == LOOP_STEPS + fail_at % LOOP_CKPT
    assert all(s == seen[0] for s in seen)
    if fail_at > LOOP_CKPT:
        n = LOOP_STEPS - fail_at // LOOP_CKPT * LOOP_CKPT   # from the checkpoint on
        assert np.allclose(ref["loss"][-n:], got["loss"][-n:], atol=1e-5)
        return
    # no checkpoint yet: a fresh state, the pipeline where it was (as the
    # reference's loop), so the first step after the restart is a fresh
    # state's step on the third batch
    api = model_zoo.get_api(cfg, rc, "cpu")
    fresh = tstep_mod.init_state(api, rc, 0)
    pipe = tpipe.SyntheticPipeline(cfg, rc)
    batches = [pipe.next() for _ in range(fail_at + 1)]
    _, m = make(api, cfg, rc)(fresh, tpipe.device_batch(batches[-1], cfg, rc, "cpu"))
    assert got["loss"][fail_at] == float(m["loss"])
