"""The port's mesh paths over gloo ranks on the CPU, against the JAX package.

Ranks are processes started with ``torch.multiprocessing`` (spawn) that
meet through a ``file://`` store; each writes what it returns to a file.
The reference runs in a subprocess (this file's ``__main__``) with 8 host
devices and meshes built with ``AxisType.Auto`` axes (``jax.make_mesh``'s
default ``Explicit`` axes make ``repro.distributed.sharding.act`` raise in
jax 0.9, which is why ``tests/test_distributed.py`` fails), once per module.

Tolerances, f32 (``tests/test_torch_train.py``'s rules): losses within 1e-5
relative; each parameter leaf within 1e-4 of its largest magnitude; the
residuals within 1e-5, except where a code differs by one step (the
reference's jitted step divides ``amax * (1 / qmax)``, ROADMAP Queue 3),
on fewer than 1% of the entries (``tests/test_kernels.py``'s ``kv_quant``
rule).  bf16 against the port's own single-device step: losses within
5e-3 (the reference's ``tests/_distributed_main.py``).
"""
import contextlib
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from _torch_ops_seen import OpsSeen
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.configs import base as tbase
from repro_torch.data import pipeline as tpipe
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model_zoo
from repro_torch.train import step as tstep
from repro_torch.train.loop import LoopConfig, train

ROOT = Path(__file__).resolve().parents[1]
ARCH = "tinyllama-1.1b"
RC = dict(seq_len=64, global_batch=8, kind="train", remat=False, q_block=32,
          kv_block=32, lr=1e-3)
PARITY_MESHES = ((2, 1, 1), (2, 2, 1))
PARITY_BITS = (0, 8, 16)
STEPS = 3
NAMES = ("pod", "data", "model")


# -- ranks -----------------------------------------------------------------------

def _worker(rank: int, world: int, store: str, job: dict, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        torch.save(JOBS[job["kind"]](job), f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _spawn(world: int, job: dict, tmp: Path) -> list:
    out = tmp / f"out_{job['kind']}_{world}_{len(list(tmp.iterdir()))}"
    out.mkdir()
    mp.start_processes(_worker, args=(world, str(out / "store"), job, str(out)),
                       nprocs=world, start_method="spawn")
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _host_tree(tree) -> dict:
    """keystr path -> numpy array, as the reference's checkpoint stores it."""
    return {p: ckpt._host(leaf) for p, leaf in ckpt.flatten(tree)}


def _job_parity(job: dict) -> dict:
    """3 steps at each bits from the reference's initial weights."""
    cfg = tbase.load_smoke(ARCH)
    mesh = tmesh.make_mesh(job["shape"], NAMES, "cpu")
    init = torch.load(job["init"])
    try:
        tmesh.make_production_mesh(multi_pod=True, device="cpu")
        production = "built"
    except ValueError as e:
        production = str(e)
    os.environ["REPRO_MULTI_SHAPE"] = ",".join(map(str, job["shape"]))
    override = tmesh.make_production_mesh(multi_pod=True, device="cpu").shape
    out = {"coords": mesh.coords, "index": mesh.index(("pod", "data")),
           "production": production, "override": override,
           "pod_group": dist.get_process_group_ranks(mesh.get_group("pod")),
           "batch_group": dist.get_process_group_ranks(
               mesh.get_group(("pod", "data")))}
    for bits in PARITY_BITS:
        rc = tbase.RunConfig(**RC, param_dtype="float32", grad_compress_bits=bits)
        api = model_zoo.get_api(cfg, rc, "cpu")
        state = tstep.init_state(api, rc, 0, mesh)
        specs = tstep.param_partition(api, rc, mesh)
        with torch.no_grad():
            for n, p in state.params.named_parameters():
                p.copy_(shd.local_slice(init[n], specs[n], mesh))
        step = tstep.make_train_step(api, cfg, rc, mesh)
        pipe = tpipe.SyntheticPipeline(cfg, rc, seed=3)
        losses, wire = [], []
        seen = OpsSeen()                  # the first step, as a graph captures it
        for i in range(STEPS):
            batch = tpipe.device_batch(pipe.next(), cfg, rc, "cpu", mesh)
            if not i:
                static = tstep.static_batch(cfg, rc, "cpu", mesh)
                layout = [{k: (t.shape, t.dtype) for k, t in b.items()}
                          for b in (static, batch)]
            collectives.reset_wire_bytes()
            with seen if not i else contextlib.nullcontext():
                state, m = step(state, batch)
            wire.append(collectives.wire_bytes_sent())
            losses.append(float(m["loss"]))
        whole = tstep.whole_tree(state, api, rc, mesh)
        ops = seen.summary()
        out[bits] = {"loss": losses, "wire": wire,
                     "local_resid_shape": None if state.resid is None else
                     tuple(next(iter(state.resid.values())).shape),
                     "ops": dict(ops, names=sorted(set(ops["names"])),
                                 n_ops=len(ops["names"])),
                     "static_batch": layout}
        if mesh.rank == 0:
            out[bits]["tree"] = _host_tree(whole)
            out[bits]["stats"] = collectives.exchange_stats(
                tstep.reference_tree(dict(state.params.named_parameters())), bits)
    return out


def _run_steps(cfg, rc, mesh, n: int) -> list:
    api = model_zoo.get_api(cfg, rc, "cpu")
    state = tstep.init_state(api, rc, 0, mesh)
    step = tstep.make_train_step(api, cfg, rc, mesh)
    pipe = tpipe.SyntheticPipeline(cfg, rc, seed=3)
    losses = []
    for _ in range(n):
        state, m = step(state, tpipe.device_batch(pipe.next(), cfg, rc, "cpu", mesh))
        losses.append(float(m["loss"]))
    return losses


def _job_equivalence(job: dict) -> list:
    mesh = tmesh.make_mesh((dist.get_world_size(), 1), ("data", "model"), "cpu")
    rc = tbase.RunConfig(**RC)
    return _run_steps(tbase.load_smoke("yi-9b"), rc, mesh, 5)


def _job_remesh(job: dict) -> dict:
    mesh = tmesh.make_host_mesh("cpu")
    loop = LoopConfig(total_steps=job["steps"], ckpt_every=5, ckpt_dir=job["dir"])
    return train(tbase.load_smoke(ARCH), tbase.RunConfig(**RC), loop, mesh=mesh,
                 device="cpu", log_every=0)


#: the families whose ``model`` axis came last, by the case that runs each
MODEL_AXIS_ARCHES = {"ssm": "mamba2-130m", "hybrid": "hymba-1.5b",
                     "encdec": "whisper-tiny"}
#: the meshes their loops take a step on
MODEL_AXIS_MESHES = {2: ((1, 2), ("data", "model")), 4: ((2, 1, 2), NAMES)}


def _job_model_axis(job: dict) -> dict:
    """One step of ``train.loop.train`` for each family on the world's
    mesh with a ``model`` axis of 2 (a checkpoint written at its end)."""
    shape, names = MODEL_AXIS_MESHES[dist.get_world_size()]
    mesh = tmesh.make_mesh(shape, names, "cpu")
    return {arch: train(tbase.load_smoke(arch), tbase.RunConfig(**RC),
                        LoopConfig(total_steps=1, ckpt_every=5,
                                   ckpt_dir=f"{job['dir']}/{arch}_{len(shape)}"),
                        mesh=mesh, device="cpu", log_every=0)
            for arch in MODEL_AXIS_ARCHES.values()}


JOBS = {"parity": _job_parity, "equivalence": _job_equivalence,
        "remesh": _job_remesh, "model_axis": _job_model_axis}


# -- the reference, in a subprocess ------------------------------------------------

def _oracle(out: str) -> None:
    """The reference's train steps on Auto meshes of 8 host devices."""
    import jax
    from jax.sharding import AxisType

    from repro.configs import base
    from repro.data.pipeline import SyntheticPipeline, device_batch
    from repro.distributed import sharding as shd
    from repro.models import model_zoo as zoo
    from repro.train import step as ts

    cfg = base.load_smoke(ARCH)
    res = {}
    for shape in PARITY_MESHES:
        mesh = jax.make_mesh(shape, NAMES, axis_types=(AxisType.Auto,) * 3,
                             devices=jax.devices()[:math.prod(shape)])
        for bits in PARITY_BITS:
            rc = base.RunConfig(**RC, param_dtype="float32", grad_compress_bits=bits)
            with shd.use_rules(shd.Rules(mesh=mesh, seq_shard=rc.seq_shard,
                                         fsdp=rc.fsdp)):
                api = zoo.get_api(cfg, rc)
                fn = jax.jit(ts.make_train_step(api, cfg, rc, mesh))
                state = ts.init_state(api, rc, jax.random.PRNGKey(0), mesh)
                pipe = SyntheticPipeline(cfg, rc, seed=3)
                losses = []
                for _ in range(STEPS):
                    state, m = fn(state, device_batch(pipe.next(), cfg, rc))
                    losses.append(float(m["loss"]))
            key = f"{shape}/{bits}"
            res[f"{key}/loss"] = np.array(losses)
            for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
                name = jax.tree_util.keystr(path)
                if name.startswith((".params", ".resid")):
                    res[key + name] = np.asarray(leaf)
    np.savez(out, **res)


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    out = tmp_path_factory.mktemp("oracle") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, __file__, "oracle", str(out)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(out))


@pytest.fixture(scope="module")
def reference_init(tmp_path_factory):
    """The reference's initial f32 weights as the port's, in a file."""
    import jax

    from repro.configs import base as jbase
    from repro.models import model_zoo as jzoo
    from repro.train import step as jstep

    rj = jbase.RunConfig(**RC, param_dtype="float32")
    js = jstep.init_state(jzoo.get_api(jbase.load_smoke(ARCH), rj), rj,
                          jax.random.PRNGKey(0))
    ts = convert.state_from_jax(jax.tree.map(np.asarray, js),
                                tbase.load_smoke(ARCH), "cpu")
    path = tmp_path_factory.mktemp("init") / "params.pt"
    torch.save({n: p.detach() for n, p in ts.params.named_parameters()}, path)
    return str(path)


@pytest.fixture(scope="module")
def parity(reference_init, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parity")
    return {shape: _spawn(math.prod(shape), {"kind": "parity", "shape": shape,
                                             "init": reference_init}, tmp)
            for shape in PARITY_MESHES}


@pytest.mark.parametrize("shape", PARITY_MESHES)
@pytest.mark.parametrize("bits", PARITY_BITS)
def test_mesh_steps_match_reference(shape, bits, parity, oracle):
    """Losses, parameters and residuals of 3 steps on gloo ranks against the
    reference's jitted step on the same mesh."""
    ranks = parity[shape]
    key = f"{shape}/{bits}"
    want_loss = oracle[f"{key}/loss"]
    for r in ranks:                                  # every rank, one loss
        got = np.array(r[bits]["loss"])
        assert np.all(np.abs(got - want_loss) <= 1e-5 * np.abs(want_loss)), (got, want_loss)
    tree = ranks[0][bits]["tree"]
    params = {p: v for p, v in tree.items() if p.startswith(".params")}
    assert params and all(key + p in oracle for p in params)
    for p, got in params.items():
        want = oracle[key + p]
        assert got.shape == want.shape, p
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), p
    resid = {p: v for p, v in tree.items() if p.startswith(".resid")}
    assert bool(resid) == bool(bits)
    assert [p for p in oracle if p.startswith(key + ".resid")] == [key + p for p in resid]
    flips = total = 0
    for p, got in resid.items():
        want = oracle[key + p]
        assert got.shape == want.shape == (shape[0],) + params[".params" + p[6:]].shape, p
        # each residual lies within half a code step of zero, so an entry
        # further apart than 1e-5 is a code one step apart
        flips += int((np.abs(got - want) > 1e-5).sum())
        total += got.size
    assert flips < 0.01 * max(total, 1), (flips, total)


@pytest.mark.parametrize("shape", PARITY_MESHES)
def test_mesh_layout_and_wire_bytes(shape, parity):
    """Rank coordinates, groups and batch rows follow the reference's
    row-major mesh; the production mesh needs its 512 ranks and takes
    ``REPRO_MULTI_SHAPE``; each compressed step sends
    ``ExchangeStats.wire_bytes`` and nothing else; a rank holds its own
    pod's residuals."""
    ranks = parity[shape]
    n_pods, n_data = shape[0], shape[1]
    for rank, r in enumerate(ranks):
        assert "needs 512 ranks" in r["production"]     # (2, 16, 16)
        assert r["override"] == dict(zip(NAMES, shape))  # REPRO_MULTI_SHAPE
        assert r["coords"] == dict(zip(NAMES, np.unravel_index(rank, shape)))
        assert r["index"] == rank
        assert r["pod_group"] == [rank % n_data + i * n_data for i in range(n_pods)]
        assert r["batch_group"] == list(range(len(ranks)))
        assert r[0]["wire"] == [0] * STEPS and r[0]["local_resid_shape"] is None
        for bits in (8, 16):
            stats = ranks[0][bits]["stats"]
            assert r[bits]["wire"] == [stats.wire_bytes] * STEPS
            assert r[bits]["local_resid_shape"][0] == 1
    assert ranks[0][8]["stats"].compressed_leaves > 0
    assert ranks[0][8]["stats"].raw_leaves > 0


@pytest.mark.parametrize("shape", PARITY_MESHES)
@pytest.mark.parametrize("bits", PARITY_BITS)
def test_step_makes_no_host_tensor_and_reads_no_scalar(shape, bits, parity):
    """The mesh step, as ``GraphedTrainStep`` captures it on an NCCL mesh
    (``tests/test_torch_train_graph.py`` holds the single-device step):
    under a ``TorchDispatchMode`` in every rank's first step it makes no
    tensor from host data and reads no scalar (tinyllama calls no
    ``F.one_hot``; on CPU tensors gloo stages nothing); the plain path's
    all-reduce or the compressed exchange's gathers ran in it; the graph's
    static batch is the rank's rows that ``device_batch`` gives."""
    for r in parity[shape]:
        ops = r[bits]["ops"]
        assert "aten.mm.default" in ops["names"] and ops["n_ops"] > 1000
        assert "c10d.allreduce_.default" in ops["names"]
        if bits:
            assert "c10d.allgather_.default" in ops["names"] \
                or "c10d._allgather_base_.default" in ops["names"]
        assert not ops["host_tensors"], ops["host_tensors"]
        assert not ops["reads_outside"] and not ops["reads_inside"]
        static, batch = r[bits]["static_batch"]
        assert static == batch
        assert batch["tokens"][0][0] == RC["global_batch"] // (shape[0] * shape[1])


def test_sharded_step_equals_single_device(tmp_path):
    """yi-9b's smoke config, bf16: 5 steps on a (4, 1) data mesh equal the
    single-device step within the reference's 5e-3."""
    dist_losses = _spawn(4, {"kind": "equivalence"}, tmp_path)
    rc = tbase.RunConfig(**RC)
    single = _run_steps(tbase.load_smoke("yi-9b"), rc, None, 5)
    for losses in dist_losses:
        assert np.allclose(losses, single, atol=5e-3), (losses, single)


def test_elastic_remesh_resumes(tmp_path):
    """10 steps on 4 ranks with checkpoints, resumed to 20 on 2 ranks: the
    last 3 losses within 5e-3 of an uninterrupted run."""
    d = str(tmp_path / "ckpt")
    first = _spawn(4, {"kind": "remesh", "steps": 10, "dir": d}, tmp_path)
    second = _spawn(2, {"kind": "remesh", "steps": 20, "dir": d}, tmp_path)
    assert len(first[0]["loss"]) == 10 and len(second[0]["loss"]) == 10
    ref = train(tbase.load_smoke(ARCH), tbase.RunConfig(**RC),
                LoopConfig(total_steps=20, ckpt_every=5, ckpt_dir=str(tmp_path / "ref")),
                device="cpu", log_every=0)
    for h in second:
        assert np.allclose(h["loss"][-3:], ref["loss"][-3:], atol=5e-3), (
            h["loss"][-3:], ref["loss"][-3:])
    assert sorted(os.listdir(d))[-1] == "step_00000020"


def _reference_state_with_residuals():
    """The reference's f32 TrainState on an abstract (2, 1, 1) mesh at bits
    8, its residuals (2, ...) / (2, n_layers, ...) full of seeded noise."""
    import jax
    import jax.numpy as jnp

    from repro.configs import base as jbase
    from repro.launch.mesh import abstract_mesh
    from repro.models import model_zoo as jzoo
    from repro.train import step as jstep

    rj = jbase.RunConfig(**RC, param_dtype="float32", grad_compress_bits=8)
    japi = jzoo.get_api(jbase.load_smoke(ARCH), rj)
    amesh = abstract_mesh((2, 1, 1), NAMES)
    js = jstep.init_state(japi, rj, jax.random.PRNGKey(0), amesh)
    rng = np.random.default_rng(7)
    js = js._replace(resid=jax.tree.map(
        lambda r: jnp.asarray(rng.standard_normal(r.shape), jnp.float32), js.resid))
    return js, jstep.abstract_state(japi, rj, amesh)


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_checkpoints_with_residuals_cross_between_the_packages(direction, tmp_path):
    """Residual leaves in the reference's layout, ``(n_pods, ...)`` and
    ``(n_pods, n_layers, ...)`` where stacked (the port's per-layer parts
    stacked on axis 1): each package restores the other's bit for bit, and
    ``convert.state_from_jax`` gives the same residuals, or one pod's."""
    import jax

    from repro.checkpoint.ckpt import CheckpointManager as JManager

    js, abstract = _reference_state_with_residuals()
    js_np = jax.tree.map(np.asarray, js)
    ct = tbase.load_smoke(ARCH)
    rt = tbase.RunConfig(**RC, param_dtype="float32", grad_compress_bits=8)
    ts = tstep.init_state(model_zoo.get_api(ct, rt, "cpu"), rt, 5)
    full = collectives.init_residuals(dict(ts.params.named_parameters()), 2)
    want = convert.state_from_jax(js_np, ct, "cpu")
    assert want.resid.keys() == full.keys()
    if direction == "reference_to_port":
        JManager(str(tmp_path), async_save=False).save(3, js)
        ckpt.CheckpointManager(str(tmp_path)).restore(
            3, tstep.checkpoint_tree(ts, full))
        for n, r in full.items():
            assert torch.equal(r, want.resid[n]), n
        assert int(ts.step) == 0 and torch.equal(
            ts.params.layers[1].attn.wq, want.params.layers[1].attn.wq)
    else:
        ckpt.CheckpointManager(str(tmp_path), async_save=False).save(
            3, tstep.checkpoint_tree(want))
        out, _ = JManager(str(tmp_path)).restore(3, abstract)
        flat = jax.tree_util.tree_flatten_with_path(out)[0]
        got = {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat}
        for k, v in jax.tree_util.tree_flatten_with_path(js_np)[0]:
            assert np.array_equal(got[jax.tree_util.keystr(k)], v), k
        assert got[".resid.layers.attn.wq"].shape == (2, ct.n_layers, 128, 128)
    pod1 = convert.state_from_jax(js_np, ct, "cpu", pod=1)
    for n, r in pod1.resid.items():
        assert r.shape == (1, *want.resid[n].shape[1:])
        assert torch.equal(r, want.resid[n][1:2]), n


@pytest.fixture(scope="module")
def model_axis_loops(tmp_path_factory):
    """Each family's one-step loop on (1, 2) over (data, model), two ranks,
    and on (2, 1, 2), four ranks; and one device's, by arch."""
    tmp = tmp_path_factory.mktemp("model_axis")
    runs = {len(shape): _spawn(math.prod(shape), {"kind": "model_axis", "dir": str(tmp)}, tmp)
            for shape, _ in MODEL_AXIS_MESHES.values()}
    single = {arch: train(tbase.load_smoke(arch), tbase.RunConfig(**RC),
                          LoopConfig(total_steps=1, ckpt_dir=str(tmp / f"{arch}_1")),
                          device="cpu", log_every=0)["loss"][0]
              for arch in MODEL_AXIS_ARCHES.values()}
    return runs, single, tmp


@pytest.mark.parametrize("case", ["ssm_step", "hybrid_step", "encdec_step",
                                  "encdec_train"])
def test_out_of_slice_meshes_raise(case, model_axis_loops):
    """The ssm, hybrid and encdec families on a 'model' axis above 1, which
    raised NotImplementedError until their slice came (the name is that
    test's): the step builds on (1, 2) and (2, 1, 2), and the loop takes a
    step at smoke size on each (``*_step``: on (1, 2), and for ssm and
    hybrid also on (2, 1, 2); ``encdec_train``: whisper on (2, 1, 2)), every
    rank with the same finite bf16 loss within the reference's 5e-3 of one
    device's, and a checkpoint written at its end."""
    from repro_torch.launch.mesh import abstract_mesh
    arch = MODEL_AXIS_ARCHES[case.split("_")[0]]
    cfg = tbase.load_smoke(arch)
    rc = tbase.RunConfig(**RC)
    api = model_zoo.get_api(cfg, rc, "cpu")
    for shape, names in MODEL_AXIS_MESHES.values():
        tstep.make_train_step(api, cfg, rc, abstract_mesh(shape, names))
    runs, single, tmp = model_axis_loops
    meshes = {"ssm_step": (2, 3), "hybrid_step": (2, 3), "encdec_step": (2,),
              "encdec_train": (3,)}[case]
    for n_axes in meshes:
        losses = [h[arch]["loss"] for h in runs[n_axes]]
        assert all(lo == losses[0] for lo in losses) and len(losses[0]) == 1, losses
        assert np.isfinite(losses[0][0]) and abs(losses[0][0] - single[arch]) < 5e-3, (
            losses[0], single[arch])
        assert "step_00000001" in os.listdir(tmp / f"{arch}_{n_axes}")


if __name__ == "__main__" and sys.argv[1:2] == ["oracle"]:
    _oracle(sys.argv[2])
