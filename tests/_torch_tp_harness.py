"""Shared harness of the port's tensor-parallel tests
(``tests/test_torch_tensor_parallel.py``,
``tests/test_torch_tensor_parallel_families.py`` and
``tests/test_torch_tensor_parallel_mixers.py``): the ``model`` axis,
ZeRO-3 over ``data`` and the MoE's batch-wide capacity on gloo ranks on the
CPU, against the JAX package.

Ranks are processes started with ``torch.multiprocessing`` (spawn) that
meet through a ``file://`` store; each writes what it returns to a file.
The reference runs in a subprocess (``python tests/_torch_tp_harness.py
oracle out.npz <case> ...``) with 8 host devices and meshes built with
``AxisType.Auto`` axes, once per test module for the module's cases
(``CASES_HERE``), in the background while the ranks run.  The modules
split the cases so that ``--dist loadfile`` runs their references side by
side.  A case may change the smoke config's fields (its last entry); both
sides build the same model.

Tolerances, f32 (``tests/test_torch_distributed.py``'s rules): losses within
1e-5 relative; each parameter leaf within 1e-4 of its largest magnitude;
the residuals within 1e-5, except where a code differs by one step, on
fewer than 1% of the entries.  bf16 against the port's own single-device
step: losses within 5e-3 (the reference's ``tests/_distributed_main.py``).
"""
import dataclasses
import json
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
from torch.overrides import TorchFunctionMode

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
RC = dict(seq_len=64, global_batch=8, kind="train", remat=False, q_block=32,
          kv_block=32, lr=1e-3)
STEPS = 2
NAMES = ("pod", "data", "model")
SAVE = dict(remat=True, remat_policy="save_collectives", tp_scatter=True)
FULL = dict(remat=True, remat_policy="full", tp_scatter=True)
#: mamba2 at d_model 96: di 192, 6 heads of 32, in_proj's 422 columns
#: whole at tp = 4 and gate_norm's 48 rows a rank 1.5 heads (hymba-1.5b's
#: tp = 4 layout)
SSM_H6 = {"d_model": 96}
#: whisper at d_model 192, 6 heads of 32 (48 columns a rank at tp = 4: 1.5
#: heads, G = 1) and 80 frames (the encoder and the cross keys one ragged
#: block, Sk != S)
ENCDEC_H6 = {"d_model": 192, "n_heads": 6, "n_kv_heads": 6, "enc_seq": 80}
#: (arch, mesh, bits, run config overrides, model config overrides), each
#: held against the reference
CASES = {
    "tiny_122": ("tinyllama-1.1b", (1, 2, 2), 0, {}, {}),
    "tiny_212_b0": ("tinyllama-1.1b", (2, 1, 2), 0, {}, {}),
    "tiny_212_b8": ("tinyllama-1.1b", (2, 1, 2), 8, {}, {}),
    "tiny_212_b16": ("tinyllama-1.1b", (2, 1, 2), 16, {}, {}),
    "tiny_114": ("tinyllama-1.1b", (1, 1, 4), 0, {}, {}),    # half a KV head a rank
    # wk's 16 columns a rank cut the codec's 32-value blocks: whole rows
    "tiny_214_b8": ("tinyllama-1.1b", (2, 1, 4), 8, {}, {}),
    "tiny_122_save": ("tinyllama-1.1b", (1, 2, 2), 0, SAVE, {}),
    "moe_122": ("mixtral-8x7b", (1, 2, 2), 0, {}, {}),
    "moe_211": ("mixtral-8x7b", (2, 1, 1), 0, {}, {}),
    "moe_221_b8": ("mixtral-8x7b", (2, 2, 1), 8, {}, {}),
    "vlm_112": ("internvl2-76b", (1, 1, 2), 0, {}, {}),
    "ssm_112": ("mamba2-130m", (1, 1, 2), 0, {}, {}),      # in_proj cut mid-x
    "ssm_122": ("mamba2-130m", (1, 2, 2), 0, {}, {}),
    "ssm_114_h6": ("mamba2-130m", (1, 1, 4), 0, {}, SSM_H6),
    "hybrid_112": ("hymba-1.5b", (1, 1, 2), 0, {}, {}),
    "hybrid_114": ("hymba-1.5b", (1, 1, 4), 0, {}, {}),    # half a KV head a rank
    "hybrid_212_b8": ("hymba-1.5b", (2, 1, 2), 8, {}, {}),
    "hybrid_122_save": ("hymba-1.5b", (1, 2, 2), 0, SAVE, {}),
    "encdec_122": ("whisper-tiny", (1, 2, 2), 0, {}, {}),
    "encdec_114_h6": ("whisper-tiny", (1, 1, 4), 0, {}, ENCDEC_H6),
}
#: cases the port runs beside them, not in the reference
PORT_ONLY = {"tiny_122_full": ("tinyllama-1.1b", (1, 2, 2), 0, FULL, {}),
             "hybrid_122_full": ("hymba-1.5b", (1, 2, 2), 0, FULL, {})}
ALL = {**CASES, **PORT_ONLY}


def _rc(case, **kw):
    _, _, bits, extra, _ = ALL[case]
    return tbase.RunConfig(**{**RC, **extra, **kw}, param_dtype="float32",
                           grad_compress_bits=bits)


def model_key(case) -> str:
    """The case's model: the arch, with its config overrides if any."""
    arch, *_, over = ALL[case]
    return arch + "".join(f" {k}={v}" for k, v in sorted(over.items()))


def case_config(case, base=tbase):
    """The case's model config from ``base`` (the port's ``configs.base``
    or the reference's): the smoke config with the case's overrides."""
    arch, *_, over = ALL[case]
    return dataclasses.replace(base.load_smoke(arch), **over)


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
    return {p: ckpt._host(leaf) for p, leaf in ckpt.flatten(tree)}


def _job_cases(job: dict) -> dict:
    """Each mesh's cases, one mesh after another: the meshes of one world
    size share the ranks."""
    return {(model, shape): _mesh_cases(shape, cases, init)
            for model, shape, cases, init in job["meshes"]}


class _ScanHeads(TorchFunctionMode):
    """The head count of each SSD chunk product the scan runs (its
    ``y_intra`` einsum's ``h``)."""

    def __init__(self):
        super().__init__()
        self.heads = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.einsum and args[0] == "bijh,bjhp->bihp":
            self.heads.append(args[2].shape[2])
        return func(*args, **(kwargs or {}))


def _scan_heads(api, cfg, rc, mesh, state, batch) -> list:
    """The heads the SSD scan runs on this rank in one forward of the loss
    (one count a layer), or [] for a family without the SSD."""
    if cfg.family not in ("ssm", "hybrid"):
        return []
    seen = _ScanHeads()
    with torch.no_grad(), shd.use_rules(tstep.rules_for(rc, mesh)), seen:
        api.loss_fn(state.params, batch)
    return sorted(set(seen.heads))


def _mesh_cases(shape: tuple, cases: list, init_path: str) -> dict:
    """STEPS steps of each case from the reference's initial weights."""
    cfg = case_config(cases[0])
    mesh = tmesh.make_mesh(shape, NAMES, "cpu")
    init = torch.load(init_path)
    out = {"coords": mesh.coords}
    for case in cases:
        rc = _rc(case)
        api = model_zoo.get_api(cfg, rc, "cpu")
        state = tstep.init_state(api, rc, 0, mesh)
        specs = tstep.param_partition(api, rc, mesh)
        with torch.no_grad():
            for n, p in state.params.named_parameters():
                p.copy_(shd.local_slice(init[n], specs[n], mesh))
        step = tstep.make_train_step(api, cfg, rc, mesh)
        pipe = tpipe.SyntheticPipeline(cfg, rc, seed=3)
        losses, moved, rows = [], [], []
        scan = None
        for _ in range(STEPS):
            batch = tpipe.device_batch(pipe.next(), cfg, rc, "cpu", mesh)
            if scan is None:
                scan = _scan_heads(api, cfg, rc, mesh, state, batch)
            rows.append(batch["tokens"].clone())
            collectives.reset_collective_bytes()
            state, m = step(state, batch)
            moved.append(collectives.collective_bytes())
            losses.append(float(m["loss"]))
        named = dict(state.params.named_parameters())
        out[case] = {"loss": losses, "moved": moved, "rows": rows,
                     "coords": mesh.coords, "scan_heads": scan,
                     "local": {n: tuple(p.shape) for n, p in named.items()},
                     "mu": {n: tuple(t.shape) for n, t in state.opt.mu.items()},
                     "resid": None if state.resid is None else
                     {n: tuple(t.shape) for n, t in state.resid.items()},
                     "specs": {n: tuple(s) for n, s in specs.items()}}
        whole = tstep.whole_tree(state, api, rc, mesh)
        out[case]["whole"] = whole is not None
        if mesh.rank == 0:
            out[case]["tree"] = _host_tree(whole)
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
    mesh = tmesh.make_mesh((2, 2), ("data", "model"), "cpu")
    return _run_steps(tbase.load_smoke("yi-9b"), tbase.RunConfig(**RC), mesh, 5)


def _job_remesh(job: dict) -> dict:
    mesh = tmesh.make_mesh(job["shape"], ("data", "model"), "cpu")
    loop = LoopConfig(total_steps=job["steps"], ckpt_every=5, ckpt_dir=job["dir"])
    return train(tbase.load_smoke(job["arch"]), tbase.RunConfig(**RC), loop,
                 mesh=mesh, device="cpu", log_every=0)


ZERO_ARCHES = ("mamba2-130m", "hymba-1.5b", "whisper-tiny")


def _zero_steps(arch: str, mesh) -> tuple:
    """2 f32 steps of ``arch`` from the port's seed-0 weights: the losses
    and the whole parameters (gathered from the ranks' blocks)."""
    cfg = tbase.load_smoke(arch)
    rc = tbase.RunConfig(**RC, param_dtype="float32")
    api = model_zoo.get_api(cfg, rc, "cpu")
    state = tstep.init_state(api, rc, 0, mesh)
    step = tstep.make_train_step(api, cfg, rc, mesh)
    pipe = tpipe.SyntheticPipeline(cfg, rc, seed=3)
    losses = []
    for _ in range(2):
        state, m = step(state, tpipe.device_batch(pipe.next(), cfg, rc, "cpu", mesh))
        losses.append(float(m["loss"]))
    tree = tstep.checkpoint_tree(state) if mesh is None else \
        tstep.whole_tree(state, api, rc, mesh)
    blocks = {n: tuple(p.shape) for n, p in state.params.named_parameters()}
    return losses, _host_tree(tree), blocks


def _job_zero(job: dict) -> dict:
    mesh = tmesh.make_mesh((1, 2, 1), NAMES, "cpu")
    return {arch: _zero_steps(arch, mesh) for arch in ZERO_ARCHES}


JOBS = {"cases": _job_cases, "equivalence": _job_equivalence,
        "remesh": _job_remesh, "zero": _job_zero}


# -- the reference, in a subprocess ------------------------------------------------

def _oracle(out: str, cases) -> None:
    """The reference's jitted steps of ``cases`` on Auto meshes of 8 host
    devices."""
    import jax
    from jax.sharding import AxisType, PartitionSpec as P

    from repro.configs import base
    from repro.data.pipeline import SyntheticPipeline, device_batch
    from repro.distributed import sharding as jshd
    from repro.models import model_zoo as zoo
    from repro.train import step as ts

    res = {}
    for case in cases:
        _, shape, bits, extra, _ = CASES[case]
        cfg = case_config(case, base)
        mesh = jax.make_mesh(shape, NAMES, axis_types=(AxisType.Auto,) * 3,
                             devices=jax.devices()[:math.prod(shape)])
        rc = base.RunConfig(**{**RC, **extra}, param_dtype="float32",
                            grad_compress_bits=bits)
        with jshd.use_rules(jshd.Rules(mesh=mesh, seq_shard=rc.seq_shard,
                                       fsdp=rc.fsdp)):
            api = zoo.get_api(cfg, rc)
            fn = jax.jit(ts.make_train_step(api, cfg, rc, mesh))
            state = ts.init_state(api, rc, jax.random.PRNGKey(0), mesh)
            pipe = SyntheticPipeline(cfg, rc, seed=3)
            losses = []
            for _ in range(STEPS):
                state, m = fn(state, device_batch(pipe.next(), cfg, rc))
                losses.append(float(m["loss"]))
            # the reference's resolved spec of every parameter (the blocks
            # its jitted step holds)
            specs = ts.resolve_state_specs(ts.state_logical_specs(api, rc, mesh),
                                           ts.abstract_state(api, rc, mesh))
        res[f"{case}/loss"] = np.array(losses)
        for path, spec in jax.tree_util.tree_flatten_with_path(
                specs.params, is_leaf=lambda x: isinstance(x, P))[0]:
            res[f"{case}/spec.params{jax.tree_util.keystr(path)}"] = np.array(
                json.dumps([list(_axes(part)) for part in spec]))
        for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
            name = jax.tree_util.keystr(path)
            if name.startswith((".params", ".resid")):
                res[case + name] = np.asarray(leaf)
    np.savez(out, **res)


def _here(request) -> list:
    """The calling module's cases (``CASES_HERE``)."""
    return list(request.module.CASES_HERE)


@pytest.fixture(scope="module")
def oracle_run(request, tmp_path_factory):
    """The reference's subprocess for the module's cases, started when the
    module's first test asks, so the ranks run beside it."""
    out = tmp_path_factory.mktemp("oracle") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"))
    cases = [c for c in _here(request) if c in CASES]
    proc = subprocess.Popen([sys.executable, __file__, "oracle", str(out), *cases],
                            env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                            text=True)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
    proc.wait()


@pytest.fixture(scope="module")
def oracle(oracle_run):
    proc, out = oracle_run
    _, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-3000:]
    return dict(np.load(out))


@pytest.fixture(scope="module")
def reference_init(request, tmp_path_factory, oracle_run):
    """The reference's initial f32 weights as the port's, one file an arch."""
    import jax

    from repro.configs import base as jbase
    from repro.models import model_zoo as jzoo
    from repro.train import step as jstep

    paths = {}
    rj = jbase.RunConfig(**RC, param_dtype="float32")
    for case in _here(request):
        model = model_key(case)
        if model in paths:
            continue
        js = jstep.init_state(jzoo.get_api(case_config(case, jbase), rj), rj,
                              jax.random.PRNGKey(0))
        ts = convert.state_from_jax(jax.tree.map(np.asarray, js),
                                    case_config(case), "cpu")
        paths[model] = str(tmp_path_factory.mktemp("init") / f"{len(paths)}.pt")
        torch.save({n: p.detach() for n, p in ts.params.named_parameters()},
                   paths[model])
    return paths


@pytest.fixture(scope="module")
def ranks(request, reference_init, tmp_path_factory):
    """The module's cases' ranks, each rank's results in rank order by case
    and by (model, mesh): one spawn for each world size."""
    tmp = tmp_path_factory.mktemp("ranks")
    worlds: dict = {}
    for case in _here(request):
        shape = ALL[case][1]
        worlds.setdefault(math.prod(shape), {}).setdefault(
            (model_key(case), shape), []).append(case)
    out = {}
    for world, meshes in worlds.items():
        got = _spawn(world, {"kind": "cases", "meshes": [
            (model, shape, cases, reference_init[model])
            for (model, shape), cases in meshes.items()]}, tmp)
        for key, cases in meshes.items():
            per_rank = [r[key] for r in got]
            out.update({case: [r[case] for r in per_rank] for case in cases})
            out[key] = per_rank
    return out


# -- checks the modules share -------------------------------------------------------

def check_against_reference(case, ranks, oracle) -> None:
    """Losses of every rank, the whole parameters (gathered from the ranks'
    blocks) and the residuals after STEPS steps against the reference's jitted
    step on the same ``Auto`` mesh."""
    got_ranks = ranks[case]
    want_loss = oracle[f"{case}/loss"]
    for r in got_ranks:
        got = np.array(r["loss"])
        assert np.all(np.abs(got - want_loss) <= 1e-5 * np.abs(want_loss)), (got, want_loss)
    tree = got_ranks[0]["tree"]
    params = {p: v for p, v in tree.items() if p.startswith(".params")}
    assert params and all(case + p in oracle for p in params)
    for p, got in params.items():
        want = oracle[case + p]
        assert got.shape == want.shape, p
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), p
    resid = {p: v for p, v in tree.items() if p.startswith(".resid")}
    bits = CASES[case][2]
    assert bool(resid) == bool(bits)
    assert [p for p in oracle if p.startswith(case + ".resid")] == [case + p for p in resid]
    flips = total = 0
    for p, got in resid.items():
        want = oracle[case + p]
        assert got.shape == want.shape, p
        flips += int((np.abs(got - want) > 1e-5).sum())
        total += got.size
    assert flips < 0.01 * max(total, 1), (flips, total)


def _axes(part) -> tuple:
    """A spec entry's mesh axes (a name, a tuple of names or ``None``)."""
    return () if part is None else (part,) if isinstance(part, str) else tuple(part)


def check_reference_blocks(case, ranks, oracle) -> None:
    """Each rank's spec of every parameter is the reference's resolved spec
    (a stacked leaf's without its layer axis), and its local shape is the
    reference's block of the leaf on that spec."""
    names = tstep.reference_tree({n: n for n in ranks[case][0]["specs"]})
    sizes = dict(zip(NAMES, CASES[case][1]))
    seen = 0
    for path, leaf in ckpt.flatten(names):
        want = [tuple(a) for a in json.loads(str(oracle[f"{case}/spec.params{path}"]))]
        whole = oracle[f"{case}.params{path}"].shape
        stacked = isinstance(leaf, ckpt.Stacked)
        if stacked:
            assert want[0] == (), path
            want, whole = want[1:], whole[1:]
        block = tuple(n // math.prod(sizes[a] for a in axes)
                      for n, axes in zip(whole, want))
        for n in (leaf.parts if stacked else [leaf]):
            for r in ranks[case]:
                assert [_axes(p) for p in r["specs"][n]] == want, (n, r["specs"][n], want)
                assert r["local"][n] == block, (n, r["local"][n], block)
            seen += 1
    assert seen == len(ranks[case][0]["specs"])


def check_share(case, ranks) -> None:
    """ZeRO-3 and tensor parallelism: every leaf a rule shards is held as
    its block (the whole shape over the sizes of the axes its spec names),
    the moments and residuals alike; a leaf the rules leave whole (the
    norms over d) is whole on every rank."""
    shape, bits = CASES[case][1:3]
    api = model_zoo.get_api(case_config(case), _rc(case), "cpu")
    whole = tstep.full_shapes(api)
    sizes = dict(zip(NAMES, shape))
    held = 0
    for r in ranks[case]:
        for n, spec in r["specs"].items():
            want = tuple(d // math.prod(sizes[a] for a in shd._axes(part))
                         for d, part in zip(whole[n], spec))
            assert r["local"][n] == r["mu"][n] == want, n
            if bits:
                assert r["resid"][n] == (1, *want), n
            if ".ln" in n or n.endswith(("final_norm", "enc_norm")):
                assert want == whole[n]
        held = sum(math.prod(s) for s in r["local"].values())
    sharded = [n for n, spec in ranks[case][0]["specs"].items() if any(spec)]
    assert sharded and held < sum(math.prod(s) for s in whole.values())


if __name__ == "__main__" and sys.argv[1:2] == ["oracle"]:
    _oracle(sys.argv[2], sys.argv[3:])
