"""The port's decode step on a mesh against the JAX package (CPU).

* The decode state's logical trees (``layers.cache_specs``,
  ``ssm.ssm_state_specs``, ``transformer`` / ``encdec.decode_state_specs``,
  ``ModelApi.decode_state_specs``) path for path equal to the reference's,
  and their resolution on the production meshes, (16, 16) over ``data,
  model`` and (2, 16, 16) over ``pod, data, model``, for every runnable
  decode cell at its full size: the reference's resolved on a
  ``jax.sharding.AbstractMesh``, the port's on ``launch.mesh.abstract_mesh``
  (shapes only: the port's state on the ``meta`` device, the reference's
  from ``jax.eval_shape``).
* ``api.decode_step`` on gloo ranks (processes started with
  ``torch.multiprocessing``, one spawn a world size for every case of that
  size, the worlds side by side) against the reference's single-device
  jitted ``decode_step`` from the same weights (``convert.params_from_jax``)
  and the same teacher-forced seeded tokens, STEPS steps past hymba's
  64-slot ring: the logits of every step on every rank within the f32
  rule of ``tests/test_torch_families.py`` (1e-4), each rank's blocks of
  the state shaped by the reference's resolved specs, the state gathered
  from the ranks' blocks
  (``sharding.assemble``) equal to the reference's (f32 within 1e-4; a
  packed cache through dequantization, one code step allowed on fewer
  than 1% of the entries, ``tests/test_kernels.py``'s rule), and the SSM
  state the same on every ``model`` rank.  A packed cache's new codes are
  held to the reference's after every step, within one code step and on
  fewer than 1% of the codes written; where a code lay one step apart
  (a value at a rounding boundary), the ranks take the reference's
  (``_follow``) and that one step's logits are held to TIE_REL of the
  largest logit.
* A row whose slot another rank holds leaves that rank's cache
  bit-unchanged (``layers._store_held``), at bits 16 and 8.
"""
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp

from repro.configs import base as jbase
from repro.distributed import sharding as jshd
from repro.kernels import ref as jref
from repro.launch import cells as jcells
from repro.launch.mesh import abstract_mesh as jabstract
from repro.models import model_zoo as jzoo
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.configs import base as tbase
from repro_torch.distributed import sharding as shd
from repro_torch.launch import cells
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models import model_zoo
from repro_torch.train import step as tstep

NAMES = ("data", "model")
MESHES = (((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")))
B, STEPS = 4, 72
F32_TOL = 1e-4
#: a step at which a row's new cache code lies one step from the
#: reference's (a value at a rounding boundary, which the two sides' sums
#: put on either side): that step's logits read the differing code, within
#: this share of the largest logit; the ranks then take the reference's
#: codes (``_follow``) and the next steps are held to F32_TOL again
TIE_REL = 1e-3
#: (arch, (data, model), kv_cache_bits, seq_len)
CASES = {
    "tiny_12_b16": ("tinyllama-1.1b", (1, 2), 16, 80),
    "tiny_12_b8": ("tinyllama-1.1b", (1, 2), 8, 80),
    "tiny_12_b4": ("tinyllama-1.1b", (1, 2), 4, 80),
    # 81 slots do not split over model: the cache whole, each rank's heads
    "tiny_12_b8_whole": ("tinyllama-1.1b", (1, 2), 8, 81),
    "tiny_22_b16": ("tinyllama-1.1b", (2, 2), 16, 80),
    "tiny_22_b8": ("tinyllama-1.1b", (2, 2), 8, 80),
    "tiny_22_b4": ("tinyllama-1.1b", (2, 2), 4, 80),
    "hybrid_12_b8": ("hymba-1.5b", (1, 2), 8, 80),      # the 64-slot ring
    "moe_12": ("mixtral-8x7b", (1, 2), 16, 80),
    "ssm_12": ("mamba2-130m", (1, 2), 16, 80),
    "encdec_12_b8": ("whisper-tiny", (1, 2), 8, 80),
}
#: the worlds, each one spawn of gloo ranks
WORLDS = {2: [c for c, v in CASES.items() if v[1] == (1, 2)],
          4: [c for c, v in CASES.items() if v[1] == (2, 2)]}


def _rc(mod, bits, seq):
    return mod.RunConfig(seq_len=seq, global_batch=B, kind="decode",
                         param_dtype="float32", kv_cache_bits=bits,
                         q_block=16, kv_block=16, remat=False)


def _np(t):
    return convert.to_numpy(t).astype(np.float32)


# -- the logical trees and their resolution at full size --------------------------

DECODE_CELLS = [c for c in cells.runnable_cells()
                if cells.resolve_run_config(*c).kind == "decode"]


def test_the_decode_cells_are_the_references():
    assert DECODE_CELLS == [c for c in jcells.runnable_cells()
                            if jcells.resolve_run_config(*c).kind == "decode"]
    assert {s for _, s in DECODE_CELLS} == {"decode_32k", "long_500k"}


@pytest.mark.parametrize("arch,shape", DECODE_CELLS)
def test_decode_state_specs_match_reference_on_production_meshes(arch, shape):
    rc, jrc = cells.resolve_run_config(arch, shape), jcells.resolve_run_config(arch, shape)
    api = model_zoo.get_api(tbase.load_arch(arch), rc, "meta")
    japi = jzoo.get_api(jbase.load_arch(arch), jrc)
    logical, jlogical = api.decode_state_specs(), japi.decode_state_specs()
    flat = jax.tree_util.tree_flatten_with_path(jlogical, is_leaf=jshd._is_logical_leaf)[0]
    assert ckpt.flatten(logical) == [(jax.tree_util.keystr(k), v) for k, v in flat]
    tree = api.state_tree(api.init_decode_state(rc.global_batch))
    jabs = jax.eval_shape(lambda: japi.init_decode_state(jrc.global_batch))
    assert [(p, ckpt.leaf_shape(t)) for p, t in ckpt.flatten(tree)] == \
        [(jax.tree_util.keystr(k), a.shape)
         for k, a in jax.tree_util.tree_flatten_with_path(jabs)[0]]
    for sizes, names in MESHES:
        with shd.use_rules(shd.Rules(mesh=abstract_mesh(sizes, names))):
            got = ckpt.flatten(shd.spec_tree(logical, tree))
        with jshd.use_rules(jshd.Rules(mesh=jabstract(sizes, names))):
            want = jax.tree_util.tree_flatten_with_path(
                jshd.spec_tree(jlogical, jabs),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
        assert [(p, tuple(s)) for p, s in got] == \
            [(jax.tree_util.keystr(k), tuple(s)) for k, s in want], (sizes, names)
        assert dict(got)[".pos"] == shd.P(None)


# -- the step on gloo ranks against the reference --------------------------------

def _reference(case):
    """The reference's model, run config, weights and STEPS jitted decode
    steps on the whole batch: (params, tokens, cross K/V or None, logits a
    step, final state)."""
    arch, _, bits, seq = CASES[case]
    cfg, rc = jbase.load_smoke(arch), _rc(jbase, bits, seq)
    api = jzoo.get_api(cfg, rc)
    params = api.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab, (STEPS, B)).astype(np.int32)
    state = api.init_decode_state(B)
    cross = None
    if cfg.family == "encdec":
        cross = [(rng.standard_normal(state.cross_k.shape) * 0.5).astype(np.float32)
                 for _ in range(2)]
        state = state._replace(cross_k=jnp.asarray(cross[0]),
                               cross_v=jnp.asarray(cross[1]))
    step = jax.jit(api.decode_step)
    logits, sync = [], []
    for t in range(STEPS):
        lg, state = step(params, state, jnp.asarray(toks[t]))
        logits.append(np.asarray(lg, dtype=np.float32))
        if bits != 16:
            sync.append({jax.tree_util.keystr(k): np.asarray(a) for k, a in
                         jax.tree_util.tree_flatten_with_path(state)[0]
                         if _packed(jax.tree_util.keystr(k))})
    return (jax.tree.map(np.asarray, params), toks, cross, np.stack(logits),
            jax.tree.map(np.asarray, state), sync)


def _packed(path: str) -> bool:
    """A leaf of a packed self-attention cache: its codes or scales."""
    return path.startswith((".caches.kv.", ".self_kv."))


def _codes(t: torch.Tensor, bits: int) -> torch.Tensor:
    """int8 codes, or int4 codes two a byte unpacked (low nibble first)."""
    if bits == 8:
        return t.int()
    c = t.int()
    return torch.stack([((c & 0xF) ^ 0x8) - 0x8, (((c >> 4) & 0xF) ^ 0x8) - 0x8], -1)


def _follow(tree, specs: dict, want: dict, mesh, bits: int, seen: dict) -> None:
    """The reference's packed cache after a step (``want``, whole leaves
    by path) against this rank's blocks: every code within one code step
    of the reference's and every scale within 1e-5 of it (relative), the
    differing codes counted in ``seen``; then this rank's blocks take the
    reference's codes and scales, as ``chip_smoke.py``'s ``lm_parity``
    takes the card's where the two round a value apart at a boundary, so
    that each step starts from the reference's cache."""
    leaves = dict(ckpt.flatten(tree))
    for path, whole in want.items():
        spec = shd.P(*specs[path][1:])
        for i, part in enumerate(leaves[path].parts):
            ref = shd.local_slice(torch.from_numpy(whole[i]), spec, mesh)
            if path.endswith("scale"):
                rel = ((part - ref).abs() / ref.abs()).max().item()
                seen["scale_rel"] = max(seen["scale_rel"], rel)
            else:
                d = (_codes(part, bits) - _codes(ref, bits)).abs()
                seen["max_step"] = max(seen["max_step"], int(d.max()))
                seen["differ"] += int((d > 0).sum())
                seen["codes"] += d.numel()
            part.copy_(ref)


def _held_case(mesh, bits: int) -> bool:
    """One step of tinyllama on caches of seeded noise, rows 0-1 at slots
    of rank 0's block and rows 2-3 at slots of rank 1's: each rank's cache
    changes at its held rows' slots only."""
    cfg, rc = tbase.load_smoke("tinyllama-1.1b"), _rc(tbase, bits, 80)
    api = model_zoo.get_api(cfg, rc, "cpu")
    params = api.init(0)
    specs = tstep.param_partition(api, rc, mesh)
    for n, p in params.named_parameters():
        shd.shard_parameter(p, specs[n], mesh)
    state = api.init_decode_state(B, mesh=mesh)
    gen = torch.Generator().manual_seed(11 + mesh.rank)
    for t in api.cache_leaves(state):
        t.copy_(torch.randint(-100, 100, t.shape, generator=gen) if t.dtype == torch.int8
                else torch.rand(t.shape, generator=gen) + 0.5)
    slots = torch.tensor([3, 39, 40, 79], dtype=torch.int32)   # S / tp = 40
    state.pos.copy_(slots)
    before = [t.clone() for t in api.cache_leaves(state)]
    with shd.use_rules(tstep.rules_for(rc, mesh)):
        api.decode_step(params, state, torch.arange(B))
    lo = mesh.coords["model"] * 40
    ok = True
    for old, new in zip(before, api.cache_leaves(state)):
        changed = (old != new).reshape(B, 40, -1).any(-1)
        for b in range(B):
            held = lo <= int(slots[b]) < lo + 40
            others = torch.ones(40, dtype=torch.bool)
            if held:
                others[int(slots[b]) - lo] = False
            ok &= not bool(changed[b, others].any())
            ok &= (not held) or bits == 16 or bool(changed[b, int(slots[b]) - lo])
    return ok


def _run_case(case, mesh, init, cross, sync) -> dict:
    arch, _, bits, seq = CASES[case]
    cfg, rc = tbase.load_smoke(arch), _rc(tbase, bits, seq)
    api = model_zoo.get_api(cfg, rc, "cpu")
    params = api.init(0)
    specs = tstep.param_partition(api, rc, mesh)
    with torch.no_grad():
        for n, p in params.named_parameters():
            p.copy_(init[n])
    for n, p in params.named_parameters():
        shd.shard_parameter(p, specs[n], mesh)
    state = api.init_decode_state(B, mesh=mesh)
    tree = api.state_tree(state)
    if cross is not None:
        rules = shd.Rules(mesh=mesh)
        for t, whole in zip((state.cross_k, state.cross_v), cross):
            w = torch.from_numpy(whole)
            t.copy_(shd.local_slice(w, rules.spec(w.shape, (None, "batch", None, None, None)),
                                    mesh))
    toks = init["__tokens__"]
    with shd.use_rules(shd.Rules(mesh=mesh)):
        specs = dict(ckpt.flatten(shd.spec_tree(api.decode_state_specs(), tree)))
    logits = []
    seen = {"max_step": 0, "differ": 0, "codes": 0, "scale_rel": 0.0}
    with shd.use_rules(tstep.rules_for(rc, mesh)):
        for t in range(STEPS):
            lg, state = api.decode_step(params, state, toks[t])
            logits.append(lg.clone())
            if sync:
                before = seen["differ"]
                _follow(api.state_tree(state), specs, sync[t], mesh, bits, seen)
                seen.setdefault("steps", []).append(seen["differ"] > before)
    tree = api.state_tree(state)
    return {"logits": torch.stack(logits), "followed": seen,
            "state": {p: (torch.stack(leaf.parts) if isinstance(leaf, ckpt.Stacked)
                          else leaf).clone() for p, leaf in ckpt.flatten(tree)}}


def _worker(rank: int, world: int, store: str, out: str, job: dict) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        mesh = tmesh.make_mesh(job["shape"], NAMES, "cpu")
        res = {"coords": mesh.coords}
        for case in job["cases"]:
            data = torch.load(f"{out}/{case}.pt", weights_only=False)
            res[case] = _run_case(case, mesh, data["init"], data["cross"],
                                  data["sync"])
        if job["shape"] == (1, 2):
            res["held"] = {bits: _held_case(mesh, bits) for bits in (16, 8)}
        torch.save(res, f"{out}/world{world}_rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case's reference and every rank's run: the reference's
    weights handed to the ranks by file; each world's ranks run in a
    thread of their own from the time its cases' references are written,
    beside the next world's references and ranks."""
    tmp = tmp_path_factory.mktemp("decode_mesh")
    refs, results, errors = {}, {}, []

    def spawn(world, names):
        try:
            mp.start_processes(_worker, args=(world, str(tmp / f"store{world}"),
                                              str(tmp), {"shape": CASES[names[0]][1],
                                                         "cases": names}),
                               nprocs=world, start_method="spawn")
            results[world] = [torch.load(tmp / f"world{world}_rank{r}.pt",
                                         weights_only=False) for r in range(world)]
            for r in range(world):
                (tmp / f"world{world}_rank{r}.pt").unlink()
        except Exception as e:     # raised by the fixture below
            errors.append(e)

    threads = []
    for world, names in WORLDS.items():
        for case in names:
            params, toks, cross, logits, state, sync = _reference(case)
            init = {n: p.detach() for n, p in convert.params_from_jax(
                params, tbase.load_smoke(CASES[case][0]), "cpu").named_parameters()}
            init["__tokens__"] = torch.from_numpy(toks).long()
            torch.save({"init": init, "cross": cross, "sync": sync},
                       tmp / f"{case}.pt")
            refs[case] = (logits, state)
        threads.append(threading.Thread(target=spawn, args=(world, names)))
        threads[-1].start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    return refs, results


def _world(case):
    return int(np.prod(CASES[case][1]))


class _GridMesh:
    """``sharding.assemble``'s view of a mesh: names, sizes, ``size``."""

    def __init__(self, shape):
        self.axis_names, self.shape = NAMES, dict(zip(NAMES, shape))

    def size(self, axes):
        return int(np.prod([self.shape[a] for a in shd._axes(axes)]))


def _specs(case):
    """The reference's resolved spec of every leaf of its state, on the
    case's mesh, by path."""
    arch, shape, bits, seq = CASES[case]
    api = jzoo.get_api(jbase.load_smoke(arch), _rc(jbase, bits, seq))
    jabs = jax.eval_shape(lambda: api.init_decode_state(B))
    with jshd.use_rules(jshd.Rules(mesh=jabstract(shape, NAMES))):
        flat = jax.tree_util.tree_flatten_with_path(
            jshd.spec_tree(api.decode_state_specs(), jabs),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    shapes = {jax.tree_util.keystr(k): a.shape
              for k, a in jax.tree_util.tree_flatten_with_path(jabs)[0]}
    return {jax.tree_util.keystr(k): shd.P(*s) for k, s in flat}, shapes


def _cache_close(got: dict, want, path: str, bits: int) -> None:
    """``path``'s codes and its scales (``path`` a ``.k`` or ``.v``) under
    the kv_quant rule: through dequantization (the reference's
    ``kv_dequant_ref`` on both), within one code step everywhere and
    beyond 1e-5 on fewer than 1% of the entries."""
    def values(codes, scale):
        codes, scale = np.asarray(codes), np.asarray(scale, np.float32)
        y = jref.kv_dequant_ref(jnp.asarray(codes.reshape(-1, codes.shape[-1])),
                                jnp.asarray(scale.reshape(-1, 1)), bits)
        return np.asarray(y), scale.reshape(-1, 1)

    y, _ = values(convert.to_numpy(got[path]), _np(got[path + "_scale"]))
    yj, step = values(_leaf(want, path), _leaf(want, path + "_scale"))
    d = np.abs(y - yj)
    assert (d <= step + 1e-5).all(), (path, d.max())
    assert (d > 1e-5).mean() < 0.01, (path, (d > 1e-5).mean())


def _leaf(tree, path: str):
    for k, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
        if jax.tree_util.keystr(k) == path:
            return a
    raise KeyError(path)


@pytest.mark.parametrize("case", list(CASES))
def test_decode_on_a_mesh_matches_reference(runs, case):
    refs, results = runs
    logits, jstate = refs[case]
    ranks = results[_world(case)]
    arch, shape, bits, seq = CASES[case]
    ties = np.zeros(STEPS, dtype=bool)    # a step where some rank took a code
    for res in ranks:
        seen = res[case]["followed"]
        assert seen["max_step"] <= 1 and seen["scale_rel"] <= 1e-5, seen
        assert seen["differ"] <= 0.01 * max(seen["codes"], 1), seen
        ties |= np.asarray(seen.get("steps", [False] * STEPS))
    for r, res in enumerate(ranks):
        got = _np(res[case]["logits"])
        assert got.shape == logits.shape == (STEPS, B, tbase.load_smoke(arch).vocab)
        err = np.abs(got - logits).max(axis=(1, 2))
        tol = np.where(ties, TIE_REL * np.abs(logits).max(), F32_TOL)
        assert (err < tol).all(), (r, int((err / tol).argmax()), err.max(),
                                   np.flatnonzero(ties))
    specs, shapes = _specs(case)
    mesh = _GridMesh(shape)
    for path, spec in specs.items():
        blocks = [res[case]["state"][path] for res in ranks]
        for block in blocks:     # each rank's block: the whole over its axes
            assert tuple(block.shape) == tuple(
                n // mesh.size(shd._axes(part)) if part else n
                for n, part in zip(shapes[path], tuple(spec) + (None,) * 8)), path
        whole = shd.assemble(blocks, spec, mesh)
        if path.endswith("scale") or (bits != 16 and path.endswith((".k", ".v"))
                                      and "cross" not in path):
            continue
        assert np.abs(_np(whole) - np.asarray(_leaf(jstate, path), np.float32)).max() \
            < F32_TOL, path
    if bits != 16:
        for path in specs:
            if path.endswith((".k", ".v")) and "cross" not in path:
                got = {p: shd.assemble([res[case]["state"][p] for res in ranks],
                                       specs[p], mesh) for p in (path, path + "_scale")}
                _cache_close(got, jstate, path, bits)
    for path in specs:               # the SSM state: the same on every model rank
        if ".ssm." in path:
            by_model = {}
            for res in ranks:
                by_model.setdefault(res["coords"]["data"], []).append(res[case]["state"][path])
            for same in by_model.values():
                assert all(torch.equal(same[0], t) for t in same[1:]), path


@pytest.mark.parametrize("bits", [16, 8])
def test_a_rank_without_the_slot_leaves_its_cache_unchanged(runs, bits):
    _, results = runs
    assert [res["held"][bits] for res in results[2]] == [True, True]
