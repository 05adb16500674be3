"""The port's ``model`` axis (tensor and sequence parallelism) and ZeRO-3
over ``data`` for the dense family (tinyllama's smoke config), on gloo
ranks on the CPU, against the JAX package; and what one rank's blocks are,
in one process.

The ranks, the reference's subprocess and the tolerances are
``tests/_torch_tp_harness.py``'s; the moe and vlm families, ZeRO-3 for the
other families and the re-mesh are in
``tests/test_torch_tensor_parallel_families.py``.
"""
import math

import numpy as np
import pytest
import torch

from _torch_tp_harness import (CASES, NAMES, RC, check_against_reference,  # noqa: F401
                               check_share, oracle, oracle_run, ranks,
                               reference_init)
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.configs import base as tbase
from repro_torch.distributed import sharding as shd
from repro_torch.models import model_zoo
from repro_torch.train import step as tstep

#: the cases this module's ranks and reference run (``ranks``, ``oracle``)
CASES_HERE = ("tiny_122", "tiny_212_b0", "tiny_212_b8", "tiny_212_b16",
              "tiny_114", "tiny_214_b8", "tiny_122_save", "tiny_122_full")


# -- the ranks (the reference's subprocess runs beside them) -------------------------

def test_save_collectives_equals_full(ranks):
    """``remat_policy="save_collectives"`` with ``tp_scatter`` on (1, 2, 2):
    the same losses and parameters as ``"full"``, bit for bit.  With the
    policy the recompute runs no out-projection reduce-scatter again (with
    ``"full"`` it runs the attention's, whose output the backward needs;
    the checkpoint stops before the MLP's), and the same gathers."""
    save, full = ranks["tiny_122_save"], ranks["tiny_122_full"]
    B, S, d, L = 4, 64, 128, 2
    for s, f in zip(save, full):
        assert s["loss"] == f["loss"]
        for a, b in zip(s["moved"], f["moved"]):
            assert b["reduce_scatter"] - a["reduce_scatter"] == L * B * S * d * 4
            assert a["all_gather"] == b["all_gather"]
    for p, v in save[0]["tree"].items():
        assert np.array_equal(v, full[0]["tree"][p]), p


@pytest.mark.parametrize("case", ["tiny_122"])
def test_each_rank_holds_its_share(case, ranks):
    """ZeRO-3 and tensor parallelism: every leaf a rule shards is held as
    its block, the moments alike; the norms are whole on every rank."""
    check_share(case, ranks)


def test_model_ranks_take_the_same_rows(ranks):
    """``device_batch``: the ``model`` ranks of one ``(pod, data)``
    coordinate take the same rows, as ``P(("pod", "data"))`` places them;
    the data ranks take theirs in order."""
    got = ranks[("tinyllama-1.1b", (1, 2, 2))]
    rows = {}
    for r in got:
        c = r["coords"]
        rows.setdefault(c["data"], []).append(r["tiny_122"]["rows"])
    for d, per_model in rows.items():
        for other in per_model[1:]:
            assert all(torch.equal(a, b) for a, b in zip(per_model[0], other))
        assert per_model[0][0].shape[0] == RC["global_batch"] // 2
    assert not torch.equal(rows[0][0][0], rows[1][0][0])


def test_only_rank_0_gathers_the_whole_state(ranks):
    """``train.step.whole_tree`` gathers each leaf to rank 0 alone, as the
    checkpoint's writer: every other rank gets ``None``."""
    for case in CASES_HERE:
        assert [r["whole"] for r in ranks[case]] == [
            i == 0 for i in range(len(ranks[case]))], case


def test_collective_bytes_follow_the_shapes(ranks):
    """The bytes each collective moves a step on (1, 2, 2), from the
    shapes (tinyllama's smoke config, f32, no remat; B = 4 rows a rank,
    S = 64, L = 2 layers, d = 128, ff = 256, V = 256, tp = 2, data = 2).
    A gather counts the block it sends, a reduction the f32 tensor it
    reduces.  Per layer the forward gathers the normed stream twice (a
    block of B S/tp d each), ZeRO-3 gathers the layer's weights over
    ``data`` (this rank's block of its tp block) and the attention and MLP
    outputs are reduce-scattered (B S d); the backward runs each one's
    adjoint.  Outside the layers: the embedding's vocab-parallel all-reduce
    (B S d, and its adjoint), the stream gathered after the last layer,
    the table and unembedding gathered over ``data``, the loss's max, sum
    of exponentials and gold logit (B S each, the sum and gold with their
    adjoints, all three again in the chunk's recompute) and the norm's one
    scalar.  Every step moves the same bytes on every rank."""
    B, S, d, ff, V, tp, data, L = 4, 64, 128, 256, 256, 2, 2, 2
    hd, H, KV = 32, 4, 2
    block = B * (S // tp) * d * 4                    # a gathered block, f32
    stream = B * S * d * 4                           # the whole stream, f32
    layer_tp = (d * H * hd + 2 * d * KV * hd + H * hd * d + 3 * d * ff) // tp * 4
    embed_tp = 2 * V * d // tp * 4
    gathers = L * (4 * block + layer_tp // data) + embed_tp // data + block
    scatters = L * (4 * stream + layer_tp) + embed_tp + stream
    reduces = 2 * stream + 8 * B * S * 4 + 4
    for r in ranks["tiny_122"]:
        for moved in r["moved"]:
            assert moved == {"all_gather": gathers, "reduce_scatter": scatters,
                             "all_reduce": reduces}, moved


# -- a rank's blocks, in one process ------------------------------------------------------

class _OneRank:
    """A mesh's axes and one rank's coordinates on it, without a process
    group: what ``local_slice`` and ``param_partition`` read."""

    def __init__(self, shape, coords):
        self.axis_names, self.shape = NAMES, dict(zip(NAMES, shape))
        self.coords = dict(zip(NAMES, coords))

    def size(self, axes):
        axes = (axes,) if isinstance(axes, str) else axes
        return math.prod(self.shape[a] for a in axes)

    def index(self, axes):
        axes = (axes,) if isinstance(axes, str) else axes
        return int(np.ravel_multi_index([self.coords[a] for a in axes],
                                        [self.shape[a] for a in axes]))


@pytest.mark.parametrize("heads,tp", [((4, 2, 32), 2), ((4, 2, 32), 4),
                                      ((4, 2, 32), 8), ((32, 4, 64), 2),
                                      ((48, 8, 128), 12), ((48, 8, 128), 32),
                                      ((25, 5, 64), 2), ((6, 6, 64), 4),
                                      ((6, 6, 32), 4)])
def test_each_rank_reads_the_kv_heads_of_its_query_heads(heads, tp):
    """``layers._heads`` on every rank: query head h reads KV head h // G,
    whether the rank's KV block lines up (local heads), cuts a head (k and
    v gathered: the smoke config at tp = 4), its query heads span groups
    unevenly (one KV head a query head) or its query block cuts a head
    (q gathered, the heads that cover the block computed and o cut back to
    wo's rows: hymba-1.5b's 12.5 heads a rank at tp = 2, 13 computed;
    whisper-tiny's 1.5 at tp = 4, 2 computed)."""
    import dataclasses

    from repro_torch.models import layers as L
    H, KV, hd = heads
    cfg = dataclasses.replace(tbase.load_smoke("tinyllama-1.1b"), n_heads=H,
                              n_kv_heads=KV, head_dim=hd, d_model=H * hd)
    G = H // KV
    for rank in range(tp):
        mesh = _OneRank((1, 1, tp), (0, 0, rank))
        with shd.use_rules(shd.Rules(mesh=mesh)):
            plan = L._heads(cfg)
            kb = shd.tp_block("heads", KV * hd)
            qb = shd.tp_block("heads", H * hd)
        assert plan.rows == qb == (rank * H * hd // tp, H * hd // tp)
        assert plan.q_gather == bool(qb[0] % hd or qb[1] % hd)
        assert plan.q == (qb[0] // hd, -(-(qb[0] + qb[1]) // hd))
        assert plan.q[1] - plan.q[0] <= -(-H // tp) + 1
        heads_q = list(range(*plan.q))
        kv = list(range(KV)) if kb is None or plan.kv_gather else \
            list(range(kb[0] // hd, (kb[0] + kb[1]) // hd))
        if plan.kv_index is not None:
            read = [kv[i] for i in plan.kv_index]
        else:
            picked = kv[plan.kv_local[0]:plan.kv_local[1]]
            per = len(heads_q) // len(picked)
            read = [picked[i // per] for i in range(len(heads_q))]
        assert read == [h // G for h in heads_q], (rank, plan)
    assert (4, 2, 32, 4) != (H, KV, hd, tp) or plan.kv_gather


def _chunked(t, spec, mesh):
    """``t``'s block at the rank's index along each dimension ``spec``
    shards, cut with ``torch.chunk``."""
    for dim, part in enumerate(spec):
        if part:
            axes = shd._axes(part)
            t = torch.chunk(t, mesh.size(axes), dim)[mesh.index(axes)]
    return t


def _mixtral_reference_state():
    """The reference's initial mixtral state at bits 8 on (2, 2, 2) as numpy
    leaves, and the port's config and run config."""
    import jax

    from repro.configs import base as jbase
    from repro.launch.mesh import abstract_mesh
    from repro.models import model_zoo as jzoo
    from repro.train import step as jstep

    arch = "mixtral-8x7b"
    rj = jbase.RunConfig(**RC, param_dtype="float32", grad_compress_bits=8)
    js = jstep.init_state(jzoo.get_api(jbase.load_smoke(arch), rj), rj,
                          jax.random.PRNGKey(0), abstract_mesh((2, 2, 2), NAMES))
    return jax.tree.map(np.asarray, js), tbase.load_smoke(arch), tbase.RunConfig(
        **RC, param_dtype="float32", grad_compress_bits=8)


@pytest.mark.parametrize("coords", [(0, 0, 0), (1, 1, 1), (1, 0, 1)])
def test_state_from_jax_onto_a_ranks_blocks(coords):
    """``convert.state_from_jax(..., mesh=, rc=)`` on a (2, 2, 2) mesh at
    bits 8: every parameter, moment and residual is this rank's block of
    the whole conversion (its pod's residuals), contiguous along each
    sharded dimension at the rank's index; a parameter sharded over
    ``data`` remembers the dimension the forward gathers."""
    tree, cfg, rc = _mixtral_reference_state()
    whole = convert.state_from_jax(tree, cfg, "cpu")
    mesh = _OneRank((2, 2, 2), coords)
    got = convert.state_from_jax(tree, cfg, "cpu", mesh=mesh, rc=rc)
    specs = tstep.param_partition(model_zoo.get_api(cfg, rc, "cpu"), rc, mesh)
    assert any("data" in shd._axes(p) for s in specs.values() for p in s)
    assert any("model" in shd._axes(p) for s in specs.values() for p in s)
    params = dict(whole.params.named_parameters())
    for n, p in got.params.named_parameters():
        assert torch.equal(p, _chunked(params[n], specs[n], mesh)), n
        assert torch.equal(got.opt.mu[n], shd.local_slice(whole.opt.mu[n], specs[n], mesh))
        assert torch.equal(got.resid[n], shd.local_slice(
            whole.resid[n][coords[0]:coords[0] + 1], shd.P(None, *specs[n]), mesh))
        assert getattr(p, "fsdp", None) == shd.fsdp_dim(specs[n])


@pytest.mark.parametrize("coords", [(0, 0, 0), (1, 1, 1), (1, 0, 1)])
def test_restore_copies_in_a_ranks_blocks(coords, tmp_path):
    """``CheckpointManager.restore`` with ``train.step.checkpoint_blocks``:
    a checkpoint of whole leaves (mixtral at bits 8, moments and residuals
    seeded noise) restored into one rank's state on a (2, 2, 2) mesh gives
    that rank's block of every parameter and moment and its pod's block of
    every residual; nothing whole is built for it."""
    tree, cfg, rc = _mixtral_reference_state()
    whole = convert.state_from_jax(tree, cfg, "cpu")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for t in [*whole.opt.mu.values(), *whole.opt.nu.values(),
                  *whole.resid.values()]:
            t.copy_(torch.randn(t.shape, generator=gen))
    mgr = ckpt.CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, tstep.checkpoint_tree(whole))
    mesh = _OneRank((2, 2, 2), coords)
    api = model_zoo.get_api(cfg, rc, "cpu")
    got = tstep.init_state(api, rc, 0, mesh)
    mgr.restore(1, tstep.checkpoint_tree(got), tstep.checkpoint_blocks(api, rc, mesh))
    mgr.close()
    specs = tstep.param_partition(api, rc, mesh)
    params = dict(whole.params.named_parameters())
    for n, p in got.params.named_parameters():
        assert torch.equal(p, _chunked(params[n], specs[n], mesh)), n
        assert torch.equal(got.opt.mu[n], _chunked(whole.opt.mu[n], specs[n], mesh)), n
        assert torch.equal(got.opt.nu[n], _chunked(whole.opt.nu[n], specs[n], mesh)), n
        assert torch.equal(got.resid[n], _chunked(
            whole.resid[n], shd.P("pod", *specs[n]), mesh)), n


@pytest.mark.parametrize("batch", [8, 6])
def test_moe_batch_must_split_over_the_batch_ranks(batch):
    """The MoE's capacity counts every batch rank's tokens, so each rank
    must hold its own rows: a global batch the (pod, data) ranks do not
    divide is refused when the step is built."""
    from repro_torch.launch.mesh import abstract_mesh
    cfg = tbase.load_smoke("mixtral-8x7b")
    rc = tbase.RunConfig(**{**RC, "global_batch": batch})
    api = model_zoo.get_api(cfg, rc, "cpu")
    mesh = abstract_mesh((2, 2, 1), NAMES)
    if batch % 4 == 0:
        tstep.make_train_step(api, cfg, rc, mesh)
        return
    with pytest.raises(ValueError, match="does not split over 4 batch ranks"):
        tstep.make_train_step(api, cfg, rc, mesh)


# -- against the reference ----------------------------------------------------------

@pytest.mark.parametrize("case", [c for c in CASES_HERE if c in CASES])
def test_mesh_step_matches_reference(case, ranks, oracle):
    """Losses of every rank, the whole parameters (gathered from the ranks'
    blocks) and the residuals after 2 steps against the reference's jitted
    step on the same ``Auto`` mesh."""
    check_against_reference(case, ranks, oracle)
