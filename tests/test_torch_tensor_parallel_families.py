"""The port's ``model`` axis and ZeRO-3 for the moe and vlm families
(mixtral-8x7b's and internvl2-76b's smoke configs, the MoE's capacity and
load-balance loss over the whole batch), on gloo ranks on the CPU, against
the JAX package; ZeRO-3 over ``data`` for the ssm, hybrid and encdec
families, the sharded bf16 step against one device and the elastic
re-mesh across ``model`` sizes (tinyllama and hymba), against the port's
own single-device runs.  The ssm, hybrid and encdec families' ``model``
axis is ``tests/test_torch_tensor_parallel_mixers.py``.

The ranks, the reference's subprocess and the tolerances are
``tests/_torch_tp_harness.py``'s; the dense family's meshes are in
``tests/test_torch_tensor_parallel.py``.  The tests that need no reference
come between the ranks and the reference's results, so they run while the
reference's subprocess does.
"""
import os

import numpy as np
import pytest

from _torch_tp_harness import (CASES, RC, ZERO_ARCHES, _run_steps,  # noqa: F401
                               _spawn, _zero_steps, check_against_reference,
                               check_share, oracle, oracle_run, ranks,
                               reference_init)
from repro_torch.configs import base as tbase
from repro_torch.models import model_zoo
from repro_torch.train import step as tstep
from repro_torch.train.loop import LoopConfig, train

#: the cases this module's ranks and reference run (``ranks``, ``oracle``)
CASES_HERE = ("moe_122", "moe_211", "moe_221_b8", "vlm_112")


@pytest.mark.parametrize("case", ["moe_122", "moe_221_b8"])
def test_each_rank_holds_its_share(case, ranks):
    """ZeRO-3 and tensor parallelism: every leaf a rule shards is held as
    its block, the moments and residuals alike; the norms are whole on
    every rank."""
    check_share(case, ranks)


# -- the port against itself -----------------------------------------------------------

@pytest.fixture(scope="module")
def zero_ranks(tmp_path_factory):
    return _spawn(2, {"kind": "zero"}, tmp_path_factory.mktemp("zero"))


@pytest.mark.parametrize("arch", ZERO_ARCHES)
def test_zero3_over_data_for_every_family(arch, zero_ranks):
    """ZeRO-3 over ``data`` serves the families that stay whole over
    ``model`` (ssm, hybrid, encdec): 2 f32 steps on (1, 2, 1), each rank
    holding half of every leaf the ``fsdp`` rule shards, give the
    single-device step's losses (1e-5 relative) and parameters (1e-4 of
    each leaf's largest magnitude)."""
    losses, tree, _ = _zero_steps(arch, None)
    for r in zero_ranks:
        got, _, blocks = r[arch]
        assert np.all(np.abs(np.array(got) - losses) <= 1e-5 * np.abs(losses)), (got, losses)
    whole = zero_ranks[0][arch][1]
    for p, want in tree.items():
        assert whole[p].shape == want.shape, p
        assert np.abs(whole[p] - want).max() <= 1e-4 * np.abs(want).max(), p
    shapes = tstep.full_shapes(model_zoo.get_api(
        tbase.load_smoke(arch), tbase.RunConfig(**RC), "cpu"))
    assert any(s != shapes[n] for n, s in zero_ranks[0][arch][2].items())


def test_sharded_step_equals_single_device(tmp_path):
    """yi-9b's smoke config, bf16: 5 steps on a (2, 2) data x model mesh
    equal the single-device step within the reference's 5e-3 (its
    ``dist_equivalence``)."""
    dist_losses = _spawn(4, {"kind": "equivalence"}, tmp_path)
    single = _run_steps(tbase.load_smoke("yi-9b"), tbase.RunConfig(**RC), None, 5)
    for losses in dist_losses:
        assert np.allclose(losses, single, atol=5e-3), (losses, single)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "hymba-1.5b"])
def test_elastic_remesh_across_model_sizes(arch, tmp_path):
    """10 steps on (2, 2) data x model with checkpoints, resumed to 20 on
    (1, 4): the last 3 losses within 5e-3 of an uninterrupted run (the
    reference's ``remesh``, (4, 2) to (2, 4) there).  hymba's whole leaves
    (the checkpoint's) are restored onto blocks cut twice as fine over
    ``model``: its SSD's ``in_proj`` from 276 to 138 columns, its KV heads
    from one a rank to half of one."""
    d = str(tmp_path / "ckpt")
    job = {"kind": "remesh", "arch": arch, "dir": d}
    first = _spawn(4, {**job, "shape": (2, 2), "steps": 10}, tmp_path)
    second = _spawn(4, {**job, "shape": (1, 4), "steps": 20}, tmp_path)
    assert len(first[0]["loss"]) == 10 and len(second[0]["loss"]) == 10
    ref = train(tbase.load_smoke(arch), tbase.RunConfig(**RC),
                LoopConfig(total_steps=20, ckpt_every=5, ckpt_dir=str(tmp_path / "ref")),
                device="cpu", log_every=0)
    for h in second:
        assert np.allclose(h["loss"][-3:], ref["loss"][-3:], atol=5e-3), (
            h["loss"][-3:], ref["loss"][-3:])
    assert sorted(os.listdir(d))[-1] == "step_00000020"


# -- against the reference ----------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES_HERE))
def test_mesh_step_matches_reference(case, ranks, oracle):
    """Losses of every rank, the whole parameters (gathered from the ranks'
    blocks) and the residuals after 2 steps against the reference's jitted
    step on the same ``Auto`` mesh."""
    check_against_reference(case, ranks, oracle)
