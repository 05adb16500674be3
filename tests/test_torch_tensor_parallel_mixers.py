"""The port's ``model`` axis for the ssm, hybrid and encdec families
(mamba2-130m's, hymba-1.5b's and whisper-tiny's smoke configs), on gloo
ranks on the CPU, against the JAX package.

The layouts these families bring: mamba2's packed ``in_proj`` cut mid-x
(552 columns at 276) and, at ``d_model`` 96 on four ranks, left whole (422
columns) while ``gate_norm`` and ``out_proj`` are cut mid-head (48 rows,
1.5 heads of 32: hymba-1.5b's layout at tp = 4); hymba's two branches with
its KV heads cut mid-head at tp = 4, the compressed exchange on its
model-cut blocks and the ``save_collectives`` policy over an SSD branch;
whisper's encoder, decoder and cross-attention with the stream whole over
``model``, on aligned heads and, at ``d_model`` 192 with 6 heads on four
ranks, cut mid-head at G = 1 with 80 frames against 64 tokens.

The ranks, the reference's subprocess and the tolerances are
``tests/_torch_tp_harness.py``'s (f32: losses within 1e-5 relative, each
parameter leaf within 1e-4 of its largest magnitude, the residuals within
1e-5 but for one code step on fewer than 1% of the entries).  The bytes
each collective is handed are held to ``chip_smoke.tp_bytes``, the formula
the card's ``tp`` and ``tp_families`` phases check.
"""
import math
import sys

import numpy as np
import pytest

from _torch_tp_harness import (ALL, CASES, NAMES, ROOT, _rc,  # noqa: F401
                               case_config, check_against_reference,
                               check_reference_blocks, check_share, oracle,
                               oracle_run, ranks, reference_init)

sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

#: the cases this module's ranks and reference run (``ranks``, ``oracle``)
CASES_HERE = ("ssm_112", "ssm_122", "ssm_114_h6", "hybrid_112", "hybrid_114",
              "hybrid_212_b8", "hybrid_122_save", "hybrid_122_full",
              "encdec_122", "encdec_114_h6")
REFERENCE_CASES = [c for c in CASES_HERE if c in CASES]


# -- the ranks (the reference's subprocess runs beside them) -------------------------

@pytest.mark.parametrize("case", CASES_HERE)
def test_collective_bytes_follow_the_formula(case, ranks):
    """The bytes each collective is handed a step, on every rank and step,
    are ``chip_smoke.tp_bytes``' formula from the shapes (the SSD's
    ``in_proj`` product and conv gathered where tp divides them, the gated
    norm's sums of squares all-reduced, whisper's out-projections
    all-reduced onto its whole stream; see its docstring)."""
    want = chip_smoke.tp_bytes(case_config(case), _rc(case), ALL[case][1], NAMES)
    for r in ranks[case]:
        assert all(m == want for m in r["moved"]), (r["moved"], want)
    assert want["all_gather"] and want["all_reduce"]


@pytest.mark.parametrize("case", [c for c in CASES_HERE if c[:3] in ("ssm", "hyb")])
def test_the_scan_runs_a_ranks_heads(case, ranks):
    """The SSD divides its work by heads: on each rank the chunked scan runs
    the heads that cover the rank's block of ``gate_norm`` / ``out_proj``'s
    di rows, H / tp where the block lines up with heads, one more where it
    cuts one (``ssm_114_h6``: 1.5 heads a rank, 2 run), never all H."""
    cfg = case_config(case)
    di, P, H = cfg.d_inner, cfg.ssm_head, cfg.ssm_heads
    tp = ALL[case][1][2]
    rows = di // tp
    for r in ranks[case]:
        m = r["coords"]["model"]
        lo, hi = m * rows // P, -(-(m + 1) * rows // P)
        assert r["scan_heads"] == [hi - lo], (r["scan_heads"], hi - lo)
        assert hi - lo == (H // tp if rows % P == 0 else H // tp + 1) < H


@pytest.mark.parametrize("case", REFERENCE_CASES)
def test_each_rank_holds_its_share(case, ranks):
    """ZeRO-3 and tensor parallelism: every leaf a rule shards is held as
    its block, the moments and residuals alike; the norms over d are whole
    on every rank; the rules cut ``in_proj``, the conv and ``gate_norm``."""
    check_share(case, ranks)
    cut = {n for n, spec in ranks[case][0]["specs"].items()
           if any("model" in (p if isinstance(p, tuple) else (p,)) for p in spec)}
    family = case.split("_")[0]
    if family in ("ssm", "hybrid"):
        assert {"layers.0.ssm.conv_w", "layers.0.ssm.gate_norm",
                "layers.0.ssm.out_proj"} <= cut
        assert ("layers.0.ssm.in_proj" in cut) == (case != "ssm_114_h6")
        assert "layers.0.ssm.a_log" not in cut
    else:
        assert {"enc_layers.0.attn.wq", "dec_layers.0.cross_attn.wk",
                "dec_layers.0.mlp.w_up"} <= cut


def test_save_collectives_equals_full(ranks):
    """hymba under ``remat_policy="save_collectives"`` on (1, 2, 2): the
    same losses and parameters as ``"full"``, bit for bit; the recompute
    runs the attention's and the SSD's out-projection reduce-scatters
    again under ``"full"`` only (the checkpoint stops before the MLP's),
    and the same gathers."""
    save, full = ranks["hybrid_122_save"], ranks["hybrid_122_full"]
    cfg = case_config("hybrid_122_save")
    B, S, d, L = 4, 64, cfg.d_model, cfg.n_layers
    for s, f in zip(save, full):
        assert s["loss"] == f["loss"]
        for a, b in zip(s["moved"], f["moved"]):
            assert b["reduce_scatter"] - a["reduce_scatter"] == L * 2 * B * S * d * 4
            assert a["all_gather"] == b["all_gather"]
    for p, v in save[0]["tree"].items():
        assert np.array_equal(v, full[0]["tree"][p]), p


def test_model_ranks_hold_the_same_loss(ranks):
    """Every rank of a case reports the same losses: the loss is summed
    over its vocabulary blocks and averaged over the batch ranks."""
    for case in CASES_HERE:
        losses = [r["loss"] for r in ranks[case]]
        assert all(lo == losses[0] for lo in losses), (case, losses)
        assert all(np.isfinite(losses[0])), case


# -- against the reference ----------------------------------------------------------

@pytest.mark.parametrize("case", REFERENCE_CASES)
def test_mesh_step_matches_reference(case, ranks, oracle):
    """Losses of every rank, the whole parameters (gathered from the ranks'
    blocks) and the residuals after 2 steps against the reference's jitted
    step on the same ``Auto`` mesh."""
    check_against_reference(case, ranks, oracle)


@pytest.mark.parametrize("case", REFERENCE_CASES)
def test_blocks_are_the_references(case, ranks, oracle):
    """Each rank's spec of every parameter is the reference's resolved spec
    on the same mesh, and its local shape the reference's block."""
    check_reference_blocks(case, ranks, oracle)
    assert math.prod(ALL[case][1]) == len(ranks[case])
