"""An architecture's files, found by name: the llama block's layout, counts
and reference layer pinned to what the harness computed before they were
files of their own, and an architecture that only this test writes, run to
``correct`` through ``spec.resolve`` and ``run.run_cell``."""
import hashlib
import json
import shutil

import numpy as np
import pytest
import torch

from _tiny import LIMITS, ROOT, config, mix, one_thread
from bench import counts, inputs, reference, run, spec

LLAMA, _ = spec.architecture("llama")
SEED = 2**31 + 5

#: (rows, sha256 of the rows' repr) of ``layout`` before it moved
LAYOUT = {"granite-8b": (327, "15af706fe309b8311721daa041f87ede"
                              "8d7e74052ba7e3e6c394f75d271c4421"),
          "mixtral-8x7b-16L": (163, "5002bcc546e5bd922394ed59ef6d000c"
                                    "ade3361b328874aa28446d096dc5af32")}
S, S_DOWN = 0.015625, 0.008351913809763262      # 4096 ** -0.5, 14336 ** -0.5


def _rows(V, L, ffn):
    rows = [("embed.table", (V, 4096), 0.02), ("embed.unembed", (4096, V), S),
            ("embed.final_norm", (4096,), "ones")]
    for i in range(L):
        p = f"layers.{i}."
        rows += [(p + "ln1", (4096,), "ones"), (p + "attn.wq", (4096, 4096), S),
                 (p + "attn.wk", (4096, 1024), S), (p + "attn.wv", (4096, 1024), S),
                 (p + "attn.wo", (4096, 4096), S), (p + "ln2", (4096,), "ones")]
        rows += [(p + n, shape, std) for n, shape, std in ffn]
    return rows


PARENT_ROWS = {
    "granite-8b": _rows(49152, 36, [("mlp.w_gate", (4096, 14336), S),
                                    ("mlp.w_up", (4096, 14336), S),
                                    ("mlp.w_down", (14336, 4096), S_DOWN)]),
    "mixtral-8x7b-16L": _rows(32000, 16, [("moe.router", (4096, 8), S),
                                          ("moe.w_gate", (8, 4096, 14336), S),
                                          ("moe.w_up", (8, 4096, 14336), S),
                                          ("moe.w_down", (8, 14336, 4096), S_DOWN)])}


@pytest.mark.parametrize("name", sorted(LAYOUT))
def test_layout_is_the_one_before_the_move(name):
    cfg = spec.load_json(ROOT / "bench" / "configs" / f"{name}.json")
    assert cfg["arch"] == "llama"
    rows = LLAMA.layout(cfg)
    assert rows == PARENT_ROWS[name]
    n, digest = LAYOUT[name]
    assert len(rows) == n
    assert hashlib.sha256(repr(rows).encode()).hexdigest() == digest


#: the three cells' counts before the move, at the traffic's start
#: positions (seed ``SEED``) plus ``t``: (t, FLOPs, bytes, the attention's
#: bytes over every layer, one layer's, least seconds)
COUNTS = {
    "granite-8b.decode32k.int8": (16106725376, 16106127360, [
        (0, 537954091008, 52250560768, 36140914944, 1003914304, 0.01559718231880597),
        (371, 541455286272, 52701886720, 36592240896, 1016451136, 0.015731906483582088),
        (741, 544947044352, 53151996160, 37042350336, 1028954176, 0.01586626751044776),
        (1086, 548202872832, 53571692800, 37462046976, 1040612416,
         0.015991550089552237)]),
    "mixtral-8x7b-16L.chat.int8": (46702796800, 12879659008, [
        (0, 1648629907456, 46771027968, 54665216, 3416576, 0.01396150088597015),
        (371, 1661078601728, 48375742464, 1659379712, 103711232, 0.014440520138507463),
        (741, 1673493741568, 49976131584, 3259768832, 203735552, 0.014918248234029851),
        (1086, 1685070020608, 51468386304, 4752023552, 297001472,
         0.015363697404179104)]),
    "granite-8b.chat.int8": (16106725376, 16106127360, [
        (0, 2061659799552, 16253085696, 122996736, 3416576, 0.0048516673719402985),
        (371, 2089669361664, 19863693312, 3733604352, 103711232, 0.005929460690149254),
        (741, 2117603426304, 23464568832, 7334479872, 203735552, 0.007004348905074627),
        (1086, 2143650054144, 26822141952, 10692052992, 297001472,
         0.008006609537910448)]),
}


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_counts_are_the_ones_before_the_move(name):
    cell = spec.resolve(name, ROOT)
    cfg, arch = cell.config, cell.arch
    tr = cell.generator.make(cell.traffic, cfg["vocab"], SEED)
    wbytes, fpt, steps = COUNTS[name]
    assert arch.weight_bytes(cfg) == wbytes
    assert arch.matmul_flops_per_token(cfg) == fpt
    for t, flops, nbytes, attn, one_layer, least in steps:
        pos = tr.start_positions() + t
        c = counts.step_counts(cfg, arch, pos, tr.seq_len, tr.kv_bits)
        assert (c["flops"], c["bytes"], c["attn_bytes"], c["least_s"]) == \
            (flops, nbytes, attn, least)
        per_layer = [counts.decode_attention_bytes(cfg, v, tr.kv_bits)
                     for v in counts.layers_slots(cfg, arch, pos, tr.seq_len)]
        assert per_layer == [one_layer] * cfg["n_layers"]


def _logits_before_the_move(cfg, w, turns, kv_bits, history, margins=None):
    """``reference.logits`` as it was with the layer body inline."""
    R = reference
    H, KV, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    eps, theta = cfg["norm_eps"], cfg["rope_theta"]
    xs, poss = [], []
    for t in turns:
        poss.append(t.start + torch.arange(t.tokens.shape[0], device=t.tokens.device))
        xs.append(w["embed.table"][t.tokens].to(R.F32))
    with R.fp32_matmuls():
        for i in range(cfg["n_layers"]):
            lw = R.layer_weights(w, i)
            hist = history(i) if any(t.start for t in turns) else None
            for n, t in enumerate(turns):
                x, pos = xs[n], poss[n]
                T = x.shape[0]
                h = R.rmsnorm(x, lw["ln1"], eps)
                q = R.rope((h @ lw["attn.wq"]).reshape(T, H, hd), pos, theta)
                k = R.packed(R.rope((h @ lw["attn.wk"]).reshape(T, KV, hd), pos, theta),
                             kv_bits)
                v = R.packed((h @ lw["attn.wv"]).reshape(T, KV, hd), kv_bits)
                if t.start:
                    k = torch.cat([R.packed(hist[0][t.row, :t.start], kv_bits), k])
                    v = torch.cat([R.packed(hist[1][t.row, :t.start], kv_bits), v])
                x = x + R.attention(q, k, v, pos) @ lw["attn.wo"]
                h = R.rmsnorm(x, lw["ln2"], eps)
                if cfg["family"] == "moe":
                    x = x + R.moe(h, lw, cfg, None if margins is None else margins[n])
                else:
                    x = x + R.swiglu(h, lw["mlp.w_gate"], lw["mlp.w_up"], lw["mlp.w_down"])
                xs[n] = x
        out = w.get("embed.unembed")
        out = (w["embed.table"].T if out is None else out).to(R.F32)
        return [R.rmsnorm(x, w["embed.final_norm"], eps) @ out for x in xs]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("history", [True, False], ids=["history", "fresh"])
@pytest.mark.parametrize("family", ["dense", "moe"])
def test_reference_logits_are_the_ones_before_the_move(family, history, bits):
    cfg = config(family)
    w = inputs.weights(cfg, LLAMA, 7, "cpu")
    hist = None
    starts = [0, 0, 0]
    if history:
        h = mix()["history"]
        hist = lambda i: inputs.history_kv(cfg, h, 7, i, 3, 48, "cpu")   # noqa: E731
        starts = [21, 0, 29]
    g = torch.Generator().manual_seed(3)
    turns = [reference.Turn(torch.randint(0, cfg["vocab"], (n,), generator=g), s, r)
             for r, (n, s) in enumerate(zip((5, 9, 3), starts))]
    margins, margins_before = ([[] for _ in turns], [[] for _ in turns]) \
        if family == "moe" else (None, None)
    with one_thread():
        got = reference.logits(cfg, LLAMA, w, turns, bits, hist, margins)
        want = _logits_before_the_move(cfg, w, turns, bits, hist, margins_before)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    if margins is not None:
        assert all(torch.equal(a, b) for m, mb in zip(margins, margins_before)
                   for a, b in zip(m, mb))


def _root_with_an_added_arch(tmp, family):
    """A checkout whose one cell names an architecture and a bridge that
    exist only here: copies of the llama block's files under another name."""
    bench = tmp / "bench"
    for sub in ("arch", "bridges", "configs", "traffic", "limits"):
        (bench / sub).mkdir(parents=True)
    shutil.copy(ROOT / "bench" / "arch" / "llama.py", bench / "arch" / "added.py")
    shutil.copy(ROOT / "bench" / "bridges" / "llama.py", bench / "bridges" / "added.py")
    shutil.copy(ROOT / "bench" / "traffic" / "sessions.py", bench / "traffic")
    cfg = dict(config(family), name="added", arch="added")
    (bench / "configs" / "added.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "tiny.json").write_text(json.dumps(mix()))
    (bench / "limits" / "added.tiny.json").write_text(json.dumps(LIMITS))
    real = spec.benchmark(ROOT)
    (tmp / "BENCHMARK.json").write_text(json.dumps(dict(
        real, configs=[{"name": "added", "source": "https://arxiv.org/abs/2302.13971",
                        "file": "bench/configs/added.json", "reduced": [],
                        "why": "an architecture added as files only"}],
        workloads=[{"name": "added.tiny", "config": "added", "traffic": "tiny",
                    "chips": 1, "why": "tiny"}],
        end_to_end=[dict(m, workloads=["added.tiny"]) for m in real["end_to_end"]],
        per_layer=[])))


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_an_arch_added_as_files_runs_to_correct(tmp_path, family):
    _root_with_an_added_arch(tmp_path, family)
    cell = spec.resolve("added.tiny", tmp_path)
    assert cell.arch.__file__ == str(tmp_path / "bench" / "arch" / "added.py")
    assert cell.bridge.__file__ == str(tmp_path / "bench" / "bridges" / "added.py")
    with one_thread():
        out, shown, _ = run.run_cell(cell, SEED, 0.5, False, "cpu")
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 4
    assert set(out["metrics"]) == {"tokens_per_s", "step_ms_p95", "ttft_ms_p95",
                                   "setup_s"}
    assert all(v["value"] <= v["limit"] for v in shown.values())
    assert np.isfinite([m["value"] for m in out["metrics"].values()]).all()
