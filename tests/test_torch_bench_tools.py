"""The port's measurement entry points (blp_tpu_torch/bench.py and
blp_tpu_torch/tools/{rank_bench,serving_bench,measure_reference_baseline,
family_bench,scaling_bench}.py) against the TPU package's (bench.py,
tools/*.py), on the CPU at small sizes, with one torch thread:

- rank_bench: the same seed-0 inputs as tools/pallas_rank_bench.py (loaded
  with sys.argv patched; it runs at import, its Pallas kernel in interpret
  mode): K1's counts (its plain version here) equal the Pallas kernel's and
  its checksum equals both JAX checksums; the plain stream is within 1 of
  XLA's stream at every entry (their fp32 sums add in other orders, so a
  near-tie may flip: its checksum is 3 below theirs) and the tool reports
  0 mismatches, none beyond the rounding band;
- serving_bench: the JSON keys of the TPU tool, and the same top-10 ids as
  blp_tpu.serve.LinkPredictor on the same table, queries and weights;
- measure_reference_baseline: ReferenceBert takes transformers.BertModel's
  state dict with strict=True and matches it within 1e-5 (fp32, eval mode);
  a one-step run writes the TPU tool's keys;
- bench and family_bench: the TPU bench's points and the family table as
  literals, and a window of each at tiny widths;
- eval_parallel.rank_counts over 2 gloo ranks: bit-equal to the one-device
  counts (K1's order for TransE, the plain stream for DistMult) and within 1
  of JAX's make_sharded_rank_counts on a 2-device mesh; scaling_bench in the
  same world emits the TPU tool's rows.
"""

import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from blp_tpu.models import bert as j_bert
from blp_tpu.models import blp as j_blp
from blp_tpu.ops import ranking as j_ranking
from blp_tpu.parallel import eval_parallel as j_eval_parallel
from blp_tpu.parallel import mesh as j_mesh
from blp_tpu.serve import LinkPredictor as JLinkPredictor
from blp_tpu_torch import bench
from blp_tpu_torch.models import bert, blp
from blp_tpu_torch.ops import ranking, transe_rank
from blp_tpu_torch.tools import (family_bench, measure_reference_baseline,
                                 rank_bench, scaling_bench, serving_bench)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module (the test workers share the
    machine's cores), which also fixes the CPU matmul's order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tool(name: str, monkeypatch, argv=None):
    """The TPU package's tools/<name>.py as a fresh module; with `argv`, run
    with sys.argv patched (a tool that parses its arguments at import)."""
    path = os.path.join(ROOT, "tools", f"{name}.py")
    if argv is not None:
        monkeypatch.setattr(sys, "argv", [path, *argv])
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json_lines(text: str) -> list[dict]:
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


# -- rank_bench ---------------------------------------------------------------

def test_rank_bench_counts_match_the_jax_tool(monkeypatch, capsys):
    flags = ["--n", "20000", "--b", "8", "--xla-tile", "4096", "--reps", "1"]
    jt = _jax_tool("pallas_rank_bench", monkeypatch, flags + ["--tiles", "512"])
    lines = capsys.readouterr().out.splitlines()
    jax_sums = [int(ln.rsplit("checksum ", 1)[1].rstrip(")")) for ln in lines
                if "checksum" in ln]
    assert len(jax_sums) == 2 and jax_sums[0] == jax_sums[1]

    got = {"plain": [], "k1": []}

    def spy(name, fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            got[name].append(out)
            return out
        return wrapped

    monkeypatch.setattr(ranking, "tiled_rank_counts_bidir",
                        spy("plain", ranking.tiled_rank_counts_bidir))
    monkeypatch.setattr(transe_rank, "transe_tiled_rank_counts_bidir",
                        spy("k1", transe_rank.transe_tiled_rank_counts_bidir))
    res = rank_bench.main(flags + ["--cpu"])
    assert res["k1_checksum"] == jax_sums[1] == jax_sums[0]
    assert res["mismatches"] == 0 and res["beyond_rounding_band"] == 0
    # the plain stream: a warm-up and a timed call, then the band's two
    # passes with the pivots moved; K1: a warm-up and a timed call
    assert len(got["plain"]) == 4 and len(got["k1"]) == 2
    k1, plain = got["k1"][-1], got["plain"][1]
    assert set(k1) == set(jt.out) == set(jt.ref)
    for k in jt.ref:
        np.testing.assert_array_equal(k1[k].numpy(), np.asarray(jt.out[k]),
                                      err_msg=k)
        diff = np.abs(plain[k].numpy().astype(np.int64)
                      - np.asarray(jt.ref[k]).astype(np.int64))
        assert diff.max() <= 1, k
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "N=20,000 Np=65,536 B=8 d=128 F=64"
    assert "speedup" in lines[3] and "rounding band" in lines[4]
    assert json.loads(lines[5]) == res


# -- serving_bench ------------------------------------------------------------

SERVE_FLAGS = ["--cpu", "--n", "5000", "--batches", "1", "8", "--reps", "2"]


def test_serving_bench_keys_and_top10_match_the_jax_tool(monkeypatch, capsys):
    jt = _jax_tool("serving_bench", monkeypatch)
    monkeypatch.setattr(sys, "argv", ["serving_bench.py", *SERVE_FLAGS])
    jt.main()
    want = _json_lines(capsys.readouterr().out)

    jcfg = j_blp.ModelConfig(model="blp", rel_model="transe", loss_fn="margin",
                             dim=128, num_relations=64,
                             encoder=j_bert.BertConfig.tiny())
    jparams = j_blp.init_params(jax.random.key(0), jcfg)
    params = blp.params_from_jax(jax.tree.map(np.asarray, jparams))
    rows = serving_bench.main(SERVE_FLAGS, params=params)
    assert [set(r) for r in rows] == [set(w) for w in want]
    assert [r["batch"] for r in rows] == [1, 8]
    assert all(r["p50"] > 0 and r["p95"] >= r["p50"] for r in rows)

    args = serving_bench.parse_args(SERVE_FLAGS)
    srv = serving_bench.make_server(args, params, "cpu")
    jsrv = JLinkPredictor(params=jparams, cfg=jcfg, tile=args.tile)
    table, queries = serving_bench.draw_inputs(args.n, args.d, args.batches)
    srv.set_candidates(table, np.arange(args.n))
    jsrv.set_candidates(table, np.arange(args.n))
    for b, emb, rels in queries:
        scores, ids = srv.predict_tails(head_emb=emb, rels=rels, k=10)
        j_scores, j_ids = jsrv.predict_tails(head_emb=emb, rels=rels, k=10)
        assert ids.shape == (b, 10)
        np.testing.assert_array_equal(ids, np.asarray(j_ids))
        np.testing.assert_allclose(scores, np.asarray(j_scores), rtol=1e-5,
                                   atol=1e-5)


# -- measure_reference_baseline ---------------------------------------------

TINY_REF = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=64,
                max_position_embeddings=64)


def test_reference_bert_loads_hf_state_dict_and_matches_it(monkeypatch):
    monkeypatch.setenv("USE_TF", "0")
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = transformers.BertModel(transformers.BertConfig(
        **TINY_REF, attn_implementation="eager")).eval()
    ours = measure_reference_baseline.ReferenceBert(
        measure_reference_baseline.ReferenceBertConfig(**TINY_REF)).eval()
    ours.load_state_dict(hf.state_dict(), strict=True)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(1, 128, (4, 16)))
    mask = torch.ones(4, 16)
    mask[1, 10:] = 0
    mask[3, 5:] = 0
    with torch.no_grad():
        want = hf(ids, attention_mask=mask)
        hidden, pooled = ours(ids, attention_mask=mask)
    np.testing.assert_allclose(hidden.numpy(), want.last_hidden_state.numpy(),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(pooled.numpy(), want.pooler_output.numpy(),
                               rtol=0, atol=1e-5)


def test_reference_baseline_writes_the_jax_tools_keys(tmp_path):
    out = str(tmp_path / "baseline.json")
    res = measure_reference_baseline.main(
        ["--cpu", "--out", out],
        config=measure_reference_baseline.ReferenceBertConfig(**TINY_REF),
        steps=1, warmup=1)
    # the keys tools/measure_reference_baseline.py writes
    assert set(res) == {"metric", "value", "unit", "hardware", "config",
                        "sec_per_step"}
    assert json.load(open(out)) == res
    assert res["metric"] == "train_triples_per_sec" and res["value"] > 0
    assert res["hardware"].startswith("cpu ")
    assert res["config"]["batch"] == 16 and res["config"]["num_negatives"] == 16
    assert bench.report(16, [0.5], w5m=False, baseline=out)["vs_baseline"] == \
        round(32 / res["value"], 2)


# -- bench --------------------------------------------------------------------

def test_bench_points_are_the_jax_benchs():
    # bench.py: (B, L, K), (steps, warmup, windows), remat, dropout_bits,
    # fast_train, and make_optimizer(2e-5, 10_000).
    assert bench.FLAGSHIP == dict(shape=(128, 32, 64), timing=(20, 6, 3),
                                  encoder=dict(remat=False, dropout_bits=32,
                                               fast_train=False))
    assert bench.W5M == dict(shape=(1024, 64, 64), timing=(10, 6, 3),
                             encoder=dict(remat=4, dropout_bits=8,
                                          fast_train=True))
    assert (bench.LR, bench.TOTAL_STEPS) == (2e-5, 10_000)
    for point in (bench.FLAGSHIP, bench.W5M):
        cfg = bench.model_config(point)
        assert (cfg.model, cfg.rel_model, cfg.loss_fn, cfg.dim,
                cfg.num_relations, cfg.sddmm_pallas) == (
            "blp", "transe", "margin", 128, 16, False)
        enc = cfg.encoder
        assert enc == bert.BertConfig(compute_dtype=torch.bfloat16,
                                      **point["encoder"])
        assert not enc.fused_attention


def test_bench_measures_a_tiny_step_and_reports_the_jax_keys(tmp_path):
    cfg = bench.model_config(bench.FLAGSHIP, bert.BertConfig.tiny())
    times = bench.measure(4, 8, 4, 2, 1, 1, cfg, "cpu")
    assert len(times) == 1 and times[0] > 0
    res = bench.report(4, times, w5m=False, baseline=str(tmp_path / "none.json"))
    assert set(res) == {"metric", "value", "unit", "vs_baseline"}
    assert res["metric"] == "train_triples_per_sec" and res["value"] > 0
    assert res["vs_baseline"] == 0.0
    base = tmp_path / "b.json"
    base.write_text(json.dumps({"value": 2.0}))
    assert bench.report(4, [0.5], w5m=False, baseline=str(base))["vs_baseline"] == 4.0
    w5m = bench.report(4, [0.5], w5m=True, baseline=str(base))
    assert w5m["metric"] == "train_triples_per_sec_w5m" and w5m["vs_baseline"] == 0.0


# -- family_bench -------------------------------------------------------------

TINY_FAMILIES = {"glove-bow": (8, 8, 16, 16, 50), "bert-bow": (8, 8, 24, 24, 60),
                 "glove-dkrl": (8, 8, 16, 16, 50), "bert-dkrl": (8, 8, 16, 24, 60),
                 "transductive": (8, 0, 16, 0, 0), "blp": (4, 8, 16, 0, 0),
                 "blp-w5m": (4, 8, 16, 0, 0)}


def test_family_table_is_the_jax_tools(monkeypatch):
    assert family_bench.FAMILIES == _jax_tool("family_bench", monkeypatch).FAMILIES
    assert list(TINY_FAMILIES) == list(family_bench.FAMILIES)


@pytest.mark.parametrize("model", list(TINY_FAMILIES))
def test_family_runs_a_tiny_window(model):
    row = family_bench.bench_family(model, reps=1, families=TINY_FAMILIES,
                                    encoder=bert.BertConfig.tiny(), device="cpu")
    assert set(row) == {"model", "batch", "num_negatives", "ms_per_step",
                        "triples_per_sec"}
    assert row["model"] == model and row["batch"] == TINY_FAMILIES[model][0]
    assert row["num_negatives"] == 64
    assert 0 < row["triples_per_sec"] < float("inf")


# -- eval_parallel.rank_counts and scaling_bench over 2 gloo ranks -----------

def _count_cases():
    rng = np.random.default_rng(3)
    n, d, b, tile = 3000, 32, 8, 512
    table = rng.standard_normal((3072, d)).astype(np.float32)
    true_pos = rng.integers(0, n, b).astype(np.int32)
    table[rng.integers(0, n, 6)] = table[true_pos[:6]]      # exact ties
    filt = rng.integers(0, n, (b, 6)).astype(np.int32)
    filt[:, 4:] = -1
    filt[0, 0] = true_pos[0]
    base = dict(table=table, true_pos=true_pos, filter_pos=filt, n=n, tile=tile,
                fixed=rng.standard_normal((b, d)).astype(np.float32),
                rel=rng.standard_normal((b, d)).astype(np.float32))
    return [dict(base, rel_model="transe", corrupt="head"),
            dict(base, rel_model="transe", corrupt="tail"),
            dict(base, rel_model="distmult", corrupt="head")]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    cases = _count_cases()
    ranks = workers.run_world(workers.sharded_counts_and_scaling, 2,
                              tmp_path_factory.mktemp("bench_world"), cases,
                              ["--cpu", "--batch", "32"], 8192)
    return cases, ranks


def _one_device_counts(case) -> dict:
    t = {k: torch.from_numpy(case[k]) for k in
         ("table", "fixed", "rel", "true_pos", "filter_pos")}
    if case["rel_model"] == "transe":
        c = transe_rank.transe_tiled_rank_counts(
            t["table"], t["fixed"], t["rel"], None, t["true_pos"],
            t["filter_pos"], case["n"], corrupt=case["corrupt"])
    else:
        ts = ranking.score_pairs(t["table"][t["true_pos"].long()], t["fixed"],
                                 t["rel"], rel_model=case["rel_model"],
                                 corrupt=case["corrupt"])[:, None]
        c = ranking.tiled_rank_counts(
            t["table"], t["fixed"], t["rel"], ts, t["true_pos"],
            t["filter_pos"], case["n"], rel_model=case["rel_model"],
            corrupt=case["corrupt"], tile=case["tile"])
    return {k: v.numpy() for k, v in c.items()}


def _jax_sharded_counts(case) -> dict:
    mesh = j_mesh.make_mesh(2, 1, devices=jax.devices()[:2])
    fn = j_eval_parallel.make_sharded_rank_counts(
        mesh, rel_model=case["rel_model"], corrupt=case["corrupt"],
        tile=case["tile"])
    table = jnp.asarray(case["table"])
    ts = j_ranking.score_pairs(table[case["true_pos"]], jnp.asarray(case["fixed"]),
                               jnp.asarray(case["rel"]), rel_model=case["rel_model"],
                               corrupt=case["corrupt"])[:, None]
    c = fn(j_eval_parallel.shard_entity_table(table, mesh),
           jnp.asarray(case["fixed"]), jnp.asarray(case["rel"]), ts,
           jnp.asarray(case["true_pos"]), jnp.asarray(case["filter_pos"]),
           jnp.asarray(case["n"], jnp.int32))
    return {k: np.asarray(v) for k, v in c.items()}


@pytest.mark.parametrize("i", range(3), ids=["transe-head", "transe-tail",
                                             "distmult-head"])
def test_sharded_rank_counts_equal_one_device_and_jax(world2, i):
    cases, ranks = world2
    case = cases[i]
    one = _one_device_counts(case)
    want_jax = _jax_sharded_counts(case)
    assert one["fgt"].sum() > 0 and (one["geq"] > one["gt"]).any()
    for r in ranks:
        got = r["counts"][i]
        assert set(got) == set(one) == set(want_jax)
        for k in one:
            np.testing.assert_array_equal(got[k], one[k], err_msg=k)
            assert np.abs(got[k].astype(np.int64) - want_jax[k]).max() <= 1, k


def test_scaling_bench_rows_have_the_jax_tools_keys(world2):
    _, ranks = world2
    rows = ranks[0]["rows"]
    assert ranks[1]["rows"] == []
    assert [(r["bench"], r["mesh"]) for r in rows] == [
        ("train", [1, 1]), ("train", [2, 1]),
        ("eval_rank", [1, 1]), ("eval_rank", [2, 1])]
    note = ("virtual mesh shares one host's FLOPs; validates "
            "semantics/overhead, not scaling")
    for r in rows:
        unit = "edges_per_sec" if r["bench"] == "train" else "cand_scores_per_sec"
        assert set(r) == {"bench", "mesh", unit, "virtual_mesh_overhead_vs_1dev",
                          "note"}
        assert r[unit] > 0 and r["note"] == note
    assert rows[0]["virtual_mesh_overhead_vs_1dev"] == 1.0


# -- no entry point runs on the CPU unless asked ------------------------------

@pytest.mark.parametrize("entry", ["bench", "rank_bench", "serving_bench",
                                   "measure_reference_baseline", "family_bench",
                                   "scaling_bench"])
def test_entry_points_default_to_cuda(entry, tmp_path):
    calls = {
        "bench": lambda: bench.main([]),
        "rank_bench": lambda: rank_bench.main([]),
        "serving_bench": lambda: serving_bench.main([]),
        "measure_reference_baseline": lambda: measure_reference_baseline.main(
            ["--out", str(tmp_path / "b.json")]),
        "family_bench": lambda: family_bench.main([]),
        "scaling_bench": lambda: scaling_bench.main([]),
    }
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
    assert not (tmp_path / "b.json").exists()
